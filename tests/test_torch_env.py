"""heat_tpu_torch/core/_env.py, the knob registry, against the JAX package's
heat_tpu/core/_env.py: every knob the port registers has the reference's
type and default (the port's own knobs listed below), the accessors parse
as the reference's do and refuse unregistered names with its exception
type, the readers that moved onto them answer as the reference's readers,
and no direct ``os.environ`` read of a ``HEAT_TPU_*`` literal is left in
the port."""

import ast
import builtins
import symtable
from pathlib import Path

import pytest

from heat_tpu.core import _env as ref_env
from heat_tpu.core import io as ref_io
from heat_tpu.nn import data_parallel as ref_dp
from heat_tpu.resilience import retry as ref_retry
from heat_tpu.telemetry import spans as ref_spans
from heat_tpu.utils import overlap as ref_overlap
from heat_tpu_torch.core import _env
from heat_tpu_torch.core import io as port_io
from heat_tpu_torch.nn import data_parallel as port_dp
from heat_tpu_torch.resilience import retry as port_retry
from heat_tpu_torch.telemetry import spans as port_spans
from heat_tpu_torch.utils import overlap as port_overlap

#: the port's own knobs: no entry in the reference's table
PORT_OWN = ("HEAT_TPU_TORCH_BUILD_DIR",)

PACKAGE = Path(__file__).resolve().parents[1] / "heat_tpu_torch"


@pytest.mark.parametrize("name", sorted(_env.KNOBS))
def test_registered_knob_matches_the_reference(name):
    kind, default, doc = _env.KNOBS[name]
    assert doc
    if name in PORT_OWN:
        assert name not in ref_env.KNOBS and "the port's own knob" in doc
        return
    assert (kind, default) == ref_env.KNOBS[name][:2]
    assert _env.knob_default(name) == ref_env.knob_default(name)


def test_the_table_is_a_pure_literal():
    tree = ast.parse((PACKAGE / "core" / "_env.py").read_text())
    tables = {t.id: node.value for node in tree.body if isinstance(node, ast.Assign)
              for t in node.targets if isinstance(t, ast.Name)}
    assert ast.literal_eval(tables["KNOBS"]) == _env.registered_knobs()


SPELLINGS = ["0", "1", "false", "FALSE", "no", "off", "Off ", " on", "yes", "true", "2", "", "raise"]


@pytest.mark.parametrize("value", SPELLINGS + [None])
@pytest.mark.parametrize("name", ["HEAT_TPU_TRACE", "HEAT_TPU_RETRY_NO_SLEEP", "HEAT_TPU_AOT_SAVE",
                                  "HEAT_TPU_COST_ANALYSIS"])
def test_env_flag_parses_as_the_reference(monkeypatch, name, value):
    if value is None:
        monkeypatch.delenv(name, raising=False)
    else:
        monkeypatch.setenv(name, value)
    assert _env.env_flag(name) == ref_env.env_flag(name)
    assert _env.env_flag(name, default=False) == ref_env.env_flag(name, default=False)
    assert _env.env_str(name) == ref_env.env_str(name)


@pytest.mark.parametrize("value", ["3", " 7 ", "-2", "0", "1024", "1.5", "x", "", None])
@pytest.mark.parametrize("name", ["HEAT_TPU_IO_RETRY_ATTEMPTS", "HEAT_TPU_TRACE_RING"])
def test_env_int_parses_as_the_reference(monkeypatch, name, value):
    if value is None:
        monkeypatch.delenv(name, raising=False)
    else:
        monkeypatch.setenv(name, value)
    outcomes = []
    for fn in (_env.env_int, ref_env.env_int):
        try:
            outcomes.append(("value", fn(name), fn(name, default=11)))
        except ValueError:
            outcomes.append(("ValueError",))
    assert outcomes[0] == outcomes[1]


@pytest.mark.parametrize("value", ["0.25", "1", "1e-3", " 2.5", "inf", "nan", "x", "", None])
@pytest.mark.parametrize("name", ["HEAT_TPU_SPGEMM_DENSE_DENSITY", "HEAT_TPU_ELASTIC_POLL_S"])
def test_env_float_parses_as_the_reference(monkeypatch, name, value):
    if value is None:
        monkeypatch.delenv(name, raising=False)
    else:
        monkeypatch.setenv(name, value)
    outcomes = []
    for fn in (_env.env_float, ref_env.env_float):
        try:
            outcomes.append(("value", repr(fn(name)), repr(fn(name, default=0.75))))
        except ValueError:
            outcomes.append(("ValueError",))
    assert outcomes[0] == outcomes[1]


@pytest.mark.parametrize("accessor", ["env_flag", "env_int", "env_float", "env_str", "knob_default"])
def test_unregistered_names_are_refused_with_the_reference_type(monkeypatch, accessor):
    name = "HEAT_TPU_NO_SUCH_KNOB"
    monkeypatch.delenv(name, raising=False)
    with pytest.raises(KeyError) as ref_err:
        getattr(ref_env, accessor)(name)
    with pytest.raises(type(ref_err.value)) as err:
        getattr(_env, accessor)(name)
    assert name in str(err.value)
    # the port refuses a typo'd knob even where the variable is set
    if accessor != "knob_default":
        monkeypatch.setenv(name, "1")
        with pytest.raises(KeyError):
            getattr(_env, accessor)(name)


@pytest.mark.parametrize("value", ["0.5", "4", "1e-4", None])
def test_grad_bucket_reader_matches_the_reference(monkeypatch, value):
    if value is None:
        monkeypatch.delenv("HEAT_TPU_GRAD_BUCKET_MB", raising=False)
    else:
        monkeypatch.setenv("HEAT_TPU_GRAD_BUCKET_MB", value)
    assert port_dp._grad_bucket_bytes() == ref_dp._grad_bucket_bytes()


@pytest.mark.parametrize("value", ["0", "1", "false", "off", " 0", None])
def test_io_checksum_and_async_checkpoint_readers_match_the_reference(monkeypatch, value):
    for name in ("HEAT_TPU_IO_CHECKSUM", "HEAT_TPU_ASYNC_CKPT"):
        if value is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, value)
    assert port_io._checksums_enabled() == ref_io._checksums_enabled()
    assert port_overlap.async_checkpoint_enabled() == ref_overlap.async_checkpoint_enabled()


@pytest.mark.parametrize("values", [{}, {"ATTEMPTS": "5", "BASE_DELAY": "0.01", "MAX_DELAY": "0.5"},
                                    {"ATTEMPTS": "1"}])
@pytest.mark.parametrize("no_sleep", ["1", "true", "0", None])
def test_retry_policies_match_the_reference(monkeypatch, values, no_sleep):
    for prefix in ("HEAT_TPU_IO_RETRY", "HEAT_TPU_INIT_RETRY"):
        for field in ("ATTEMPTS", "BASE_DELAY", "MAX_DELAY"):
            monkeypatch.delenv(f"{prefix}_{field}", raising=False)
        for field, v in values.items():
            monkeypatch.setenv(f"{prefix}_{field}", v)
    if no_sleep is None:
        monkeypatch.delenv("HEAT_TPU_RETRY_NO_SLEEP", raising=False)
    else:
        monkeypatch.setenv("HEAT_TPU_RETRY_NO_SLEEP", no_sleep)
    for policy in ("default_io_policy", "default_init_policy"):
        got, want = getattr(port_retry, policy)(), getattr(ref_retry, policy)()
        fields = ("max_attempts", "base_delay", "max_delay", "no_sleep")
        assert [getattr(got, f) for f in fields] == [getattr(want, f) for f in fields]


def _direct_knob_reads(path: Path):
    """``os.environ.get("HEAT_TPU_...")``, ``os.environ["HEAT_TPU_..."]``,
    ``"HEAT_TPU_..." in os.environ`` and ``os.getenv("HEAT_TPU_...")`` in
    one source file: (line, name) pairs."""

    def is_environ(node):
        return isinstance(node, ast.Attribute) and node.attr == "environ" and \
            isinstance(node.value, ast.Name) and node.value.id == "os"

    def knob(node):
        return isinstance(node, ast.Constant) and isinstance(node.value, str) and node.value.startswith("HEAT_TPU")

    found = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Call) and node.args and knob(node.args[0]):
            f = node.func
            if isinstance(f, ast.Attribute) and ((f.attr in ("get", "pop", "setdefault") and is_environ(f.value))
                                                 or (f.attr == "getenv" and isinstance(f.value, ast.Name)
                                                     and f.value.id == "os")):
                found.append((node.lineno, node.args[0].value))
        elif isinstance(node, ast.Subscript) and is_environ(node.value) and knob(node.slice):
            found.append((node.lineno, node.slice.value))
        elif isinstance(node, ast.Compare) and knob(node.left) and any(is_environ(c) for c in node.comparators):
            found.append((node.lineno, node.left.value))
    return found


def test_the_scan_finds_a_direct_read(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text('import os\na = os.environ.get("HEAT_TPU_X")\nb = os.environ["HEAT_TPU_Y"]\n'
                     'c = "HEAT_TPU_Z" in os.environ\nd = os.getenv("HEAT_TPU_W")\ne = os.environ.get("HOME")\n')
    assert [n for _, n in _direct_knob_reads(probe)] == ["HEAT_TPU_X", "HEAT_TPU_Y", "HEAT_TPU_Z", "HEAT_TPU_W"]


def test_no_direct_knob_read_is_left_in_the_port():
    left = {str(p.relative_to(PACKAGE)): reads for p in sorted(PACKAGE.rglob("*.py"))
            if p.name != "_env.py" and (reads := _direct_knob_reads(p))}
    assert left == {}


@pytest.mark.parametrize("value", ["0", "1", "off", "true", None])
def test_spans_refresh_env_rereads_the_trace_knob_as_the_reference(monkeypatch, value):
    states = (port_spans.set_tracing(True), ref_spans.set_tracing(True))
    try:
        if value is None:
            monkeypatch.delenv("HEAT_TPU_TRACE", raising=False)
        else:
            monkeypatch.setenv("HEAT_TPU_TRACE", value)
        got, want = port_spans.refresh_env(), ref_spans.refresh_env()
        assert got == want == port_spans.tracing_enabled()
    finally:
        port_spans.set_tracing(states[0])
        ref_spans.set_tracing(states[1])


def _undefined_globals(source: str, filename: str = "<probe>"):
    """Names a module reads as globals that it never binds at module
    level and that are not builtins: (scope, name) pairs (the class of
    fault a helper removed while a caller still names it leaves)."""
    top = symtable.symtable(source, filename, "exec")
    bound = {s.get_name() for s in top.get_symbols() if s.is_assigned() or s.is_imported() or s.is_namespace()}
    bound |= set(dir(builtins)) | {"__file__", "__name__", "__doc__", "__spec__", "__path__", "__package__"}
    found = []

    def walk(table):
        for sym in table.get_symbols():
            name = sym.get_name()
            if name in bound or not sym.is_referenced():
                continue
            if table is top or sym.is_global():
                found.append((table.get_name(), name))
        for child in table.get_children():
            walk(child)

    walk(top)
    return found


def test_the_undefined_global_scan_finds_a_dangling_helper():
    probe = "import os\n\ndef helper():\n    return os.sep\n\ndef caller():\n    return _gone('X') + helper()\n"
    assert _undefined_globals(probe) == [("caller", "_gone")]


def test_no_module_of_the_port_reads_an_undefined_global():
    left = {str(p.relative_to(PACKAGE)): names for p in sorted(PACKAGE.rglob("*.py"))
            if (names := _undefined_globals(p.read_text(), str(p)))}
    assert left == {}


ELASTIC_KNOBS = ["HEAT_TPU_ELASTIC_MIN_WORLD", "HEAT_TPU_ELASTIC_MAX_RECOVERIES",
                 "HEAT_TPU_ELASTIC_HEARTBEAT_TIMEOUT_S", "HEAT_TPU_ELASTIC_POLL_S"]


def _elastic_reads(pkg, tmp_path):
    """Construct the objects that read the elastic knobs: (min_world,
    max_recoveries, heartbeat timeout, poll) of a ProcessSupervisor, plus
    an ElasticSupervisor's and a HeartbeatMonitor's."""
    sup = pkg.elastic.ProcessSupervisor(lambda rank, world: "", str(tmp_path), 2)
    es = pkg.elastic.ElasticSupervisor(lambda comm, resume: None, str(tmp_path))
    hb = pkg.elastic.HeartbeatMonitor()
    return (sup.min_world, sup.max_recoveries, sup.heartbeat_timeout_s, sup.poll_s,
            es.min_world, es.max_recoveries, hb.timeout_s)


@pytest.mark.parametrize("value", ["", "  ", "3", " 2 ", None])
@pytest.mark.parametrize("name", ELASTIC_KNOBS)
def test_f27_elastic_knob_values_read_as_the_reference(monkeypatch, tmp_path, name, value):
    # F27: the port took an empty HEAT_TPU_ELASTIC_* value for its default;
    # the reference's env_int/env_float raise ValueError on it
    import heat_tpu as hj
    import heat_tpu_torch as ht

    for knob in ELASTIC_KNOBS:
        monkeypatch.delenv(knob, raising=False)
    if value is not None:
        monkeypatch.setenv(name, value)
    outcomes = []
    for pkg in (hj, ht):
        try:
            outcomes.append(("value", _elastic_reads(pkg, tmp_path)))
        except ValueError:
            outcomes.append(("ValueError",))
    assert outcomes[0] == outcomes[1]
