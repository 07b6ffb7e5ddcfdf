"""The port's resilience layer (heat_tpu_torch.resilience), datasets and the
communication alias, held against heat_tpu: the same calls in both
packages, compared.

* fault plans: the same plan and seed fire at the same call indices, by
  index, by glob and by seeded probability, inline and from
  ``HEAT_TPU_FAULT_PLAN``;
* retry policies: the same attempts, the same recorded delays
  (``HEAT_TPU_RETRY_NO_SLEEP=1``: nothing sleeps), the same final
  exception class and the same ``retry_stats``/``fault_stats`` deltas;
* atomic writes: identical bytes and sidecars, a file of either package
  verified by the other, a torn file refused by both;
* ``guard_finite``/``all_finite`` on tensors, DNDarrays and containers;
* the consumers: ``ht.save``/``ht.load`` through an injected transient
  ``io.open``/``io.write`` fault, retried; the SpGEMM ring under an
  injected ``comm.collective`` fault, then retried; ``comm.init`` with no
  coordinator; ``datasets.path`` and ``communication``.

No gloo world: everything runs in this process."""

import os

import jax
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import heat_tpu as hj
import heat_tpu_torch as ht
from heat_tpu.resilience import atomic as r_atomic
from heat_tpu.resilience import faults as r_faults
from heat_tpu.resilience import retry as r_retry
from heat_tpu_torch.resilience import atomic as p_atomic
from heat_tpu_torch.resilience import faults as p_faults
from heat_tpu_torch.resilience import retry as p_retry

PACKAGES = [(ht, p_faults, p_retry, p_atomic), (hj, r_faults, r_retry, r_atomic)]


@pytest.fixture(autouse=True)
def _port_on_cpu(monkeypatch):
    ht.use_device("cpu")
    monkeypatch.setenv("HEAT_TPU_RETRY_NO_SLEEP", "1")


def _firing(faults, plan, seed, calls):
    """Evaluate ``calls`` (site names, in order) under ``plan``; the
    (call number, site, class name) of every raised fault, and the
    injector's hits and injected lists."""
    raised = []
    with faults.fault_plan(plan, seed=seed) as inj:
        for i, site in enumerate(calls):
            try:
                faults.inject(site, i=i)
            except Exception as e:  # the scripted fault is the outcome recorded
                raised.append((i, site, type(e).__name__, getattr(e, "index", None)))
    return raised, dict(inj.hits), {k: list(v) for k, v in inj.injected.items()}


PLANS = {
    "indices": ({"io.open": [0, 3], "comm.collective": [{"at": [1, 2], "kind": "permanent"}]}, 0),
    "glob": ({"io.*": [{"at": 2}], "comm.init": 1}, 0),
    "probability": ({"comm.*": [{"p": 0.3}], "io.write": [{"p": 0.5, "times": 2}]}, 7),
    "probability_other_seed": ({"comm.*": [{"p": 0.3}], "io.write": [{"p": 0.5, "times": 2}]}, 8),
}
CALLS = ["io.open", "io.write", "comm.collective", "comm.init"] * 6


@pytest.mark.parametrize("name", sorted(PLANS))
def test_fault_plans_fire_at_the_same_calls(name):
    plan, seed = PLANS[name]
    got, want = (_firing(f, plan, seed, CALLS) for _, f, _, _ in PACKAGES)
    assert got == want
    assert got[0], "the plan fired nowhere"


def test_fault_plan_from_the_environment(monkeypatch):
    monkeypatch.setenv("HEAT_TPU_FAULT_PLAN", '{"plan": {"io.open": [1], "comm.*": [{"p": 0.5}]}, "seed": 3}')
    runs = []
    for _, faults, _, _ in PACKAGES:
        monkeypatch.setattr(faults, "_ACTIVE", None)
        monkeypatch.setattr(faults, "_ENV_CHECKED", faults._ENV_CHECKED)  # put back after the test
        inj = faults.refresh_env_plan()
        raised = []
        for i, site in enumerate(CALLS):
            try:
                faults.inject(site)
            except Exception as e:  # the scripted fault is the outcome recorded
                raised.append((i, type(e).__name__))
        runs.append((raised, dict(inj.hits)))
        monkeypatch.setattr(faults, "_ACTIVE", None)
    assert runs[0] == runs[1] and runs[0][0]


def test_fault_rules_refuse_what_the_reference_refuses():
    for bad in ({"io.open": ["x"]}, {"io.open": [{"kind": "boom", "at": 0}]}, {"io.open": [{"kind": "transient"}]},
                {"io.open": [{"p": 2.0}]}):
        kinds = []
        for _, faults, _, _ in PACKAGES:
            with pytest.raises(Exception) as e:
                faults.fault_plan(bad)
            kinds.append(type(e.value).__name__)
        assert kinds[0] == kinds[1], bad
    assert p_faults.KNOWN_SITES == r_faults.KNOWN_SITES


def _script(outcomes):
    """A callable that raises (or returns) the scripted outcomes in turn."""
    it = iter(outcomes)

    def fn():
        o = next(it)
        if isinstance(o, BaseException):
            raise o
        return o

    return fn


def _errors(pkg):
    e = pkg.resilience
    return {"os": OSError("flaky"), "timeout": TimeoutError("slow"), "perm": e.PermanentFault("no"),
            "crc": e.ChecksumError("f", 1, 2), "value": ValueError("bad"), "transient": e.TransientFault("t")}


SCRIPTS = {
    "recovers": ["os", "timeout", 42],
    "gives_up": ["os", "os", "os", "os", "os"],
    "permanent": ["os", "perm"],
    "checksum": ["crc"],
    "not_retryable": ["transient", "value"],
}


@pytest.mark.parametrize("policy", ["custom", "io", "init"])
@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_retry_policies_make_the_same_attempts(policy, script, monkeypatch):
    monkeypatch.setenv("HEAT_TPU_IO_RETRY_ATTEMPTS", "4")
    monkeypatch.setenv("HEAT_TPU_IO_RETRY_BASE_DELAY", "0.01")
    runs = []
    for pkg, _, retry, _ in PACKAGES:
        if policy == "custom":
            pol = retry.RetryPolicy(max_attempts=4, base_delay=0.1, max_delay=0.25, backoff=3.0)
        else:
            pol = retry.default_io_policy() if policy == "io" else retry.default_init_policy()
        errs = _errors(pkg)
        outcomes = [errs[o] if isinstance(o, str) else o for o in SCRIPTS[script]]
        before = retry.retry_stats()
        try:
            out = pol.call(_script(outcomes))
        except Exception as e:  # the final refusal is the outcome compared
            out = type(e).__name__
        after = retry.retry_stats()
        runs.append((out, list(pol.last_delays), pol.schedule(), {k: after[k] - before[k] for k in after},
                     pol.no_sleep))
    assert runs[0] == runs[1]
    assert runs[0][4] is True  # HEAT_TPU_RETRY_NO_SLEEP=1: the delays are recorded, not slept


def test_retry_wrap_and_timeout():
    calls = []
    pol = p_retry.RetryPolicy(max_attempts=3, attempt_timeout=0.05, no_sleep=True)

    @pol.wrap
    def slow():
        calls.append(1)
        if len(calls) < 3:
            import time

            time.sleep(0.3)
        return "done"

    assert slow() == "done" and len(calls) == 3 and slow.retry_policy is pol
    assert issubclass(p_retry.RetryTimeout, ht.resilience.TransientFault)
    with pytest.raises(ValueError):
        p_retry.RetryPolicy(max_attempts=0)


def test_atomic_writes_are_the_references(tmp_path):
    payload = np.arange(1000, dtype=np.float32).tobytes()
    for (_, _, _, atomic), name in zip(PACKAGES, ("port.bin", "ref.bin")):
        with atomic.atomic_write(str(tmp_path / name)) as tmp:
            with open(tmp, "wb") as f:
                f.write(payload)
    port, ref = tmp_path / "port.bin", tmp_path / "ref.bin"
    assert port.read_bytes() == ref.read_bytes() == payload
    assert (tmp_path / "port.bin.crc32").read_text() == (tmp_path / "ref.bin.crc32").read_text()
    assert sorted(os.listdir(tmp_path)) == ["port.bin", "port.bin.crc32", "ref.bin", "ref.bin.crc32"]
    # each package verifies the other's file
    assert p_atomic.verify_checksum(str(ref)) is True and r_atomic.verify_checksum(str(port)) is True
    assert p_atomic.crc32_file(str(port)) == r_atomic.crc32_file(str(port))
    # a torn file fails in both, with each package's own ChecksumError
    with open(port, "r+b") as f:
        f.seek(17)
        f.write(b"\x00\x01")
    for pkg, _, _, atomic in PACKAGES:
        with pytest.raises(pkg.resilience.ChecksumError):
            atomic.verify_checksum(str(port))
    assert ht.core.io.ChecksumError is ht.resilience.ChecksumError
    assert ht.core.io.crc32_file is p_atomic.crc32_file


def test_a_failed_atomic_write_leaves_nothing(tmp_path):
    dest = tmp_path / "x.bin"
    for faults, atomic in ((p_faults, p_atomic), (r_faults, r_atomic)):
        with faults.fault_plan({"io.write": [0]}):
            with pytest.raises(OSError):
                with atomic.atomic_write(str(dest)) as tmp:
                    with open(tmp, "wb") as f:
                        f.write(b"abc")
        assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("split", [None, 0])
def test_guard_finite(split):
    x = np.random.default_rng(0).standard_normal((7, 3)).astype(np.float32)
    bad = x.copy()
    bad[5, 1] = np.nan
    for pkg in (ht, hj):
        g = pkg.resilience
        ok = pkg.array(x, split=split)
        assert g.guard_finite(ok) is ok and g.all_finite({"a": [ok, pkg.array(np.arange(3))]})
        with pytest.raises(g.DivergenceError) as e:
            g.guard_finite({"c": pkg.array(bad, split=split)}, what="centers", iteration=4, last_good=ok,
                           last_good_iteration=3)
        assert e.value.iteration == 4 and e.value.last_good is ok and e.value.last_good_iteration == 3
        assert "iteration 4" in str(e.value) and "last finite iterate was iteration 3" in str(e.value)
        assert not g.all_finite([np.array([1.0, np.inf])])
    t = torch.tensor([1.0, float("nan")])
    assert not ht.resilience.all_finite(t) and ht.resilience.all_finite(t[:1])
    assert ht.resilience.all_finite(torch.tensor([1, 2]))


def test_the_exports_are_the_references():
    assert set(ht.resilience.__all__) == set(hj.resilience.__all__) | {"read_checksum"}
    for name in ("TransientFault", "PermanentFault", "ChecksumError", "DivergenceError", "RetryTimeout"):
        p, r = getattr(ht.resilience, name), getattr(hj.resilience, name)
        assert [c.__name__ for c in p.__mro__] == [c.__name__ for c in r.__mro__], name


# ----------------------------------------------------------------------
# the consumers
# ----------------------------------------------------------------------
@pytest.mark.parametrize("site", ["io.open", "io.write"])
def test_save_and_load_retry_a_transient_fault(site, tmp_path):
    x = np.random.default_rng(1).standard_normal((9, 4)).astype(np.float32)
    runs = []
    for (pkg, faults, retry, _), name in zip(PACKAGES, ("port.npy", "ref.npy")):
        path = str(tmp_path / name)
        before = retry.retry_stats()
        with faults.fault_plan({site: [0]}) as inj:
            pkg.save(pkg.array(x, split=0), path)
            back = pkg.load(path, split=0)
        after = retry.retry_stats()
        np.testing.assert_array_equal(back.numpy(), x)
        runs.append((dict(inj.injected), {k: after[k] - before[k] for k in after}))
    assert runs[0] == runs[1]
    assert runs[0][0] == {site: [(0, "transient")]} and runs[0][1]["retries"] == 1
    assert (tmp_path / "port.npy").read_bytes() == (tmp_path / "ref.npy").read_bytes()


def test_load_gives_up_after_the_policys_attempts(tmp_path, monkeypatch):
    monkeypatch.setenv("HEAT_TPU_IO_RETRY_ATTEMPTS", "2")
    path = str(tmp_path / "a.npy")
    ht.save(ht.array(np.arange(5.0)), path)
    outcomes = []
    for pkg, faults, _, _ in PACKAGES:
        with faults.fault_plan({"io.open": [0, 1]}):
            with pytest.raises(pkg.resilience.TransientFault) as e:
                pkg.load(path)
        outcomes.append((e.value.site, e.value.index))
    assert outcomes[0] == outcomes[1] == ("io.open", 1)


@pytest.fixture
def ring_route(monkeypatch):
    """Both packages take the SpGEMM ring (never the dense route), the
    reference on one device."""
    monkeypatch.setenv("HEAT_TPU_SPGEMM_DENSE_DENSITY", "1.0")
    saved = hj.get_comm()
    hj.use_comm(hj.Communication(jax.devices()[:1]))
    try:
        yield
    finally:
        hj.use_comm(saved)


def test_spgemm_ring_fails_cleanly_and_retries(ring_route):
    rng = np.random.default_rng(4)
    a = sp.random(31, 19, density=0.2, random_state=rng, format="csr", dtype=np.float32)
    b = sp.random(19, 26, density=0.25, random_state=rng, format="csr", dtype=np.float32)
    for pkg, faults, retry, _ in PACKAGES:
        pa, pb = pkg.sparse.sparse_csr_matrix(a, split=0), pkg.sparse.sparse_csr_matrix(b, split=0)
        clean = pa @ pb
        with faults.fault_plan({"comm.collective": [{"p": 1.0, "times": 1}]}) as inj:
            with pytest.raises(pkg.resilience.TransientFault):
                pa @ pb
        assert [k for _, k in inj.injected["comm.collective"]] == ["transient"]
        with faults.fault_plan({"comm.collective": [{"p": 1.0, "times": 1}]}):
            again = retry.RetryPolicy(no_sleep=True).call(lambda: pa @ pb)
        for g, w in ((again.indptr, clean.indptr), (again.indices, clean.indices), (again.data, clean.data)):
            assert np.asarray(g.numpy() if hasattr(g, "numpy") else g).tobytes() == \
                np.asarray(w.numpy() if hasattr(w, "numpy") else w).tobytes()
    with p_faults.fault_plan({"comm.collective": [0]}) as inj:
        with pytest.raises(ht.resilience.TransientFault):
            ht.sparse.sparse_csr_matrix(a, split=0) @ ht.sparse.sparse_csr_matrix(b, split=0)
    assert inj.hits == {"comm.collective": 1}  # the ring's first step, before its re-sync


def test_comm_init_without_a_coordinator_is_a_no_op(monkeypatch):
    for var in ("MASTER_ADDR", "WORLD_SIZE", "RANK", "SLURM_STEP_NUM_TASKS"):
        monkeypatch.delenv(var, raising=False)
    epochs = []
    for pkg in (ht, hj):
        e0 = pkg.parallel.comm_epoch()
        pkg.parallel.init()
        assert pkg.parallel.is_initialized()
        epochs.append(pkg.parallel.comm_epoch() - e0)
    assert epochs == [0, 0]
    assert ht.get_comm().size == 1 and not torch.distributed.is_initialized()
    e0 = ht.parallel.comm_epoch()
    ht.parallel.finalize()  # the reference's finalize drops its caches: held by its own code, not run here
    assert not ht.parallel.is_initialized() and ht.parallel.comm_epoch() == e0 + 1
    assert ht.get_comm() is ht.WORLD
    ht.parallel.init()
    assert ht.parallel.is_initialized() and ht.parallel.comm_epoch() == e0 + 1


@pytest.mark.parametrize("env,missing", [
    ({"WORLD_SIZE": "2", "RANK": "0"}, "MASTER_ADDR"),
    ({"MASTER_ADDR": "localhost", "RANK": "1"}, "WORLD_SIZE"),
    ({"SLURM_STEP_NUM_TASKS": "4"}, "MASTER_ADDR, WORLD_SIZE, RANK"),
])
def test_comm_init_refuses_a_cluster_named_in_part(monkeypatch, env, missing):
    """A launcher's environment that names a cluster only in part raises,
    naming what is missing, and joins nothing (never a world of one)."""
    for var in ("MASTER_ADDR", "WORLD_SIZE", "RANK", "SLURM_STEP_NUM_TASKS"):
        monkeypatch.delenv(var, raising=False)
    for var, value in env.items():
        monkeypatch.setenv(var, value)
    with pytest.raises(RuntimeError, match=missing):
        ht.parallel.init()
    assert not torch.distributed.is_initialized()


def test_comm_init_runs_its_fault_site_under_the_init_policy(monkeypatch, tmp_path):
    """A detected cluster that cannot be joined fails loudly after the
    policy's attempts; each attempt passes the ``comm.init`` site."""
    monkeypatch.setenv("HEAT_TPU_INIT_RETRY_ATTEMPTS", "3")
    with p_faults.fault_plan({"comm.init": [{"p": 1.0}]}) as inj:
        with pytest.raises(ht.resilience.TransientFault):
            ht.parallel.init(f"file://{tmp_path}/rendezvous", num_processes=2, process_id=0, backend="gloo")
    assert inj.hits == {"comm.init": 3} and not torch.distributed.is_initialized()


def test_datasets_and_the_communication_alias():
    assert ht.communication is ht.parallel and hj.communication is hj.parallel
    for name in ("iris.csv", "iris.h5", "diabetes.h5"):
        p, r = ht.datasets.path(name), hj.datasets.path(name)
        assert p != r and open(p, "rb").read() == open(r, "rb").read()
    got = ht.load_csv(ht.datasets.path("iris.csv"), sep=";", split=0)
    want = hj.load_csv(hj.datasets.path("iris.csv"), sep=";", split=0)
    assert got.shape == want.shape == (150, 4) and got.split == want.split
    np.testing.assert_array_equal(got.numpy(), np.asarray(want.numpy()))
    for pkg in (ht, hj):
        with pytest.raises(FileNotFoundError, match="available"):
            pkg.datasets.path("nope.csv")
