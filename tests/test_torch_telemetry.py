"""The port's telemetry (metrics, spans, tracing, journal) and analysis
(tsan, diagnostics, protocols, conformance) held against heat_tpu: the
same calls in both packages, compared.

* metrics: the same counter, gauge, histogram and info calls give equal
  ``snapshot()`` documents and equal ``expose()`` text (fresh
  registries, and the exemplar clock pinned in both);
* spans: the same nested spans give the same names, depths and attrs,
  a request trace the same tree, and every span is a
  ``torch.profiler.record_function`` in a ``torch.profiler`` trace;
* journal: a journal written by either package reads back, and
  verifies, in the other;
* protocols: ``PROTOCOLS`` and ``transition_index`` are equal, and
  conformance gives the same verdicts on the same event sequences;
* tsan: a seeded two-thread toy race gives the same findings.

No gloo world: everything runs in this process."""

import json
import threading
import warnings

import numpy as np
import pytest
import torch

import heat_tpu as hj
import heat_tpu_torch as ht
from heat_tpu.analysis import conformance as r_conf
from heat_tpu.analysis import protocols as r_proto
from heat_tpu.analysis import tsan as r_tsan
from heat_tpu.telemetry import journal as r_journal
from heat_tpu.telemetry import metrics as r_metrics
from heat_tpu.telemetry import spans as r_spans
from heat_tpu.telemetry import tracing as r_tracing
from heat_tpu_torch.analysis import conformance as p_conf
from heat_tpu_torch.analysis import protocols as p_proto
from heat_tpu_torch.analysis import tsan as p_tsan
from heat_tpu_torch.telemetry import journal as p_journal
from heat_tpu_torch.telemetry import metrics as p_metrics
from heat_tpu_torch.telemetry import spans as p_spans
from heat_tpu_torch.telemetry import tracing as p_tracing


@pytest.fixture(autouse=True)
def _port_on_cpu():
    ht.use_device("cpu")


def _drive(reg):
    """The same metric calls on a fresh registry."""
    c = reg.counter("fault.faults_injected", "faults")
    c.inc()
    c.inc(4)
    reg.counter("comm.bytes.psum").inc(1.5)
    reg.gauge("fit.iter_rate", "iterations per second").set(12.25)
    reg.gauge("live.size", fn=lambda: 7)
    h = reg.histogram("dispatch.compile_ms", "compile wall time")
    for v in (0.0, 0.3, 1.0, 2.5, 2.6, 40.0, 1e3, 7e5):
        h.observe(v)
    e = reg.histogram("serving.latency_ms")
    for i, v in enumerate((0.5, 3.0, 3.1, 90.0)):
        e.observe(v, exemplar=f"trace{i:02d}")
    reg.info("build_info", "identity", fn=lambda: {"version": "1", "backend": "cpu"})
    return reg


def test_metrics_expose_and_snapshot_are_the_references(monkeypatch):
    for m in (p_metrics, r_metrics):
        monkeypatch.setattr(m.time, "time", lambda: 1700000000.25)
    port, ref = _drive(p_metrics.MetricsRegistry()), _drive(r_metrics.MetricsRegistry())
    assert port.expose() == ref.expose()
    assert port.snapshot() == ref.snapshot() and port.snapshot(include_zero=False) == ref.snapshot(include_zero=False)
    h = port.histogram("dispatch.compile_ms")
    for q in (0.0, 0.1, 0.5, 0.9, 0.99, 1.0):
        assert h.quantile(q) == ref.histogram("dispatch.compile_ms").quantile(q)
    for reg in (port, ref):
        reg.reset("fault.")
    assert port.snapshot() == ref.snapshot()
    with pytest.raises(TypeError):
        port.gauge("fault.faults_injected")
    assert port.expose().endswith("# EOF\n")


def test_metrics_dump_json_is_checksummed(tmp_path):
    reg = _drive(p_metrics.MetricsRegistry())
    path = str(tmp_path / "m.json")
    reg.dump_json(path)
    assert hj.resilience.verify_checksum(path) is True
    assert json.load(open(path))["metrics"]["fault.faults_injected"] == 5


def _nested(spans, tracing):
    """The same nested spans and request trace; the ring's records and the
    trace's tree, without clocks and ids (the ring and the trace store
    emptied first: other tests of the process leave traces behind)."""
    spans.clear_spans()
    spans.clear_notes()
    tracing.reset_store()
    with spans.span("fit", step=1):
        with spans.span("fit.chunk", rows=10):
            with spans.span("kmeans.iter"):
                pass
        with spans.span("fit.chunk", rows=11):
            pass
    with tracing.request_span("/v1/predict/km", tenant="a") as req:
        with spans.span("dispatch"):
            with spans.span("execute", batch=4):
                pass
    recs = [(r.name, r.depth, dict(r.attrs), r.trace_id is not None) for r in spans.get_spans()]
    tree = tracing.get_trace(req.trace_id)
    names = sorted((s["name"], s["parent_id"] == 0) for s in tree["spans"])
    return recs, names, tree["route"], tree["status"], len(spans.chrome_trace_doc()["traceEvents"])


def test_spans_and_traces_are_the_references():
    prev = [p_spans.set_tracing(True), r_spans.set_tracing(True)]
    try:
        got, want = _nested(p_spans, p_tracing), _nested(r_spans, r_tracing)
    finally:
        p_spans.set_tracing(prev[0])
        r_spans.set_tracing(prev[1])
    assert got == want
    assert got[0][0] == ("kmeans.iter", 2, {}, False)


def test_disabled_spans_record_nothing():
    prev = p_spans.set_tracing(False)
    try:
        before = p_metrics.snapshot()["spans.recorded"]
        p_spans.clear_spans()
        with p_spans.span("off"):
            pass
        assert p_spans.get_spans() == [] and p_metrics.snapshot()["spans.recorded"] == before
    finally:
        p_spans.set_tracing(prev)


def test_spans_label_a_torch_profiler_trace():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with ht.telemetry.span("kmeans.fit"):
            with ht.telemetry.span("kmeans.step"):
                torch.ones(64).sum()
    names = {e.key for e in prof.key_averages()}
    assert {"kmeans.fit", "kmeans.step"} <= names


def _journal(journal, directory, actor_events):
    journal.reset_journal()
    journal.set_journal_dir(directory)
    try:
        root = journal.emit("alerts", "fire", model="km", evidence={"alert": "drift:km", "psi": 0.4})
        for actor, action in actor_events:
            journal.emit(actor, action, model="km", cause=root["event_id"], evidence={"rows": 3})
    finally:
        journal.set_journal_dir(None)


EVENTS = [("canary", "stage"), ("canary", "promoted"), ("preempt", "raise")]


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_a_journal_reads_back_in_the_other_package(writer, tmp_path):
    w, r = (p_journal, r_journal) if writer == "port" else (r_journal, p_journal)
    _journal(w, str(tmp_path), EVENTS)
    mine, theirs = w.read_journal(str(tmp_path)), r.read_journal(str(tmp_path))
    assert mine == theirs and len(theirs) == 4
    assert [(e["actor"], e["action"]) for e in theirs] == [("alerts", "fire")] + EVENTS
    files = sorted(p.name for p in tmp_path.iterdir())
    assert all(f.startswith("journal-") for f in files) and sum(f.endswith(".crc32") for f in files) == 4
    chain_w = w.causal_chain(theirs[0]["event_id"], events=theirs)
    chain_r = r.causal_chain(theirs[0]["event_id"], events=theirs)
    assert chain_w == chain_r
    # a torn segment is refused by both
    seg = sorted(p for p in tmp_path.iterdir() if p.suffix == ".jsonl")[0]
    seg.write_bytes(seg.read_bytes()[:-3] + b"xx\n")
    for pkg in (ht, hj):
        with pytest.raises(pkg.resilience.ChecksumError):
            (p_journal if pkg is ht else r_journal).read_journal(str(tmp_path))
    p_journal.reset_journal()
    r_journal.reset_journal()


def test_protocol_tables_are_the_references():
    assert p_proto.PROTOCOLS == r_proto.PROTOCOLS
    assert p_proto.ENVIRONMENT == r_proto.ENVIRONMENT and p_proto.PROPERTIES == r_proto.PROPERTIES
    assert p_proto.transition_index() == r_proto.transition_index()
    assert p_proto.declared_pairs() == r_proto.declared_pairs() and p_proto.registry_problems() == []
    assert p_proto.render_diagrams_markdown() == r_proto.render_diagrams_markdown()


SEQUENCES = {
    "legal": [("canary", "stage", "km"), ("canary", "promoted", "km"), ("preempt", "raise", None),
              ("preempt", "clear", None)],
    "illegal": [("canary", "promoted", "km"), ("preempt", "clear", None), ("preempt", "clear", None)],
    "undeclared": [("router", "reboot", None), ("someone", "else", None), ("canary", "stage", "a"),
                   ("canary", "stage", "b"), ("canary", "rolled_back", "a")],
    "epochs": [("preempt", "raise", None), ("preempt", "raise", None)],
}


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_conformance_gives_the_same_verdicts(name):
    events = []
    for i, (actor, action, model) in enumerate(SEQUENCES[name]):
        epoch = "p1-a" if name != "epochs" or i == 0 else "p2-b"
        events.append({"event_id": f"{epoch}-{i:06d}", "actor": actor, "action": action, "model": model,
                       "evidence": {}})
    got, want = p_conf.annotate(events), r_conf.annotate(events)
    assert got == want
    if name == "illegal":
        assert any(not a["ok"] for a in got.values())


def test_conformance_reports_a_live_violation_as_h805():
    prev = p_conf.set_protocol_mode("1")
    p_conf.reset_conformance()
    ht.analysis.diagnostics.clear_diagnostics()
    try:
        with pytest.warns(ht.analysis.AnalysisWarning, match="H805"):
            p_journal.emit("preempt", "clear")
        rep = p_conf.conformance_report()
        assert rep["violations"] == 1 and rep["recent"][0]["protocol"] == "preempt"
        assert [d.rule for d in ht.analysis.recent_diagnostics()] == ["H805"]
    finally:
        p_conf.set_protocol_mode(prev)
        p_conf.reset_conformance()
        p_journal.reset_journal()


def _toy_race(tsan):
    """Two threads take locks A and B in opposite orders (a potential
    deadlock), and a worker touches a guarded structure without its lock."""
    tsan.clear_findings()
    prev = tsan.arm("1")
    tsan.register_structure("test.toy", "test.toy_lock")
    a, b = tsan.register_lock("test.a"), tsan.register_lock("test.b")

    def ab():
        with a:
            with b:
                pass

    def ba():
        with b:
            with a:
                pass

    def touch():
        tsan.note_access("test.toy")

    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            for fn in (ab, ba, touch):
                t = threading.Thread(target=fn, name=f"toy-{fn.__name__}")
                t.start()
                t.join()
            tsan.note_access("test.toy")  # the main thread may touch it
        return [(f["rule"], f.get("cycle"), f.get("structure"), f.get("lock"), f.get("thread")
                 if f["rule"] == "tsan.unguarded_access" else None) for f in tsan.findings()]
    finally:
        if prev == "off":
            tsan.disarm()
        else:
            tsan.arm(prev)
        tsan.clear_findings()


def test_tsan_finds_the_same_toy_race():
    got, want = _toy_race(p_tsan), _toy_race(r_tsan)
    assert got == want
    assert [g[0] for g in got] == ["tsan.lock_cycle", "tsan.unguarded_access"]
    assert got[0][1] == ["test.b", "test.a", "test.b"]
    with pytest.raises(KeyError):
        p_tsan.register_lock("not.registered")


def test_telemetry_reset_all():
    ht.telemetry.counter("retry.retries").inc()
    with ht.telemetry.span("x"):
        pass
    ht.telemetry.reset_all("retry")
    assert ht.telemetry.snapshot()["retry.retries"] == 0 and ht.telemetry.get_spans()
    ht.telemetry.reset_all()
    assert ht.telemetry.get_spans() == [] and ht.telemetry.snapshot()["spans.recorded"] == 0
    with pytest.raises(ValueError):
        ht.telemetry.reset_all("nope")
    assert "build_info" in ht.telemetry.snapshot() and "heat_tpu_build_info{" in ht.telemetry.expose()
    assert set(ht.telemetry.__all__) <= set(hj.telemetry.__all__) | {"Info"}
    assert np.isfinite(ht.telemetry.snapshot()["process.start_ts"])
