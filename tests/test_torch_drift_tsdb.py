"""Drift sketches (heat_tpu_torch/telemetry/sketch.py), the embedded metric
history (telemetry/tsdb.py), cross-worker aggregation (telemetry/aggregate.py)
and tenant metering (telemetry/tenants.py) against heat_tpu's: the same
inputs through both packages, the documents compared exactly but for
wall-clock stamps and pids.

The contracts of the reference's ``tests/test_drift.py`` and
``tests/test_tsdb.py`` that need no serving layer (ROADMAP item 17b):
exact, batch-order-free moments; signed-zero-aware log buckets; PSI and KL
scores; the drift alert's fire and resolve; bounded rings, allowlisted
scrapes and windowed queries; ``merge_snapshots`` and the straggler score;
per-tenant accounts summing to the total.  The gloo world of 3 in
``tests/test_torch_gloo.py`` gathers real snapshots with
``all_gather_object``."""

import copy

import numpy as np
import pytest

import heat_tpu as hj  # noqa: F401
import heat_tpu_torch as ht
from heat_tpu.telemetry import aggregate as r_agg
from heat_tpu.telemetry import alerts as r_alerts
from heat_tpu.telemetry import metrics as r_metrics
from heat_tpu.telemetry import sketch as r_sketch
from heat_tpu.telemetry import tenants as r_tenants
from heat_tpu.telemetry import tsdb as r_tsdb
from heat_tpu_torch.telemetry import aggregate as p_agg
from heat_tpu_torch.telemetry import alerts as p_alerts
from heat_tpu_torch.telemetry import metrics as p_metrics
from heat_tpu_torch.telemetry import sketch as p_sketch
from heat_tpu_torch.telemetry import tenants as p_tenants
from heat_tpu_torch.telemetry import tsdb as p_tsdb

STAMPS = ("ts", "timestamp", "pid", "sampled_at", "active_s", "frozen_at", "uptime_s")


def _strip(doc):
    if isinstance(doc, dict):
        return {k: _strip(v) for k, v in doc.items() if k not in STAMPS and not k.endswith("_ts")}
    if isinstance(doc, (list, tuple)):
        return [_strip(v) for v in doc]
    return doc


@pytest.fixture(autouse=True)
def _clean():
    ht.use_device("cpu")
    for sk, al in ((p_sketch, p_alerts), (r_sketch, r_alerts)):
        sk.SKETCHES.clear()
        al.clear_alerts()
    yield
    for sk, al in ((p_sketch, p_alerts), (r_sketch, r_alerts)):
        sk.SKETCHES.clear()
        al.clear_alerts()


# ----------------------------------------------------------------------
# drift sketches
# ----------------------------------------------------------------------
def _rows(seed, n=600, shift=0.0):
    rng = np.random.default_rng(seed)
    x = rng.normal(loc=shift, size=(n, 3))
    x[:5, 0] = [0.0, -0.0, 1e-30, -1e30, 0.0]
    return x.astype(np.float32)


def test_feature_sketch_moments_buckets_and_docs_are_the_references():
    col = _rows(0)[:, 0].astype(np.float64)
    docs = []
    for sk in (p_sketch, r_sketch):
        a, b = sk.FeatureSketch(), sk.FeatureSketch()
        a.update_batch(col)
        for part in np.array_split(col[::-1], 7):
            b.update_batch(part)
        b.update_batch(np.zeros(0))
        docs.append((a.doc(), a.variance, sk.FeatureSketch.from_doc(a.doc()).doc(), b.doc()["count"]))
    assert docs[0] == docs[1]
    assert docs[0][3] == len(col)


def test_psi_and_kl_scores_are_the_references():
    rng = np.random.default_rng(1)
    buckets = [dict(zip(rng.integers(-40, 40, 12).tolist(), rng.integers(1, 50, 12).tolist())) for _ in range(4)]
    for p in buckets:
        for q in buckets + [{}]:
            assert p_sketch.psi(p, q) == r_sketch.psi(p, q)
            assert p_sketch.kl_divergence(p, q) == r_sketch.kl_divergence(p, q)
    assert p_sketch.psi(buckets[0], buckets[0]) == 0.0


def test_record_freeze_score_and_the_drift_alert_are_the_references():
    def run(sk, al):
        out = [sk.record_batch("km", _rows(2)), sk.SKETCHES.status("km")]
        out.append(sk.SKETCHES.freeze_baseline("km"))
        sk.SKETCHES.reset_live("km")
        sk.record_batch("km", _rows(3, n=300))
        out += [sk.check_drift(), al.active_alerts()]
        sk.record_batch("km", _rows(4, n=900, shift=3.0))
        out += [sk.check_drift(), al.active_alerts(), sk.drift_report(), sk.SKETCHES.digest()]
        sk.SKETCHES.reset_live("km")
        sk.record_batch("km", _rows(5, n=400))
        out += [sk.check_drift(), al.alert_events()]
        with pytest.raises(ValueError):
            sk.SKETCHES.freeze_baseline("never-seen")
        return _strip(out)

    got, want = run(p_sketch, p_alerts), run(r_sketch, r_alerts)
    assert got == want
    assert [e["event"] for e in got[-1]] == ["fired", "resolved"]


def test_the_divergence_of_model_sketches_is_the_references():
    docs = []
    for sk in (p_sketch, r_sketch):
        live, base = sk.ModelSketch("km", 3), sk.ModelSketch("km", 3)
        live.update(_rows(6).astype(np.float64))
        base.update(_rows(7, shift=0.5).astype(np.float64))
        docs.append(sk.divergence(live.doc(), base.doc()))
        with pytest.raises(ValueError):
            live.update(np.zeros((4, 2)))
    assert docs[0] == docs[1]


# ----------------------------------------------------------------------
# the metric history
# ----------------------------------------------------------------------
def test_tsdb_scrape_push_and_queries_are_the_references(monkeypatch):
    monkeypatch.setenv("HEAT_TPU_TSDB_SERIES", "tsdbtest.*, tsdbtest2.exact")
    monkeypatch.setenv("HEAT_TPU_TSDB_RETENTION", "5")
    docs = []
    for db, metrics in ((p_tsdb, p_metrics), (r_tsdb, r_metrics)):
        db.refresh_env()
        db.reset_tsdb()
        metrics.reset("tsdbtest")
        c, h = metrics.counter("tsdbtest.c"), metrics.histogram("tsdbtest.h")
        metrics.gauge("tsdbtest2.exact").set(4.5)
        metrics.gauge("tsdbtest2.other").set(1.0)
        out = [db.allowed_series()]
        for i in range(8):
            c.inc(i)
            h.observe(float(i + 1))
            out.append(db.sample_once(now=1000.0 + i))
        for i in range(3):
            db.record("ctl.burn", 0.5 * i, ts=1003.0 + i)
        out += [db.series_names(), db.query("tsdbtest.c"), db.query("tsdbtest.c", window_s=2.0),
                db.query("missing"), db.window_stats("tsdbtest.h.p50", 3.0), db.window_stats("missing"),
                _strip(db.queryz_report(["tsdbtest.c", "ctl.burn"], 1.5)), db.tsdb_snapshot(max_points=2)]
        docs.append(out)
        db.reset_tsdb()
        monkeypatch.delenv("HEAT_TPU_TSDB_SERIES")
        monkeypatch.delenv("HEAT_TPU_TSDB_RETENTION")
        db.refresh_env()
        monkeypatch.setenv("HEAT_TPU_TSDB_SERIES", "tsdbtest.*, tsdbtest2.exact")
        monkeypatch.setenv("HEAT_TPU_TSDB_RETENTION", "5")
    assert docs[0] == docs[1]
    assert len(docs[0][-7]) == 5  # retention bounds every ring


def test_the_sampler_thread_starts_and_stops():
    assert p_tsdb.start_sampler() is True
    assert p_tsdb.sampler_running()
    p_tsdb.stop_sampler()
    assert not p_tsdb.sampler_running()


# ----------------------------------------------------------------------
# aggregation and tenants
# ----------------------------------------------------------------------
def _worker(ix, chunk_ms, comm_ms, iter_rate, extra=None):
    return {
        "process_index": ix, "process_count": 3, "pid": 100 + ix, "timestamp": 10.0 + ix,
        "metrics": {"comm.bytes.psum": 1024.0 * (ix + 1), "fit.iter_rate": iter_rate,
                    "dispatch.compile_ms": {"count": 2, "sum": 3.0 + ix, "p50": 1.0, "p99": 2.0},
                    **(extra or {})},
        "span_stats": {"fit.chunk": {"count": 4, "total_ms": 4 * chunk_ms, "mean_ms": chunk_ms, "max_ms": chunk_ms},
                       "comm.psum": {"count": 2, "total_ms": comm_ms, "mean_ms": comm_ms / 2, "max_ms": comm_ms}},
        "traces": [], "alerts": {"active": [], "events": []}, "drift": [], "canary": None,
        "journal": {"events": []},
    }


@pytest.mark.parametrize("chunks", [(10.0, 10.0, 10.0), (10.0, 12.0, 31.0), (5.0, 0.0, 7.5)])
def test_merge_snapshots_and_the_straggler_score_are_the_references(chunks):
    snaps = [_worker(ix, c, 2.0 + ix, 3.5 - ix) for ix, c in zip((2, 0, 1), chunks)]
    got = p_agg.merge_snapshots(copy.deepcopy(snaps), publish=False)
    want = r_agg.merge_snapshots(copy.deepcopy(snaps), publish=False)
    assert got == want
    assert p_agg.straggler_score(list(chunks)) == r_agg.straggler_score(list(chunks))
    assert got["merged"]["comm.bytes.psum"]["per_worker"] == {"0": 1024.0, "1": 2048.0, "2": 3072.0}


def test_the_tagged_snapshot_carries_the_references_sections():
    got, want = p_agg.tag_snapshot(), r_agg.tag_snapshot()
    assert sorted(got) == sorted(want)
    assert (got["process_index"], got["process_count"]) == (0, 1)
    assert p_agg.gather_snapshots()[0]["process_index"] == 0


def test_worker_snapshot_files_round_trip(tmp_path):
    snaps = [_worker(ix, 10.0 + ix, 1.0, 2.0) for ix in (1, 0)]
    for s in snaps:
        p_agg.write_worker_snapshot(str(tmp_path), s)
    assert [s["process_index"] for s in p_agg.read_worker_snapshots(str(tmp_path))] == [0, 1]
    assert [s["process_index"] for s in r_agg.read_worker_snapshots(str(tmp_path))] == [0, 1]


def test_tenant_accounts_are_the_references():
    docs = []
    for tn, agg in ((p_tenants, p_agg), (r_tenants, r_agg)):
        tn.reset()
        tn.note_batch("km", [("acme", "gold", 3), ("zeta", "bronze", 9), ("idle", "gold", 0)], flops=1.2e6,
                      bytes_accessed=4.8e5, device_ms=2.5)
        tn.note_batch("pca", [("acme", "gold", 4)], flops=1e3, bytes_accessed=8.0, device_ms=0.5)
        tn.note_batch("pca", [], flops=1.0)
        rep = tn.tenantz_report()
        docs.append((_strip(rep), _strip(tn.tenantz_report(limit=1)), agg.merge_tenant_accounts([rep, rep])))
        tn.reset()
    assert docs[0][:2] == docs[1][:2]
    assert _strip(docs[0][2]) == _strip(docs[1][2])
