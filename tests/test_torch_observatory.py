"""The roofline observatory (heat_tpu_torch/telemetry/observatory.py), the
profiling hooks (telemetry/profiling.py, utils/profiling.py) and the FFT
weight cache's counters, held against heat_tpu's where the reference has
the same function.

* the ledger: a KMeans fit's K1 launches noted under one key (kernel,
  route, shape, type) with the kernel's own cost joined, every launch
  fenced at ``set_sync_every(1)``; warm dispatches noted; ``ledger_report``
  rows from injected durations and costs equal the reference's, exactly;
* peaks: the env knobs win, the calibration cache round-trips under the
  fingerprint and a stale or torn one is refused, as in the reference;
* watermarks: the host RSS where ``torch.cuda`` is absent (the reference's
  CPU fallback), and the ``hbm:watermark`` alert's transitions equal the
  reference's for the same samples;
* profiling: ``torch.profiler`` traces as Chrome-trace artifacts, one at a
  time; ``/profilez`` captures bounded by ``HEAT_TPU_PROFILE_MAX_S``.

The card's twins (a fenced K1 sample, calibration on CUDA, device
watermarks, a CUDA kernel in a capture) are in ``tests/test_torch_gpu.py``."""

import json
import os
import time
import types

import numpy as np
import pytest
import torch

import heat_tpu as hj  # noqa: F401  (the reference's telemetry imports through it)
import heat_tpu_torch as ht
from heat_tpu.core import dispatch as r_dispatch
from heat_tpu.telemetry import alerts as r_alerts
from heat_tpu.telemetry import observatory as r_obs
from heat_tpu_torch import telemetry as p_tel
from heat_tpu_torch.core import dispatch as p_dispatch
from heat_tpu_torch.core import kernels
from heat_tpu_torch.fft import _weight_cache
from heat_tpu_torch.telemetry import alerts as p_alerts
from heat_tpu_torch.telemetry import observatory as p_obs
from heat_tpu_torch.telemetry import profiling as p_prof

PEAK_KNOBS = ("HEAT_TPU_PEAK_FLOPS", "HEAT_TPU_PEAK_GBPS", "HEAT_TPU_PEAK_CACHE")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    ht.use_device("cpu")
    for k in PEAK_KNOBS + ("HEAT_TPU_HBM_BUDGET_BYTES", "HEAT_TPU_HBM_ALERT_MARGIN"):
        monkeypatch.delenv(k, raising=False)
    saved = [(o, o.set_enabled(True), o.set_sync_every(4)) for o in (p_obs, r_obs)]
    for o, a in ((p_obs, p_alerts), (r_obs, r_alerts)):
        o.reset()
        o.reset_peaks()
        o.set_memory_stats_provider(None)
        a.clear_alerts()
    yield
    for o, enabled, sync in saved:
        o.set_enabled(enabled)
        o.set_sync_every(sync)
        o.reset()
        o.reset_peaks()
        o.set_memory_stats_provider(None)
    p_alerts.clear_alerts()
    r_alerts.clear_alerts()


def _blobs(n=600, f=4, seed=0):
    rng = np.random.default_rng(seed)
    centres = rng.normal(scale=6.0, size=(3, f))
    return (centres[rng.integers(0, 3, n)] + rng.normal(size=(n, f))).astype(np.float32)


# ----------------------------------------------------------------------
# the ledger
# ----------------------------------------------------------------------
def test_a_fit_notes_every_k1_launch_under_one_key_with_its_cost():
    p_obs.set_sync_every(1)
    x = ht.array(_blobs(), split=0)
    ext0 = p_dispatch.cache_stats()["external_dispatches"]
    km = ht.cluster.KMeans(n_clusters=3, init="random", random_state=1, max_iter=30).fit(x)
    launches = p_dispatch.cache_stats()["external_dispatches"] - ext0
    key, flops, nbytes = kernels.lloyd_launch_cost(x, 3)
    assert key == ("kernel", "lloyd_step", "plain", (600, 4), 3, "torch.float32")
    assert nbytes == 4 * 600 * 4 + 4 * 3 * 4 + 8 * (3 * 4 + 3 + 1) and flops == 600 * (2 * 3 * 4 + 2 * 4 + 9 + 4)
    # the final assignment also writes one int64 label a point: a key of its own
    lkey, lflops, lbytes = kernels.lloyd_launch_cost(x, 3, labels=True)
    assert lkey == ("kernel", "lloyd_labels") + key[2:] and (lflops, lbytes) == (flops, nbytes + 8 * 600)
    report = p_obs.ledger_report({"flops": 1e12, "bytes_per_s": 1e10})
    assert launches == km.n_iter_ + 1
    for name, calls, cost_flops, cost_bytes in (("lloyd_step", km.n_iter_, flops, nbytes),
                                                ("lloyd_labels", 1, lflops, lbytes)):
        rows = [r for r in report if f"(kernel, {name}," in r["key"]]
        assert len(rows) == 1
        row = rows[0]
        assert row["calls"] == calls
        assert row["timing"] == "fenced" and row["sync_samples"] == row["calls"]
        assert (row["flops"], row["bytes"]) == (cost_flops, cost_bytes)
        assert row["bound"] == "bandwidth" and row["gbytes_per_s"] > 0 and row["utilization"] > 0
        cost = p_dispatch.cost_summary()["per_key"][row["key"]]
        assert cost == {"flops": cost_flops, "bytes_accessed": cost_bytes, "transcendentals": 0.0}


def test_warm_dispatches_are_noted_and_sync_every_zero_never_fences():
    x = ht.array(np.ones((80, 4), np.float32), split=0)
    p_obs.set_sync_every(2)
    for _ in range(9):
        float((x * 2.0 + 1.0).sum())
    rows = p_obs.ledger_report()
    assert rows and rows[0]["calls"] >= 8 and rows[0]["timing"] == "fenced"
    assert rows[0]["sync_samples"] >= 3 and rows[0]["sync_min_ms"] is not None
    p_obs.reset()
    p_obs.set_sync_every(0)
    for _ in range(4):
        float((x * 2.0 + 1.0).sum())
    rows = p_obs.ledger_report()
    assert rows and all(r["sync_samples"] == 0 and r["timing"] == "enqueue" for r in rows)
    p_tel.reset_all("observatory")
    assert p_obs.ledger_report() == []
    p_obs.set_enabled(False)
    float((x * 2.0 + 1.0).sum())
    x2 = ht.array(np.ones((8, 2), np.float32), split=0)
    ht.cluster.KMeans(n_clusters=2, init="random", random_state=0, max_iter=2).fit(x2)
    assert p_obs.ledger_report() == []


def test_event_fenced_samples_are_read_once_their_end_completes(monkeypatch):
    """On a card a sample is a pair of CUDA events around the call, read at
    report time: nothing on the dispatch path waits for the card, and a
    pair counts once its end event has completed (fake events on the CPU;
    the card's twin is in tests/test_torch_gpu.py)."""
    clock = [0.0]

    class FakeEvent:
        done = False

        def __init__(self, enable_timing=False):
            self.t = None

        def record(self):
            self.t = clock[0]

        def query(self):
            return FakeEvent.done

        def elapsed_time(self, end):
            return (end.t - self.t) * 1e3

    assert p_obs.fence_start(("apply", "x")) in (None, "host")  # no card in use: the call's own time
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(p_prof, "_cuda_devices", lambda out, depth=0: {torch.device("cuda", 0)})

    def no_wait(*args):
        raise AssertionError("the dispatch path waited for the card")

    monkeypatch.setattr(torch.cuda, "synchronize", no_wait)
    p_obs.set_sync_every(2)
    key = ("kernel", "fake", "tc", (8, 4), 2, "torch.float32")
    for i in range(6):
        start = p_obs.fence_start(key)
        assert (start is not None) == (i % 2 == 1)
        clock[0] += 0.004  # the call's device time: 4 ms
        p_obs.note(key, 1e-5, object(), start)
        clock[0] += 1.0
    row = p_obs.ledger_report()[0]
    assert (row["calls"], row["sync_samples"], row["timing"]) == (6, 0, "enqueue")
    FakeEvent.done = True
    row = p_obs.ledger_report()[0]
    assert (row["calls"], row["sync_samples"], row["timing"]) == (6, 3, "fenced")
    assert row["mean_ms"] == pytest.approx(4.0) and row["sync_min_ms"] == pytest.approx(4.0)
    # a device that far behind the host: samples past the pending bound are not taken
    p_obs.reset()
    p_obs.set_sync_every(1)
    FakeEvent.done = False
    for _ in range(p_obs._PENDING_MAX + 5):
        p_obs.note(key, 1e-5, object(), p_obs.fence_start(key))
    FakeEvent.done = True
    row = p_obs.ledger_report()[0]
    assert (row["calls"], row["sync_samples"]) == (p_obs._PENDING_MAX + 5, p_obs._PENDING_MAX)


@pytest.mark.parametrize("peaks", [None, {"flops": 1e12, "bytes_per_s": 1e10},
                                   {"flops": 1e12, "bytes_per_s": 1e11}])
@pytest.mark.parametrize("sync_every", [0, 3])
def test_ledger_report_rows_equal_the_reference(monkeypatch, peaks, sync_every):
    """Injected durations (a clock that stands still, so a fence adds
    nothing) and injected costs give the reference's rows exactly."""
    still = types.SimpleNamespace(perf_counter=lambda: 100.0, time=time.time, monotonic=time.monotonic)
    costs = {"per_key": {"(apply, mul, (4, 3))": {"flops": 12.0, "bytes_accessed": 96.0},
                         "(kernel, lloyd_step, tc, (64, 16), 8)": {"flops": 3e5, "bytes_accessed": 4.2e3},
                         "(apply, sum, (0,))": {"flops": 0.0, "bytes_accessed": 48.0}}}
    keys = [("apply", "mul", (4, 3)), ("kernel", "lloyd_step", "tc", (64, 16), 8), ("apply", "sum", (0,)),
            ("apply", "nocost", (1,))]
    durations = [[2e-4, 1e-4, 3e-4, 5e-5, 1e-4], [3.5e-3] * 7, [1e-6, 2e-6], [7e-5]]
    docs = []
    for obs, disp in ((p_obs, p_dispatch), (r_obs, r_dispatch)):
        monkeypatch.setattr(obs, "time", still)
        monkeypatch.setattr(disp, "cost_summary", lambda: costs)
        obs.set_sync_every(sync_every)
        for key, ds in zip(keys, durations):
            for d in ds:
                obs.note(key, d, None)
        docs.append(obs.ledger_report(peaks))
    assert docs[0] == docs[1]
    assert {r["bound"] for r in docs[0]} <= {"compute", "bandwidth", "unknown"}


# ----------------------------------------------------------------------
# device peaks: knobs -> cache -> calibration
# ----------------------------------------------------------------------
def test_env_knobs_win_as_in_the_reference(monkeypatch):
    monkeypatch.setenv("HEAT_TPU_PEAK_FLOPS", "2e12")
    monkeypatch.setenv("HEAT_TPU_PEAK_GBPS", "100")
    got, want = p_obs.device_peaks(calibrate=False), r_obs.device_peaks(calibrate=False)
    for d in (got, want):
        d.pop("fingerprint")
    assert got == want == {"flops": 2e12, "bytes_per_s": 1e11, "source": "env"}
    monkeypatch.delenv("HEAT_TPU_PEAK_FLOPS")
    p_obs.reset_peaks()
    r_obs.reset_peaks()
    assert p_obs.device_peaks(calibrate=False) is None and r_obs.device_peaks(calibrate=False) is None


def test_calibration_persists_reloads_and_refuses_stale_artifacts(tmp_path, monkeypatch):
    from heat_tpu_torch.resilience.atomic import atomic_write

    cache = str(tmp_path / "peaks.json")
    monkeypatch.setenv("HEAT_TPU_PEAK_CACHE", cache)
    peaks = p_obs.device_peaks(calibrate=True)
    assert peaks["source"] == "calibrated" and peaks["flops"] > 0 and peaks["bytes_per_s"] > 0
    assert peaks["fingerprint"] == f"torch={torch.__version__}|cuda={torch.version.cuda}|kind=cpu|n=1"
    assert os.path.exists(cache) and os.path.exists(cache + ".crc32")
    p_obs.reset_peaks()
    again = p_obs.device_peaks(calibrate=False)
    assert again["source"] == "cache" and again["flops"] == peaks["flops"]
    # an artifact of another device is refused, as the reference refuses one
    with open(cache) as f:
        doc = json.load(f)
    doc["fingerprint"] = "torch=9.9|cuda=99.9|kind=NVIDIA H900|n=4096"
    with atomic_write(cache) as tmp:
        with open(tmp, "w") as f:
            json.dump(doc, f)
    p_obs.reset_peaks()
    assert p_obs.device_peaks(calibrate=False) is None
    # a torn one recalibrates instead of crashing
    with open(cache, "w") as f:
        f.write("{torn")
    p_obs.reset_peaks()
    assert p_obs.device_peaks(calibrate=True)["source"] == "calibrated"


def test_calibration_sizes():
    """The card's calibration fills it; the CPU keeps the reference's sizes."""
    assert p_obs._CAL_SIZES == {"cuda": (8192, 1 << 28), "cpu": (512, 1 << 22)}


# ----------------------------------------------------------------------
# watermarks and the hbm:watermark alert
# ----------------------------------------------------------------------
def test_without_a_card_the_probe_reports_host_rss():
    doc = p_obs.watermark_tick(force=True)
    assert doc["source"] == ("device" if torch.cuda.is_available() else "host_rss")
    assert doc["bytes_in_use"] > 0 and doc["predicted_peak_bytes"] == 0.0
    assert p_obs.watermark()["source"] == doc["source"]


def test_budget_alert_transitions_equal_the_reference(monkeypatch):
    docs = []
    for obs, alerts in ((p_obs, p_alerts), (r_obs, r_alerts)):
        obs.set_memory_stats_provider(lambda: (2000.0, 2500.0, "test"))
        monkeypatch.setenv("HEAT_TPU_HBM_BUDGET_BYTES", "1024")
        assert obs.watermark_tick(force=True)["budget_bytes"] == 1024.0
        active = alerts.active_alerts()
        monkeypatch.setenv("HEAT_TPU_HBM_BUDGET_BYTES", "0")
        obs.watermark_tick(force=True)
        strip = lambda d: {k: v for k, v in d.items() if not k.endswith("ts") and k != "active_s"}  # noqa: E731
        docs.append(([strip(a) for a in active], [strip(e) for e in alerts.alert_events()], alerts.active_alerts()))
    assert docs[0] == docs[1]
    assert [e["event"] for e in docs[0][1]] == ["fired", "resolved"] and docs[0][2] == []
    assert docs[0][0][0]["name"] == "hbm:watermark" and docs[0][0][0]["labels"] == {"cause": "budget"}


# ----------------------------------------------------------------------
# profiling: torch.profiler traces and /profilez captures
# ----------------------------------------------------------------------
def test_start_stop_trace_writes_a_chrome_trace_naming_the_annotation(tmp_path):
    p_prof.start_trace(str(tmp_path))
    with pytest.raises(RuntimeError):
        p_prof.start_trace(str(tmp_path))  # one trace at a time
    with p_prof.annotate("observatory.probe"):
        torch.ones(64).mul_(2.0)
    path = p_prof.stop_trace()
    with pytest.raises(RuntimeError):
        p_prof.stop_trace()
    names = {e.get("name") for e in json.load(open(path))["traceEvents"]}
    assert "observatory.probe" in names
    with p_prof.trace(str(tmp_path / "ctx")):
        torch.ones(4).sum()
    assert len(os.listdir(tmp_path / "ctx")) == 1
    with p_prof.trace(None):
        pass


def test_monitor_sets_runtime_on_success_and_on_raise():
    @p_prof.monitor()
    def boom():
        raise ValueError("x")

    @p_prof.monitor("named")
    def ok():
        return (torch.ones(4).sum(), [ht.array(np.ones(3, np.float32))])

    assert boom.last_runtime is None
    with pytest.raises(ValueError):
        boom()
    assert boom.last_runtime is not None and boom.last_runtime >= 0.0
    assert float(ok()[0]) == 4.0 and ok.last_runtime > 0.0


def test_utils_profiling_re_exports_the_five_names():
    from heat_tpu_torch.utils import profiling as alias

    for name in ("annotate", "monitor", "start_trace", "stop_trace", "trace"):
        assert getattr(alias, name) is getattr(p_prof, name)


def test_profilez_capture_roundtrip_single_inflight_and_traversal(tmp_path, monkeypatch):
    monkeypatch.setenv("HEAT_TPU_PROFILE_DIR", str(tmp_path / "prof"))
    monkeypatch.setattr(p_obs, "_PROF", dict(p_obs._PROF, base_dir=None, captures=[], seq=0))
    start = p_obs.start_capture(duration_s=10)
    assert start["dir"].startswith(str(tmp_path / "prof"))
    with pytest.raises(RuntimeError):
        p_obs.start_capture()
    torch.ones(128).mul(3.0).sum()
    rec = p_obs.stop_capture()
    assert rec["error"] is None and rec["artifacts"] and rec["artifacts"][0]["bytes"] > 0
    with pytest.raises(RuntimeError):
        p_obs.stop_capture()
    assert os.path.isfile(p_obs.artifact_path(rec["artifacts"][0]["name"]))
    with pytest.raises(PermissionError):
        p_obs.artifact_path("../../../etc/passwd")
    monkeypatch.setenv("HEAT_TPU_PROFILE_MAX_S", "0.3")
    assert p_obs.start_capture(duration_s=9999)["duration_s"] == pytest.approx(0.3)
    deadline = time.monotonic() + 20
    while time.monotonic() < deadline:
        st = p_obs.capture_status()
        if not st["active"] and st["captures"][-1]["reason"] == "deadline":
            break
        time.sleep(0.05)
    st = p_obs.capture_status()
    assert st["active"] is False and st["captures"][-1]["reason"] == "deadline"


# ----------------------------------------------------------------------
# the FFT weight cache's counter and gauges; knobs and locks
# ----------------------------------------------------------------------
def test_fft_weight_cache_evictions_are_a_registry_counter(monkeypatch):
    monkeypatch.setattr(_weight_cache, "BUDGET_BYTES", 3000)
    _weight_cache.weight_cache_clear()
    before = p_tel.snapshot()["fft.weight_cache.evictions"]

    @_weight_cache.byte_lru
    def table(n):
        return np.zeros(n, np.float64)

    for n in (100, 200, 300, 100):
        table(n)
    snap = p_tel.snapshot()
    assert snap["fft.weight_cache.evictions"] - before == 3
    assert snap["fft.weight_cache.nbytes"] == 800 and snap["fft.weight_cache.budget_bytes"] == 3000
    assert _weight_cache.weight_cache_stats()["evictions"] == snap["fft.weight_cache.evictions"]
    _weight_cache.weight_cache_clear()


def test_the_observatory_knobs_and_locks_are_registered():
    from heat_tpu_torch.analysis.concurrency import LOCK_REGISTRY
    from heat_tpu_torch.core import _env

    for name in ("HEAT_TPU_OBSERVATORY", "HEAT_TPU_PERF_SYNC_EVERY", "HEAT_TPU_PEAK_FLOPS", "HEAT_TPU_PEAK_GBPS",
                 "HEAT_TPU_PEAK_CACHE", "HEAT_TPU_HBM_BUDGET_BYTES", "HEAT_TPU_HBM_ALERT_MARGIN",
                 "HEAT_TPU_PROFILE_DIR", "HEAT_TPU_PROFILE_MAX_S"):
        assert name in _env.KNOBS, name
    assert "telemetry.observatory" in LOCK_REGISTRY and "telemetry.observatory.profiler" in LOCK_REGISTRY
