"""SLO burn-rate monitors (heat_tpu_torch/telemetry/slo.py) and the alert
subsystem (telemetry/alerts.py) against heat_tpu's, the same calls in both
packages under an injected clock (``evaluate(now=...)``), the documents
compared exactly but for wall-clock stamps.

The contracts of the reference's ``tests/test_slo.py``: the windowed math
over cumulative histogram states (reset-safe), the declarative grammar,
multi-window alerting (fire only when both windows burn, resolve when the
fast one cools, the nearest exemplar attached), deduplicated alerts with a
transition ring and a deterministic cross-worker merge; and conformance's
``protocol:<actor>`` alert (heat_tpu/analysis/conformance.py:220)."""

import pytest

import heat_tpu as hj  # noqa: F401
import heat_tpu_torch as ht
from heat_tpu.analysis import conformance as r_conf
from heat_tpu.telemetry import alerts as r_alerts
from heat_tpu.telemetry import journal as r_journal
from heat_tpu.telemetry import metrics as r_metrics
from heat_tpu.telemetry import slo as r_slo
from heat_tpu_torch.analysis import conformance as p_conf
from heat_tpu_torch.telemetry import alerts as p_alerts
from heat_tpu_torch.telemetry import journal as p_journal
from heat_tpu_torch.telemetry import metrics as p_metrics
from heat_tpu_torch.telemetry import slo as p_slo

PKGS = ((p_slo, p_alerts, p_metrics), (r_slo, r_alerts, r_metrics))


@pytest.fixture(autouse=True)
def _clean():
    ht.use_device("cpu")
    for slo, alerts, metrics in PKGS:
        slo.reset_monitors()
        alerts.clear_alerts()
        metrics.reset("slotest.")
    yield
    for slo, alerts, metrics in PKGS:
        slo.reset_monitors()
        alerts.clear_alerts()
        metrics.reset("slotest.")


def _strip(doc):
    """A document without its wall-clock stamps."""
    if isinstance(doc, dict):
        return {k: _strip(v) for k, v in doc.items()
                if not (k.endswith("_ts") or k in ("ts", "timestamp", "active_s", "evaluated_at"))}
    if isinstance(doc, list):
        return [_strip(v) for v in doc]
    return doc


def _both(fn):
    """``fn(slo, alerts, metrics)`` in the port and in the reference."""
    return [fn(*pkg) for pkg in PKGS]


# ----------------------------------------------------------------------
# windowed math
# ----------------------------------------------------------------------
def test_windowed_math_is_the_references():
    def run(slo, alerts, metrics):
        h = metrics.histogram("slotest.wm")
        h.reset()
        for v in (5.0, 0.5, 0.5, 200.0):
            h.observe(v)
        old = h.bucket_counts()
        for v in [1.0] * 90 + [100.0] * 10 + [10.0] * 100:
            h.observe(v)
        delta = slo.windowed_delta(old, h.bucket_counts())
        reset = slo.windowed_delta((2, {10: 50}, 52, 100.0), (0, {10: 3}, 3, 6.0))
        return (old, delta, reset,
                [slo.fraction_over(delta, t) for t in (0.001, 9.5, 10.0, 25.0, 100.0)],
                [slo.windowed_quantile(delta, q) for q in (0.0, 0.5, 0.9, 0.99, 1.0)],
                slo.windowed_quantile((0, {}, 0, 0.0), 0.5),
                [slo.windowed_rate(*a) for a in ((100.0, 160.0, 60.0), (100.0, 30.0, 10.0), (0.0, 0.0, 0.0))],
                [slo.burn_rate(v, 0.99) for v in (0.14, 0.0, 0.5)])

    got, want = _both(run)
    assert got == want
    assert got[2] == (0, {10: 3}, 3, 6.0)


# ----------------------------------------------------------------------
# the grammar
# ----------------------------------------------------------------------
SPECS = ["serving.latency_ms p99 < 25 over 60s/300s",
         "serving.shed_quota+serving.shed_queue / serving.requests rate < 0.01 over 60s",
         "fit.heartbeat_ts fresh < 30s",
         "slotest.lat_ms p50 < 3.5"]
BAD = ["serving.latency_ms 25", "serving.latency_ms q99 < 25", "", "slotest.lat_ms p50 <= 3.5"]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_slo_is_the_references(spec):
    def fields(s):
        return {k: getattr(s, k) for k in ("name", "kind", "threshold", "metric", "metrics", "denominators", "q",
                                          "fast_s", "slow_s", "fast_burn", "slow_burn", "severity")} | \
            {"describe": s.describe()}

    got, want = (fields(slo.parse_slo("x", spec)) for slo, _, _ in PKGS)
    assert got == want


@pytest.mark.parametrize("spec", BAD)
def test_bad_specs_raise_as_the_reference(spec):
    for slo, _, _ in PKGS:
        with pytest.raises(ValueError):
            slo.parse_slo("x", spec)
    for slo, _, _ in PKGS:
        with pytest.raises(ValueError):
            slo.SLO("x", "nonsense", 1.0, metric="m")
        with pytest.raises(ValueError):
            slo.SLO("x", "rate", 1.0)


# ----------------------------------------------------------------------
# burn-rate evaluation and the alert lifecycle, under an injected clock
# ----------------------------------------------------------------------
def _multiwindow(slo, alerts, metrics):
    h = metrics.histogram("slotest.lat_ms")
    h.reset()
    s = slo.parse_slo("lat", "slotest.lat_ms p99 < 25 over 60s/300s")
    slo.register_slo(s)
    t0 = 1_000_000.0
    out = [slo.evaluate(now=t0)]
    for _ in range(100):
        h.observe(5.0)
    out.append(slo.evaluate(now=t0 + 30))
    for i in range(100):
        h.observe(80.0, exemplar=f"{i:016x}")
    out.append(slo.evaluate(now=t0 + 60))
    out.append(alerts.active_alerts())
    for _ in range(2000):
        h.observe(2.0)
    out.append(slo.evaluate(now=t0 + 120))
    out.append(slo.evaluate(now=t0 + 190))
    out.append(alerts.alert_events())
    out.append(slo.slo_report())
    return _strip(out)


def _spike(slo, alerts, metrics):
    h = metrics.histogram("slotest.spike_ms")
    h.reset()
    slo.register_slo(slo.SLO("spike", "quantile", 25.0, metric="slotest.spike_ms", q=0.99, fast_s=60,
                             slow_s=300, fast_burn=14, slow_burn=6))
    t0 = 2_000_000.0
    out = [slo.evaluate(now=t0)]
    for _ in range(2000):
        h.observe(5.0)
    out.append(slo.evaluate(now=t0 + 240))
    for _ in range(100):
        h.observe(80.0)
    out.append(slo.evaluate(now=t0 + 300))
    return _strip(out + [alerts.alert_events()])


def _rate_reset(slo, alerts, metrics):
    shed, total = metrics.counter("slotest.shed"), metrics.counter("slotest.total")
    shed.reset()
    total.reset()
    slo.register_slo(slo.SLO("shed", "rate", 0.01, metrics=("slotest.shed",), denominators=("slotest.total",),
                             fast_s=60, slow_s=300, fast_burn=10, slow_burn=1))
    t0 = 3_000_000.0
    out = [slo.evaluate(now=t0)]
    total.inc(1000)
    shed.inc(500)
    out.append(slo.evaluate(now=t0 + 60))
    shed.reset()
    total.reset()
    total.inc(100)
    out.append(slo.evaluate(now=t0 + 120))
    out.append(slo.evaluate(now=t0 + 190))
    return _strip(out + [alerts.alert_events()])


def _freshness(slo, alerts, metrics):
    g = metrics.gauge("slotest.hb_ts")
    slo.register_slo(slo.SLO("hb", "freshness", 30.0, metric="slotest.hb_ts", fast_s=60, slow_s=300))
    now = 5_000_000.0
    out = [slo.evaluate(now=now)]
    g.set(now - 10)
    out.append(slo.evaluate(now=now))
    g.set(now - 100)
    out.append(slo.evaluate(now=now))
    return _strip(out + [alerts.alert_events()])


def _defaults(slo, alerts, metrics):
    names = slo.install_default_slos()
    again = slo.install_default_slos()
    return names, again, slo.registered_slos()


@pytest.mark.parametrize("scenario", [_multiwindow, _spike, _rate_reset, _freshness, _defaults],
                         ids=lambda f: f.__name__.strip("_"))
def test_burn_rate_scenarios_are_the_references(scenario):
    got, want = _both(scenario)
    assert got == want


def test_the_multiwindow_alert_fires_with_an_exemplar_and_resolves():
    out = _multiwindow(*PKGS[0])
    fired = out[2][0]
    assert fired["firing"] and fired["burn_fast"] >= 14 and fired["burn_slow"] >= 2
    assert out[3][0]["name"] == "slo:lat" and out[3][0]["severity"] == "page" and out[3][0]["trace_id"]
    assert [e["event"] for e in out[6] if e["name"] == "slo:lat"] == ["fired", "resolved"]


def test_the_tick_thread_starts_and_stops():
    p_slo.register_slo(p_slo.parse_slo("lat", "slotest.tick_ms p99 < 25"))
    assert p_slo.start_monitor(tick_s=0.0) is False  # manual evaluation
    assert p_slo.start_monitor(tick_s=0.05) is True
    assert p_slo.start_monitor(tick_s=0.05) is True  # idempotent: one thread
    ticker = p_slo._TICKER
    assert ticker.is_alive()
    p_slo.stop_monitor()
    assert not ticker.is_alive() and p_slo._TICKER is None


# ----------------------------------------------------------------------
# alerts
# ----------------------------------------------------------------------
def test_alert_dedup_ring_and_journal_are_the_references():
    def run(slo, alerts, metrics):
        journal = p_journal if alerts is p_alerts else r_journal
        journal.reset_journal()
        out = [alerts.fire("drift:km", severity="warn", message="m1", value=0.3, threshold=0.25,
                           labels={"model": "km"}, evidence={"series": ["drift.km"]}),
               alerts.fire("drift:km", severity="page", message="m2", value=0.5, threshold=0.25,
                           labels={"model": "km"}, trace_id="ab" * 8),
               alerts.fire("slo:lat", severity="info", message="m3"),
               alerts.is_firing("drift:km", {"model": "km"}), alerts.active_alerts(),
               alerts.resolve("drift:km", {"model": "km"}), alerts.resolve("drift:km", {"model": "km"}),
               alerts.alert_events(), alerts.alert_events(limit=1), alerts.alerts_snapshot(),
               alerts.alert_key("a", {"z": "1", "b": "2"})]
        ev = [{k: e.get(k) for k in ("actor", "action", "model", "severity", "message", "evidence")}
              for e in journal.journal_events()]
        journal.reset_journal()
        return _strip(out + [ev])

    got, want = _both(run)
    assert got == want
    assert got[0] is True and got[1] is False and [e["event"] for e in got[7]] == ["fired", "fired", "resolved"]
    with pytest.raises(ValueError):
        p_alerts.fire("x", severity="loud")


def test_merge_alert_snapshots_is_the_references():
    snaps = [("1", {"active": [{"name": "slo:lat", "severity": "warn", "labels": {}}],
                    "events": [{"name": "slo:lat", "event": "fired", "ts": 5.0}]}),
             ("0", {"active": [{"name": "hbm:watermark", "severity": "page", "labels": {"cause": "budget"}},
                               {"name": "slo:lat", "severity": "warn", "labels": {}}],
                    "events": [{"name": "slo:lat", "event": "fired", "ts": 5.0},
                               {"name": "hbm:watermark", "event": "fired", "ts": 2.0}]}),
             ("2", None)]
    assert p_alerts.merge_alert_snapshots(snaps) == r_alerts.merge_alert_snapshots(snaps)


def test_a_protocol_violation_fires_the_actor_alert_as_the_reference():
    docs = []
    for conf, journal, alerts in ((p_conf, p_journal, p_alerts), (r_conf, r_journal, r_alerts)):
        prev = conf.set_protocol_mode("1")
        conf.reset_conformance()
        journal.reset_journal()
        try:
            with pytest.warns(Warning, match="H805"):
                journal.emit("preempt", "clear")
            docs.append(_strip([{k: v for k, v in a.items() if k != "message"} for a in alerts.active_alerts()]))
        finally:
            conf.set_protocol_mode(prev)
            conf.reset_conformance()
            journal.reset_journal()
            alerts.clear_alerts()
    assert docs[0] == docs[1]
    assert docs[0][0]["name"] == "protocol:preempt" and docs[0][0]["severity"] == "warn"
