"""SLO monitors: declarative objectives with multi-window burn-rate alerting
(counterpart of heat_tpu/telemetry/slo.py).

The registry (PR 6) can *report* ``serving.latency_ms p99`` and the
tracer (PR 10) can *explain* one slow request — but nothing in the
process could say "this replica is violating its latency objective".
This module closes that gap with the SRE playbook's machinery, built on
the telemetry layer's own discipline (no stored samples, bounded
memory):

* an :class:`SLO` is a declarative objective over an **existing**
  metric — ``serving.latency_ms p99 < 25ms over 60s``, ``shed rate
  < 1%``, ``fit.heartbeat_ts`` freshness — either constructed directly
  or parsed from the string grammar (:func:`parse_slo`);
* evaluation is **windowed burn-rate math on the cumulative bounded
  structures**: each tick samples a histogram's geometric bucket
  counts (:meth:`~heat_tpu_torch.telemetry.metrics.Histogram.bucket_counts`)
  or a counter's total into a small ring, and every windowed quantity
  is a *delta between two cumulative samples* — O(windows × buckets
  touched) memory, never O(observations), and robust to counter resets
  (a shrinking cumulative count means the metric was reset; the delta
  restarts from zero instead of going negative);
* alerting is **multi-window, multi-burn-rate**: the *burn rate* is
  how fast the window consumed its error budget (fraction of
  observations violating the objective ÷ the budget ``1 - q``); an
  alert fires only when BOTH the fast window (default 60 s) burns
  above ``HEAT_TPU_SLO_FAST_BURN`` and the slow window (default 300 s)
  above ``HEAT_TPU_SLO_SLOW_BURN`` — the fast window gives the page
  its low detection latency, the slow window keeps a 2-second blip
  from paging anyone — and resolves once the fast window drops back
  under 1.0 (budget no longer being consumed);
* every fired alert goes through :mod:`~heat_tpu_torch.telemetry.alerts`
  (deduplicated fired/resolved events) carrying the **nearest exemplar
  trace_id** above the violated threshold, so the page links straight
  to a concrete retained request in ``/tracez``.

:func:`install_default_slos` registers the serving fleet's standard
objectives (latency p99, shed rate, heartbeat freshness — thresholds
from the ``HEAT_TPU_SLO_*`` knobs); the serving layer calls it when its
routes mount.  ``HEAT_TPU_SLO_TICK_S > 0`` runs the evaluation loop on
a daemon thread; tests drive :func:`evaluate` directly with an explicit
clock.  ``/sloz`` renders :func:`slo_report`.

Thread-safety: the monitor table and every per-SLO sample ring are
only touched under the registered ``telemetry.slo`` lock (the tick
thread evaluates while HTTP handler threads render ``/sloz``).
"""

from __future__ import annotations

import math
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..core import _env
from ..analysis import tsan as _tsan
from . import alerts as _alerts
from . import metrics as _metrics
from . import tsdb as _tsdb

__all__ = [
    "SLO",
    "burn_rate",
    "evaluate",
    "fraction_over",
    "install_default_slos",
    "parse_slo",
    "register_slo",
    "registered_slos",
    "reset_monitors",
    "slo_report",
    "start_monitor",
    "stop_monitor",
    "unregister_slo",
    "windowed_delta",
    "windowed_quantile",
    "windowed_rate",
]

# read through the knob registry (core/_env.py)
_FAST_S = _env.env_float("HEAT_TPU_SLO_FAST_WINDOW_S")
_SLOW_S = _env.env_float("HEAT_TPU_SLO_SLOW_WINDOW_S")
_FAST_BURN = _env.env_float("HEAT_TPU_SLO_FAST_BURN")
_SLOW_BURN = _env.env_float("HEAT_TPU_SLO_SLOW_BURN")

_EVALS_C = _metrics.counter("slo.evaluations", "SLO monitor evaluation ticks")

_BOUNDS = _metrics._BOUNDS  # the shared geometric bucket ladder


# ----------------------------------------------------------------------
# windowed math over cumulative bounded state (pure functions)
# ----------------------------------------------------------------------
def windowed_delta(
    old: Tuple[int, Dict[int, int], int, float],
    cur: Tuple[int, Dict[int, int], int, float],
) -> Tuple[int, Dict[int, int], int, float]:
    """Bucket-state delta ``cur - old`` of two cumulative histogram
    samples (``(low, buckets, count, sum)`` as
    :meth:`Histogram.bucket_counts` returns them).

    A reset between the samples (``cur.count < old.count`` — cumulative
    counts never shrink otherwise) restarts the delta from zero: the
    window reports exactly the observations since the reset, never a
    negative phantom."""
    if cur[2] < old[2]:
        return cur
    buckets = {}
    for ix, c in cur[1].items():
        d = c - old[1].get(ix, 0)
        if d > 0:
            buckets[ix] = d
    return (cur[0] - old[0], buckets, cur[2] - old[2], cur[3] - old[3])


def windowed_rate(old: float, cur: float, dt: float) -> float:
    """Per-second rate of a cumulative counter over ``dt`` seconds,
    reset-safe (``cur < old`` restarts from zero)."""
    if dt <= 0:
        return 0.0
    delta = cur if cur < old else cur - old
    return delta / dt


def fraction_over(
    delta: Tuple[int, Dict[int, int], int, float], threshold: float
) -> float:
    """Fraction of the delta's observations above ``threshold``,
    geometric-interpolated inside the crossing bucket (the same
    in-bucket model :meth:`Histogram.quantile` uses)."""
    low, buckets, count, _ = delta
    if count <= 0:
        return 0.0
    over = 0.0
    for ix, c in buckets.items():
        hi = _BOUNDS[ix]
        lo = _BOUNDS[ix - 1] if ix > 0 else 0.0
        if lo >= threshold:
            over += c
        elif hi > threshold and lo > 0:
            # crossing bucket: geometric-uniform share above threshold
            over += c * math.log(hi / threshold) / math.log(hi / lo)
        elif hi > threshold:
            over += c * 0.5  # degenerate low edge: split the bucket
    # the low bucket (v <= first bound) can never exceed a real threshold
    return min(over / count, 1.0)


def windowed_quantile(
    delta: Tuple[int, Dict[int, int], int, float], q: float
) -> Optional[float]:
    """q-quantile estimate of the delta's observations (None when the
    window saw nothing) — the reported companion of the burn verdict."""
    low, buckets, count, _ = delta
    if count <= 0:
        return None
    target = q * count
    seen = low
    if seen >= target:
        return _BOUNDS[0]
    val = None
    for ix in sorted(buckets):
        seen += buckets[ix]
        if seen >= target:
            lo = _BOUNDS[ix - 1] if ix > 0 else _BOUNDS[0]
            val = (lo * _BOUNDS[ix]) ** 0.5
            break
    if val is None:  # numeric slack at q=1.0
        val = _BOUNDS[max(buckets)] if buckets else _BOUNDS[0]
    return val


def burn_rate(error_fraction: float, objective: float) -> float:
    """How fast a window is consuming its error budget: the violating
    fraction over the budget ``1 - objective`` (an objective of 0.99
    leaves a 1% budget; a window violating 14% burns at rate 14)."""
    budget = max(1.0 - objective, 1e-9)
    return error_fraction / budget


# ----------------------------------------------------------------------
# the declarative objective
# ----------------------------------------------------------------------
class SLO:
    """One declarative objective over existing metrics.

    Three kinds:

    * ``quantile`` — ``metric`` is a histogram; the objective is
      "quantile ``q`` of the windowed observations stays under
      ``threshold``" (burn = fraction over threshold ÷ (1 - q));
    * ``rate`` — ``metrics`` (numerators) over ``denominators``
      (both cumulative counters, summed); the objective is "the
      windowed ratio stays under ``threshold``" (burn = ratio ÷
      threshold);
    * ``freshness`` — ``metric`` is a unix-timestamp gauge; the
      objective is "its age stays under ``threshold`` seconds"
      (burn = age ÷ threshold; a zero gauge means "never beat" and
      reports no data rather than firing).
    """

    __slots__ = ("name", "kind", "metric", "metrics", "denominators", "q",
                 "threshold", "fast_s", "slow_s", "fast_burn", "slow_burn",
                 "severity", "labels", "_samples")

    def __init__(
        self,
        name: str,
        kind: str,
        threshold: float,
        metric: Optional[str] = None,
        metrics: Optional[Sequence[str]] = None,
        denominators: Optional[Sequence[str]] = None,
        q: float = 0.99,
        fast_s: Optional[float] = None,
        slow_s: Optional[float] = None,
        fast_burn: Optional[float] = None,
        slow_burn: Optional[float] = None,
        severity: str = "page",
        labels: Optional[Dict[str, str]] = None,
    ):
        if kind not in ("quantile", "rate", "freshness"):
            raise ValueError(f"unknown SLO kind {kind!r}")
        if kind == "rate":
            if not metrics or not denominators:
                raise ValueError("rate SLO needs numerator and denominator counters")
        elif not metric:
            raise ValueError(f"{kind} SLO needs a metric name")
        if not 0.0 < q < 1.0:
            raise ValueError(f"quantile must be in (0, 1), got {q}")
        self.name = name
        self.kind = kind
        self.metric = metric
        self.metrics = tuple(metrics or ())
        self.denominators = tuple(denominators or ())
        self.q = float(q)
        self.threshold = float(threshold)
        self.fast_s = float(_FAST_S if fast_s is None else fast_s)
        self.slow_s = float(_SLOW_S if slow_s is None else slow_s)
        self.fast_burn = float(_FAST_BURN if fast_burn is None else fast_burn)
        self.slow_burn = float(_SLOW_BURN if slow_burn is None else slow_burn)
        self.severity = severity
        self.labels = dict(labels or {})
        #: cumulative-state ring: (ts, payload) where payload is the
        #: histogram bucket state or the (num_total, den_total) pair
        self._samples: deque = deque()

    # -- sampling -------------------------------------------------------
    def _current_state(self):
        if self.kind == "quantile":
            h = _metrics.REGISTRY.get(self.metric)
            if not isinstance(h, _metrics.Histogram):
                return None
            return h.bucket_counts()
        if self.kind == "rate":
            def total(names: Sequence[str]) -> float:
                s = 0.0
                for n in names:
                    m = _metrics.REGISTRY.get(n)
                    if m is not None and not isinstance(m, _metrics.Histogram):
                        s += float(m.value)
                return s

            return (total(self.metrics), total(self.denominators))
        return None  # freshness reads the gauge live in evaluate()

    def _window_start(self, now: float, window_s: float):
        """The newest sample at or before ``now - window_s`` (partial
        windows fall back to the oldest sample)."""
        cutoff = now - window_s
        best = None
        for ts, state in self._samples:
            if ts <= cutoff:
                best = (ts, state)
            else:
                break
        if best is None and self._samples:
            best = self._samples[0]
        return best

    def _trim(self, now: float) -> None:
        # keep one sample beyond the slow window so its delta stays full
        horizon = now - self.slow_s
        while len(self._samples) > 1 and self._samples[1][0] <= horizon:
            self._samples.popleft()

    # -- evaluation -----------------------------------------------------
    def evaluate(self, now: Optional[float] = None) -> Dict[str, Any]:
        """Sample the cumulative state and return this objective's
        verdict document (also the ``/sloz`` row).  Pure in everything
        but the sample ring; the caller (monitor) turns ``firing`` /
        ``resolved`` into alert transitions."""
        now = time.time() if now is None else now
        doc: Dict[str, Any] = {
            "name": self.name,
            "kind": self.kind,
            "objective": self.describe(),
            "threshold": self.threshold,
            "severity": self.severity,
            "labels": dict(sorted(self.labels.items())),
            "windows": {},
            "firing": False,
            "no_data": False,
        }
        if self.kind == "freshness":
            g = _metrics.REGISTRY.get(self.metric)
            ts = float(g.value) if g is not None else 0.0
            if ts <= 0.0:
                doc["no_data"] = True
                doc["burn_fast"] = doc["burn_slow"] = 0.0
                return doc
            age = max(now - ts, 0.0)
            burn = age / self.threshold if self.threshold > 0 else 0.0
            doc["age_s"] = round(age, 3)
            doc["burn_fast"] = doc["burn_slow"] = round(burn, 4)
            doc["firing"] = burn >= 1.0
            doc["resolved"] = burn < 1.0
            return doc

        state = self._current_state()
        if state is None:
            doc["no_data"] = True
            doc["burn_fast"] = doc["burn_slow"] = 0.0
            return doc
        self._samples.append((now, state))
        self._trim(now)

        burns: Dict[str, float] = {}
        for label, window_s in (("fast", self.fast_s), ("slow", self.slow_s)):
            start = self._window_start(now, window_s)
            dt = now - start[0] if start is not None else 0.0
            if self.kind == "quantile":
                delta = (
                    windowed_delta(start[1], state)
                    if start is not None and start[1] is not state
                    else (0, {}, 0, 0.0)
                )
                frac = fraction_over(delta, self.threshold)
                burn = burn_rate(frac, self.q)
                wdoc = {
                    "window_s": window_s,
                    "observations": delta[2],
                    "violating_fraction": round(frac, 6),
                    "burn": round(burn, 4),
                    f"p{int(self.q * 100)}": windowed_quantile(delta, self.q),
                }
            else:  # rate
                if start is not None and start[1] is not state:
                    num = windowed_rate(start[1][0], state[0], dt) * dt
                    den = windowed_rate(start[1][1], state[1], dt) * dt
                else:
                    num = den = 0.0
                ratio = (num / den) if den > 0 else 0.0
                burn = ratio / self.threshold if self.threshold > 0 else 0.0
                wdoc = {
                    "window_s": window_s,
                    "numerator": round(num, 3),
                    "denominator": round(den, 3),
                    "ratio": round(ratio, 6),
                    "burn": round(burn, 4),
                }
            burns[label] = burn
            doc["windows"][label] = wdoc
        doc["burn_fast"] = round(burns["fast"], 4)
        doc["burn_slow"] = round(burns["slow"], 4)
        doc["firing"] = (
            burns["fast"] >= self.fast_burn and burns["slow"] >= self.slow_burn
        )
        doc["resolved"] = burns["fast"] < 1.0
        return doc

    def exemplar_trace_id(self) -> Optional[str]:
        """The nearest retained exemplar above the violated threshold
        (quantile SLOs only): the trace a page should link to.  Falls
        back to the most recent exemplar anywhere in the histogram."""
        if self.kind != "quantile":
            return None
        h = _metrics.REGISTRY.get(self.metric)
        if not isinstance(h, _metrics.Histogram):
            return None
        ex = h.exemplars()
        if not ex:
            return None
        over = [(le, rec) for le, rec in ex.items() if rec["value"] > self.threshold]
        if over:
            # nearest above the threshold: the least-extreme violator
            return min(over, key=lambda t: t[0])[1]["trace_id"]
        return max(ex.values(), key=lambda rec: rec["ts"])["trace_id"]

    def describe(self) -> str:
        if self.kind == "quantile":
            return (
                f"{self.metric} p{int(self.q * 100)} < {self.threshold:g} "
                f"over {self.fast_s:g}s/{self.slow_s:g}s"
            )
        if self.kind == "rate":
            return (
                f"{'+'.join(self.metrics)} / {'+'.join(self.denominators)} "
                f"rate < {self.threshold:g} over {self.fast_s:g}s/{self.slow_s:g}s"
            )
        return f"{self.metric} fresh < {self.threshold:g}s"

    def __repr__(self) -> str:
        return f"SLO({self.name!r}: {self.describe()})"


def parse_slo(name: str, spec: str, **kwargs) -> SLO:
    """Build an :class:`SLO` from the string grammar::

        "serving.latency_ms p99 < 25 over 60s/300s"        (quantile)
        "serving.shed_quota+serving.shed_queue / serving.requests
         rate < 0.01 over 60s/300s"                        (rate)
        "fit.heartbeat_ts fresh < 30s"                     (freshness)

    ``over`` is optional (knob-default windows); thresholds are in the
    metric's own unit.  Keyword arguments (``severity``, ``labels``,
    burn factors) pass through to the constructor."""
    text = " ".join(spec.split())
    windows: Dict[str, float] = {}
    if " over " in text:
        text, _, wpart = text.rpartition(" over ")
        parts = [p.strip().rstrip("s") for p in wpart.split("/")]
        windows["fast_s"] = float(parts[0])
        if len(parts) > 1:
            windows["slow_s"] = float(parts[1])
    if " fresh < " in text:
        metric, _, rest = text.partition(" fresh < ")
        return SLO(
            name, "freshness", float(rest.strip().rstrip("s")),
            metric=metric.strip(), **windows, **kwargs,
        )
    if " rate < " in text:
        ratio, _, rest = text.partition(" rate < ")
        num_s, _, den_s = ratio.partition("/")
        return SLO(
            name, "rate", float(rest.strip()),
            metrics=[m.strip() for m in num_s.split("+") if m.strip()],
            denominators=[m.strip() for m in den_s.split("+") if m.strip()],
            **windows, **kwargs,
        )
    head, _, rest = text.partition(" < ")
    if not rest:
        raise ValueError(f"unparseable SLO spec {spec!r}")
    metric, _, qpart = head.rpartition(" ")
    if not qpart.startswith("p"):
        raise ValueError(
            f"quantile SLO spec needs 'metric pNN < threshold', got {spec!r}"
        )
    return SLO(
        name, "quantile", float(rest.strip()), metric=metric.strip(),
        q=float(qpart[1:]) / 100.0, **windows, **kwargs,
    )


# ----------------------------------------------------------------------
# the process monitor: registered objectives + the evaluation loop
# ----------------------------------------------------------------------
_LOCK = _tsan.register_lock("telemetry.slo")
_SLOS: Dict[str, SLO] = {}
_LAST_REPORT: List[Dict[str, Any]] = []
_TICKER: Optional[threading.Thread] = None
_TICK_STOP = threading.Event()


def register_slo(slo: SLO) -> SLO:
    """Register (or replace, by name) one objective in the process
    monitor; returns it."""
    with _LOCK:
        _tsan.note_access("telemetry.slo.state")
        _SLOS[slo.name] = slo
    return slo


def unregister_slo(name: str) -> None:
    """Drop one objective (no-op when absent); its alert resolves."""
    with _LOCK:
        _tsan.note_access("telemetry.slo.state")
        slo = _SLOS.pop(name, None)
    if slo is not None:
        _alerts.resolve(f"slo:{name}", labels=slo.labels)


def registered_slos() -> List[str]:
    with _LOCK:
        _tsan.note_access("telemetry.slo.state", write=False)
        return sorted(_SLOS)


def reset_monitors() -> None:
    """Drop every registered objective and its sample rings (tests,
    ``reset_all``)."""
    stop_monitor()
    with _LOCK:
        _tsan.note_access("telemetry.slo.state")
        _SLOS.clear()
        _LAST_REPORT.clear()


def evaluate(now: Optional[float] = None) -> List[Dict[str, Any]]:
    """Evaluate every registered objective once; fire/resolve alerts on
    the verdict transitions; returns (and caches, for ``/sloz``) the
    verdict documents.  ``now`` is injectable so tests can walk a
    synthetic clock through the windows."""
    now = time.time() if now is None else now
    with _LOCK:
        _tsan.note_access("telemetry.slo.state")
        slos = list(_SLOS.values())
        report = []
        for slo in slos:
            doc = slo.evaluate(now)
            report.append(doc)
        _LAST_REPORT[:] = report
    # alert transitions OUTSIDE the slo lock: alerts has its own
    # registered lock and holding both invites an order cycle (tsdb
    # recording likewise takes only the tsdb lock)
    for slo, doc in zip(slos, report):
        aname = f"slo:{slo.name}"
        fast_series = f"slo.{slo.name}.burn_fast"
        slow_series = f"slo.{slo.name}.burn_slow"
        if not doc.get("no_data"):
            _tsdb.record(fast_series, doc["burn_fast"], ts=now)
            _tsdb.record(slow_series, doc["burn_slow"], ts=now)
        if doc["firing"]:
            _alerts.fire(
                aname,
                severity=slo.severity,
                message=(
                    f"{slo.describe()} violated: fast burn "
                    f"{doc['burn_fast']:g}x (slow {doc['burn_slow']:g}x)"
                ),
                value=doc["burn_fast"],
                threshold=slo.fast_burn,
                trace_id=slo.exemplar_trace_id(),
                labels=slo.labels,
                evidence={
                    "objective": slo.describe(),
                    "burn_fast": doc["burn_fast"],
                    "burn_slow": doc["burn_slow"],
                    "windows": doc.get("windows", {}),
                    "series": [fast_series, slow_series],
                },
            )
        elif doc.get("resolved"):
            _alerts.resolve(aname, labels=slo.labels)
    _EVALS_C.inc()
    return report


def slo_report() -> Dict[str, Any]:
    """The ``/sloz`` payload: every objective's latest verdict (from
    the last tick, re-evaluated when none ran yet) plus the active
    alert table."""
    with _LOCK:
        _tsan.note_access("telemetry.slo.state", write=False)
        cached = list(_LAST_REPORT)
        n = len(_SLOS)
    if not cached and n:
        cached = evaluate()
    return {
        "timestamp": time.time(),
        "slos": cached,
        "alerts": _alerts.active_alerts(),
        "tick_thread": _TICKER is not None and _TICKER.is_alive(),
    }


def start_monitor(tick_s: Optional[float] = None) -> bool:
    """Start the background evaluation loop (daemon thread).

    ``tick_s=None`` reads ``HEAT_TPU_SLO_TICK_S``; a non-positive tick
    leaves evaluation manual and returns False.  Idempotent."""
    global _TICKER
    if tick_s is None:
        tick_s = float(_env.env_str("HEAT_TPU_SLO_TICK_S") or "0")
    if tick_s <= 0:
        return False
    with _LOCK:
        _tsan.note_access("telemetry.slo.state")
        if _TICKER is not None and _TICKER.is_alive():
            return True
        _TICK_STOP.clear()
        _TICKER = threading.Thread(
            target=_tick_loop, args=(float(tick_s),),
            name="heat-tpu-slo-monitor", daemon=True,
        )
        _TICKER.start()
    return True


def stop_monitor() -> None:
    """Stop the background loop (no-op when none is running)."""
    global _TICKER
    with _LOCK:
        _tsan.note_access("telemetry.slo.state")
        t, _TICKER = _TICKER, None
    if t is not None and t.is_alive():
        _TICK_STOP.set()
        t.join(timeout=5)


def _tick_loop(tick_s: float) -> None:  # pragma: no cover - thread body
    while not _TICK_STOP.wait(tick_s):
        try:
            evaluate()
            from . import sketch as _sketch

            _sketch.check_drift()
        except Exception:  # a monitor bug must never kill the tick thread
            pass


# ----------------------------------------------------------------------
# the serving fleet's standard objectives
# ----------------------------------------------------------------------
def install_default_slos() -> List[str]:
    """Register the serving defaults (idempotent; returns their names):

    * ``serving_latency`` — ``serving.latency_ms p99 <
      HEAT_TPU_SLO_LATENCY_MS`` (25 ms default);
    * ``serving_shed`` — shed requests (quota + queue) over admitted
      requests under ``HEAT_TPU_SLO_SHED_PCT`` % (1% default);
    * ``fit_heartbeat`` — ``fit.heartbeat_ts`` fresher than
      ``HEAT_TPU_SLO_HEARTBEAT_S`` (0 = objective not installed; idle
      serving processes have no fit heartbeat to watch).
    """
    latency_ms = _env.env_float("HEAT_TPU_SLO_LATENCY_MS")
    shed_pct = _env.env_float("HEAT_TPU_SLO_SHED_PCT")
    heartbeat_s = float(_env.env_str("HEAT_TPU_SLO_HEARTBEAT_S") or "0")
    names = []
    register_slo(
        SLO("serving_latency", "quantile", latency_ms,
            metric="serving.latency_ms", q=0.99)
    )
    names.append("serving_latency")
    register_slo(
        SLO("serving_shed", "rate", shed_pct / 100.0,
            metrics=("serving.shed_quota", "serving.shed_queue"),
            denominators=("serving.requests", "serving.shed_quota",
                          "serving.shed_queue"))
    )
    names.append("serving_shed")
    if heartbeat_s > 0:
        register_slo(
            SLO("fit_heartbeat", "freshness", heartbeat_s,
                metric="fit.heartbeat_ts", severity="warn")
        )
        names.append("fit_heartbeat")
    return names


def refresh_env() -> None:
    """Re-read the window/burn knobs (tests that flip the env
    mid-process); existing SLOs keep their constructed windows."""
    global _FAST_S, _SLOW_S, _FAST_BURN, _SLOW_BURN
    _FAST_S = _env.env_float("HEAT_TPU_SLO_FAST_WINDOW_S")
    _SLOW_S = _env.env_float("HEAT_TPU_SLO_SLOW_WINDOW_S")
    _FAST_BURN = _env.env_float("HEAT_TPU_SLO_FAST_BURN")
    _SLOW_BURN = _env.env_float("HEAT_TPU_SLO_SLOW_BURN")


_HTML_HEAD = (
    "<!doctype html><html><head><title>heat_tpu /sloz</title><style>"
    "body{font-family:monospace;margin:1.5em}table{border-collapse:collapse;margin:.5em 0 1.5em}"
    "td,th{border:1px solid #999;padding:2px 8px;text-align:right}"
    "th{background:#eee}td.l,th.l{text-align:left}"
    ".firing{background:#ffd6d6}.warn{background:#ffe9c6}</style></head><body>"
)


def render_sloz_html() -> str:
    """``/sloz`` as a small dependency-free HTML page: one row per
    objective (burn rates, window detail) plus the active alert table.
    Every interpolated string goes through ``html.escape`` — SLO names
    and alert labels can carry user-influenced model names."""
    import html as _html

    esc = lambda s: _html.escape(str(s), quote=True)
    rep = slo_report()
    parts = [_HTML_HEAD, "<h1>/sloz — SLO burn-rate monitors</h1>"]
    parts.append(
        f"<p>{len(rep['slos'])} objective(s) · tick thread "
        f"{'running' if rep['tick_thread'] else 'off (manual evaluate)'} · "
        f"generated {time.strftime('%H:%M:%S')}</p>"
    )
    if rep["slos"]:
        parts.append(
            "<table><tr><th class=l>objective</th><th>kind</th>"
            "<th>burn fast</th><th>burn slow</th><th>state</th></tr>"
        )
        for doc in rep["slos"]:
            state = (
                "FIRING" if doc["firing"]
                else ("no data" if doc.get("no_data") else "ok")
            )
            cls = "firing" if doc["firing"] else ""
            parts.append(
                f'<tr class="{esc(cls)}"><td class=l>{esc(doc["objective"])}</td>'
                f'<td>{esc(doc["kind"])}</td><td>{esc(doc["burn_fast"])}</td>'
                f'<td>{esc(doc["burn_slow"])}</td><td>{esc(state)}</td></tr>'
            )
        parts.append("</table>")
    else:
        parts.append("<p>(no objectives registered — call "
                     "telemetry.install_default_slos() or register_slo())</p>")
    parts.append(_render_alert_table(rep["alerts"], esc))
    parts.append("<p>JSON form: <a href='/sloz?format=json'>/sloz?format=json</a> · "
                 "drift: <a href='/driftz'>/driftz</a></p></body></html>")
    return "".join(parts)


def _render_alert_table(alerts_docs, esc) -> str:
    """Shared active-alert table (the /sloz and /driftz pages both
    embed it; strings pre-escaped by the caller's ``esc``)."""
    if not alerts_docs:
        return "<h3>active alerts</h3><p>(none firing)</p>"
    parts = [
        "<h3>active alerts</h3><table><tr><th class=l>alert</th>"
        "<th>severity</th><th>value</th><th>threshold</th>"
        "<th class=l>exemplar trace</th><th class=l>message</th></tr>"
    ]
    for a in alerts_docs:
        labels = ",".join(f"{k}={v}" for k, v in sorted(a["labels"].items()))
        name = a["name"] + (f"{{{labels}}}" if labels else "")
        cls = "firing" if a["severity"] == "page" else "warn"
        tid = a.get("trace_id")
        tcell = (
            f'<a href="/tracez?trace_id={esc(tid)}">{esc(tid)}</a>' if tid else "·"
        )
        parts.append(
            f'<tr class="{esc(cls)}"><td class=l>{esc(name)}</td>'
            f'<td>{esc(a["severity"])}</td><td>{esc(a["value"])}</td>'
            f'<td>{esc(a["threshold"])}</td><td class=l>{tcell}</td>'
            f'<td class=l>{esc(a["message"])}</td></tr>'
        )
    parts.append("</table>")
    return "".join(parts)
