"""Embedded metric history: fixed-interval ring buffers behind /queryz
(counterpart of heat_tpu/telemetry/tsdb.py).

The metrics registry (:mod:`heat_tpu_torch.telemetry.metrics`) exposes the
*current* value of every series; nothing in-process retains history, so
by the time a human looks at a rollback the burn rate that triggered it
is gone.  This module keeps a bounded time-series window **inside the
process** — no external Prometheus required, which matters on
accelerator hosts where the serving container is often the only thing
running:

* a **sampler thread** scrapes an allowlisted subset of the registry
  every ``HEAT_TPU_TSDB_INTERVAL_S`` seconds into per-series rings of
  ``HEAT_TPU_TSDB_RETENTION`` points (histograms/summaries fan out into
  ``<name>.count`` / ``<name>.p50`` / ``<name>.p99`` sub-series);
* a **push API** (:func:`record`) for controller-computed series — the
  SLO burn monitors and the fleet autoscaler record the exact values
  they decide on, so a decision-journal event's evidence names series
  whose triggering samples are still resolvable via ``/queryz``;
* ``/queryz?series=<name>&window=<seconds>`` range queries (HTML table
  + sparkline, ``?format=json`` machine form).

The allowlist (``HEAT_TPU_TSDB_SERIES``, comma-separated, trailing
``*`` = prefix match) bounds scrape cost; empty means the curated
:data:`DEFAULT_SERIES` control-plane set.  Memory is strictly bounded:
``series × retention`` points of two floats each.

Thread-safety: the sampler thread, controller ``record()`` calls and
``/queryz`` handler threads all touch the ring map — every access runs
under the registered ``telemetry.tsdb`` lock; the registry scrape
itself happens *outside* it (``metrics.snapshot()`` takes the registry
lock internally; nesting them would register a cross-module lock-order
edge for no benefit).
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..core import _env
from ..analysis import tsan as _tsan
from . import metrics as _metrics

__all__ = [
    "DEFAULT_SERIES",
    "allowed_series",
    "query",
    "queryz_report",
    "record",
    "refresh_env",
    "render_queryz_html",
    "reset_tsdb",
    "sample_once",
    "sampler_running",
    "series_names",
    "start_sampler",
    "stop_sampler",
    "tsdb_snapshot",
    "window_stats",
]

# read through the knob registry (core/_env.py)
_INTERVAL_S = _env.env_float("HEAT_TPU_TSDB_INTERVAL_S")
_RETENTION = _env.env_int("HEAT_TPU_TSDB_RETENTION")
_SERIES_ENV = _env.env_str("HEAT_TPU_TSDB_SERIES")

#: the curated control-plane set scraped when HEAT_TPU_TSDB_SERIES is
#: empty: everything the autonomous loops decide on (prefix globs)
DEFAULT_SERIES = (
    "slo.*",
    "serve.*",
    "drift.*",
    "canary.*",
    "fleet.*",
    "qos.*",
    "stream.*",
    "journal.*",
    "alerts.*",
    "dispatch.compile_fallbacks",
)

_SAMPLES_C = _metrics.counter("tsdb.samples", "TSDB points recorded (scrape + push)")
_SCRAPES_C = _metrics.counter("tsdb.scrapes", "TSDB sampler scrape passes")

#: series name -> deque[(ts, value)]; plus sampler-thread handle/stop
#: event — all under the registered lock
_LOCK = _tsan.register_lock("telemetry.tsdb")
_RINGS: Dict[str, "deque[Tuple[float, float]]"] = {}
_THREAD: Optional[threading.Thread] = None
_STOP: Optional[threading.Event] = None


def refresh_env() -> None:
    """Re-read the ``HEAT_TPU_TSDB_*`` knobs (tests that flip the env
    mid-process).  Existing rings keep their points, re-bounded to the
    new retention."""
    global _INTERVAL_S, _RETENTION, _SERIES_ENV
    _INTERVAL_S = _env.env_float("HEAT_TPU_TSDB_INTERVAL_S")
    _RETENTION = _env.env_int("HEAT_TPU_TSDB_RETENTION")
    _SERIES_ENV = _env.env_str("HEAT_TPU_TSDB_SERIES")
    with _LOCK:
        _tsan.note_access("telemetry.tsdb.state")
        for name in list(_RINGS):
            _RINGS[name] = deque(_RINGS[name], maxlen=max(1, _RETENTION))


def reset_tsdb() -> None:
    """Stop the sampler and drop every ring (tests)."""
    stop_sampler()
    with _LOCK:
        _tsan.note_access("telemetry.tsdb.state")
        _RINGS.clear()


def allowed_series() -> Tuple[str, ...]:
    """The active allowlist patterns (env override or the default
    control-plane set); entries ending ``*`` match by prefix."""
    if _SERIES_ENV.strip():
        return tuple(
            p.strip() for p in _SERIES_ENV.split(",") if p.strip()
        )
    return DEFAULT_SERIES


def _matches(name: str, patterns: Sequence[str]) -> bool:
    for p in patterns:
        if p.endswith("*"):
            if name.startswith(p[:-1]):
                return True
        elif name == p:
            return True
    return False


def record(series: str, value: float, ts: Optional[float] = None) -> None:
    """Push one point — the controller-side API: a burn monitor or the
    autoscaler records the exact value it decided on, under the series
    name its journal evidence cites."""
    point = (float(ts if ts is not None else time.time()), float(value))
    with _LOCK:
        _tsan.note_access("telemetry.tsdb.state")
        ring = _RINGS.get(series)
        if ring is None:
            ring = _RINGS[series] = deque(maxlen=max(1, _RETENTION))
        ring.append(point)
    _SAMPLES_C.inc()


def sample_once(now: Optional[float] = None) -> int:
    """One scrape pass: snapshot the registry (outside the tsdb lock),
    filter through the allowlist, push one point per scalar series and
    ``count``/``p50``/``p99`` sub-points per histogram.  Returns the
    number of points recorded; the sampler thread calls this on its
    interval, tests call it directly for determinism."""
    ts = float(now if now is not None else time.time())
    snap = _metrics.snapshot()
    patterns = allowed_series()
    points: List[Tuple[str, float]] = []
    for name in sorted(snap):
        if not _matches(name, patterns):
            continue
        v = snap[name]
        if isinstance(v, dict):
            for sub in ("count", "p50", "p99"):
                if isinstance(v.get(sub), (int, float)):
                    points.append((f"{name}.{sub}", float(v[sub])))
        elif isinstance(v, (int, float)):
            points.append((name, float(v)))
    with _LOCK:
        _tsan.note_access("telemetry.tsdb.state")
        for name, val in points:
            ring = _RINGS.get(name)
            if ring is None:
                ring = _RINGS[name] = deque(maxlen=max(1, _RETENTION))
            ring.append((ts, val))
    _SCRAPES_C.inc()
    if points:
        _SAMPLES_C.inc(len(points))
    return len(points)


def start_sampler() -> bool:
    """Arm the background scrape thread (idempotent; daemon, so it
    never blocks interpreter exit).  Returns True if a thread was
    started by this call."""
    global _THREAD, _STOP
    with _LOCK:
        _tsan.note_access("telemetry.tsdb.state")
        if _THREAD is not None and _THREAD.is_alive():
            return False
        stop = threading.Event()
        _STOP = stop

        def _loop() -> None:
            while not stop.wait(_INTERVAL_S):
                try:
                    sample_once()
                except Exception:  # a scrape failure skips one sample, never kills the sampler
                    pass

        t = threading.Thread(target=_loop, name="heat-tpu-tsdb", daemon=True)
        _THREAD = t
    t.start()
    return True


def stop_sampler() -> None:
    """Disarm the scrape thread and join it (idempotent)."""
    global _THREAD, _STOP
    with _LOCK:
        _tsan.note_access("telemetry.tsdb.state")
        t, stop = _THREAD, _STOP
        _THREAD = None
        _STOP = None
    if stop is not None:
        stop.set()
    if t is not None and t.is_alive():
        t.join(timeout=5.0)


def sampler_running() -> bool:
    with _LOCK:
        _tsan.note_access("telemetry.tsdb.state", write=False)
        return _THREAD is not None and _THREAD.is_alive()


def series_names() -> List[str]:
    """Every series currently holding points, sorted."""
    with _LOCK:
        _tsan.note_access("telemetry.tsdb.state", write=False)
        return sorted(_RINGS)


def query(series: str, window_s: Optional[float] = None) -> List[Tuple[float, float]]:
    """The retained ``(ts, value)`` points of one series, oldest first,
    optionally trimmed to the trailing ``window_s`` seconds."""
    with _LOCK:
        _tsan.note_access("telemetry.tsdb.state", write=False)
        ring = _RINGS.get(series)
        points = list(ring) if ring is not None else []
    if window_s is not None and points:
        cutoff = points[-1][0] - float(window_s)
        points = [p for p in points if p[0] >= cutoff]
    return points


def window_stats(series: str, window_s: Optional[float] = None) -> Dict[str, Any]:
    """Summary of one series' trailing window — the shape controllers
    embed into journal evidence: ``{series, window_s, n, min, max,
    mean, first, last}`` (empty window → n=0, values None)."""
    points = query(series, window_s)
    if not points:
        return {"series": series, "window_s": window_s, "n": 0, "min": None,
                "max": None, "mean": None, "first": None, "last": None}
    vals = [v for _, v in points]
    return {
        "series": series,
        "window_s": window_s,
        "n": len(vals),
        "min": min(vals),
        "max": max(vals),
        "mean": sum(vals) / len(vals),
        "first": vals[0],
        "last": vals[-1],
    }


def queryz_report(
    series: Optional[Sequence[str]] = None,
    window_s: Optional[float] = None,
) -> Dict[str, Any]:
    """The machine form of ``/queryz``: per-series points + window
    summary for the requested series (default: every retained one)."""
    names = list(series) if series else series_names()
    out: Dict[str, Any] = {
        "timestamp": time.time(),
        "interval_s": _INTERVAL_S,
        "retention": _RETENTION,
        "sampler_running": sampler_running(),
        "allowlist": list(allowed_series()),
        "series": {},
    }
    for name in names:
        pts = query(name, window_s)
        stats = window_stats(name, window_s)
        out["series"][name] = {
            "points": [[round(t, 3), v] for t, v in pts],
            "stats": {k: stats[k] for k in ("n", "min", "max", "mean", "last")},
        }
    return out


def tsdb_snapshot(max_points: int = 32) -> Dict[str, Any]:
    """Compact history for crash bundles: the newest ``max_points`` of
    every retained series."""
    out: Dict[str, Any] = {"interval_s": _INTERVAL_S, "retention": _RETENTION,
                           "series": {}}
    for name in series_names():
        pts = query(name)[-max_points:]
        out["series"][name] = [[round(t, 3), v] for t, v in pts]
    return out


_SPARK = "▁▂▃▄▅▆▇█"


def _sparkline(vals: Sequence[float], width: int = 40) -> str:
    if not vals:
        return ""
    vals = list(vals)[-width:]
    lo, hi = min(vals), max(vals)
    span = (hi - lo) or 1.0
    return "".join(
        _SPARK[min(len(_SPARK) - 1, int((v - lo) / span * (len(_SPARK) - 1)))]
        for v in vals
    )


def render_queryz_html(
    series: Optional[Sequence[str]] = None,
    window_s: Optional[float] = None,
) -> str:
    """The human form of ``/queryz``: one row per series with its
    trailing-window stats and a unicode sparkline."""
    import html as _html

    def esc(v) -> str:
        return _html.escape(str(v), quote=True)

    rep = queryz_report(series, window_s)
    parts = [
        "<html><head><title>/queryz</title><style>"
        "table{border-collapse:collapse}td,th{border:1px solid #999;"
        "padding:3px 6px;font:12px monospace}</style></head><body>",
        "<h1>/queryz — embedded metric history</h1>",
        f"<p>sampler {'running' if rep['sampler_running'] else 'stopped'} · "
        f"interval {esc(rep['interval_s'])}s · retention {esc(rep['retention'])} "
        f"points · allowlist {esc(', '.join(rep['allowlist']))}</p>",
    ]
    if rep["series"]:
        parts.append(
            "<table><tr><th>series</th><th>n</th><th>min</th><th>max</th>"
            "<th>mean</th><th>last</th><th>trend</th></tr>"
        )
        for name in sorted(rep["series"]):
            doc = rep["series"][name]
            st = doc["stats"]

            def fmt(v):
                return "—" if v is None else esc(round(v, 6))

            vals = [p[1] for p in doc["points"]]
            parts.append(
                f"<tr><td><a href='/queryz?series={esc(name)}'>{esc(name)}</a>"
                f"</td><td>{esc(st['n'])}</td><td>{fmt(st['min'])}</td>"
                f"<td>{fmt(st['max'])}</td><td>{fmt(st['mean'])}</td>"
                f"<td>{fmt(st['last'])}</td><td>{esc(_sparkline(vals))}</td></tr>"
            )
        parts.append("</table>")
    else:
        parts.append("<p>(no series retained — is the sampler armed?)</p>")
    parts.append("</body></html>")
    return "".join(parts)
