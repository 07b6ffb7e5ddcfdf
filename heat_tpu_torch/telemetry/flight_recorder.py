"""Crash flight recorder: an atomic forensic bundle on unhandled failure
(counterpart of heat_tpu/telemetry/flight_recorder.py).

A crashed fit today leaves a traceback on stderr and nothing else — the
span ring, the metrics registry and the dispatch-cache state die with
the process, which is exactly the evidence that explains *why* it
crashed.  With ``HEAT_TPU_FLIGHT_RECORDER=<dir>`` (or an explicit
:func:`install` call) an excepthook writes a single JSON **crash
bundle** into ``<dir>`` on any unhandled exception — including
``PermanentFault`` and ``DivergenceError``, the resilience layer's
terminal verdicts — through the resilience atomic+CRC32 writer, so the
bundle itself can never be torn and a reader can verify it.

One bundle carries everything the post-mortem needs::

    exception   type / message / formatted traceback
    metrics     full registry snapshot (comm bytes, compile time, ...)
    spans       the span ring (what the process was doing, in order)
    traces      the tail-sampled trace store: requests IN FLIGHT at
                crash time (full span trees) + retained slow/shed/error
                traces (see docs/observability.md, /tracez)
    alerts      active alerts + the fired/resolved transition ring
                (was an SLO burning or a model drifting when it died?)
    slo         every registered objective's last burn-rate verdict
    drift       per-model input-drift scores vs their baselines
    canary      the canary decision plane: per-model shadow evidence
                windows, decision history, veto reasons, retained events
    observatory the roofline execution ledger + the last HBM watermark
                sample vs the static prediction + calibration provenance
    journal     the decision journal's hot ring: the control-plane
                actions (scale, rollback, preempt, reshard) that led
                into the crash, each with causal link + evidence
    tsdb        the embedded metric history's retained windows — the
                exact samples the journaled decisions cite
    knobs       every registered HEAT_TPU_* knob's effective value
    dispatch    cache stats + keys + per-executable cost accounting
    checkpoint  last durable step (where a resume would restart)
    runtime     python/torch/CUDA/device/version info

Pretty-print one with::

    python -m heat_tpu_torch.telemetry.inspect <bundle.json>

The hook chains to the previous ``sys.excepthook`` (the traceback still
prints), ``threading.excepthook`` is wrapped the same way (a crashed
checkpoint-writer thread is exactly a case worth a bundle), and bundle
writing is best-effort: a failure to write can never mask the original
exception.  ``KeyboardInterrupt``/``SystemExit`` are not crashes and do
not record.
"""

from __future__ import annotations

import os
import sys
import threading
import time
import traceback as _traceback
from typing import Any, Dict, Optional

from ..core import _env
from ..analysis import tsan as _tsan
from . import metrics as _metrics
from . import spans as _spans
from . import tracing as _tracing

__all__ = [
    "BUNDLE_SCHEMA",
    "dump_bundle",
    "install",
    "installed",
    "last_bundle_path",
    "maybe_install_from_env",
    "uninstall",
]

#: bundle schema version; bump on breaking layout changes so
#: ``telemetry.inspect`` can refuse bundles it cannot render
BUNDLE_SCHEMA = 1

#: install/uninstall state of the excepthooks
_LOCK = _tsan.register_lock("telemetry.flight_recorder.hooks")
#: serializes bundle writes: two threads crashing concurrently each get
#: their own bundle (distinct thread-id suffixes) written one at a time
#: instead of racing on a shared path; also guards _LAST_PATH
_DUMP_LOCK = _tsan.register_lock("telemetry.flight_recorder.dump")
_DIR: Optional[str] = None
_PREV_SYS_HOOK = None
_PREV_THREAD_HOOK = None
_LAST_PATH: Optional[str] = None

_BUNDLES = _metrics.counter(
    "flight.bundles_written", "crash bundles written by the flight recorder"
)


def installed() -> bool:
    """Whether the crash excepthook is active."""
    return _DIR is not None


def last_bundle_path() -> Optional[str]:
    """Path of the most recently written bundle (None before the first)."""
    return _LAST_PATH


def install(directory: Optional[str] = None) -> str:
    """Arm the flight recorder; returns the bundle directory.

    ``directory=None`` reads ``HEAT_TPU_FLIGHT_RECORDER``.  Idempotent —
    a second install only updates the directory."""
    global _DIR, _PREV_SYS_HOOK, _PREV_THREAD_HOOK
    if directory is None:
        directory = _env.env_str("HEAT_TPU_FLIGHT_RECORDER")
    if not directory:
        raise ValueError(
            "flight recorder needs a bundle directory (argument or "
            "HEAT_TPU_FLIGHT_RECORDER)"
        )
    with _LOCK:
        first = _DIR is None
        _DIR = str(directory)
        if first:
            _PREV_SYS_HOOK = sys.excepthook
            sys.excepthook = _sys_hook
            _PREV_THREAD_HOOK = getattr(threading, "excepthook", None)
            if _PREV_THREAD_HOOK is not None:
                threading.excepthook = _thread_hook
    return _DIR


def uninstall() -> None:
    """Disarm and restore the previous hooks (no-op when not armed)."""
    global _DIR, _PREV_SYS_HOOK, _PREV_THREAD_HOOK
    with _LOCK:
        if _DIR is None:
            return
        _DIR = None
        if _PREV_SYS_HOOK is not None:
            sys.excepthook = _PREV_SYS_HOOK
            _PREV_SYS_HOOK = None
        if _PREV_THREAD_HOOK is not None:
            threading.excepthook = _PREV_THREAD_HOOK
            _PREV_THREAD_HOOK = None


def maybe_install_from_env() -> Optional[str]:
    """Arm iff ``HEAT_TPU_FLIGHT_RECORDER`` names a directory (called
    once at ``heat_tpu_torch.telemetry`` import)."""
    directory = _env.env_str("HEAT_TPU_FLIGHT_RECORDER")
    if not directory:
        return None
    return install(directory)


# ----------------------------------------------------------------------
# bundle construction
# ----------------------------------------------------------------------
def _knob_values() -> Dict[str, Any]:
    try:
        out = {}
        for name in sorted(_env.KNOBS):
            raw = os.environ.get(name)
            out[name] = {
                "value": raw if raw is not None else _env.KNOBS[name][1],
                "set": raw is not None,
            }
        return out
    except Exception:  # forensics degrade field-by-field, never abort the bundle
        return {}


def _dispatch_state() -> Optional[Dict[str, Any]]:
    try:
        from ..core import dispatch

        return {
            "stats": dispatch.cache_stats(),
            "cache_keys": dispatch.cache_keys(),
            "cost": dispatch.cost_summary(),
        }
    except Exception:  # forensics degrade field-by-field, never abort the bundle
        return None


def _span_dump() -> list:
    return [
        {
            "name": r.name,
            "start_ns": r.start_ns,
            "duration_ns": r.duration_ns,
            "thread_id": r.thread_id,
            "depth": r.depth,
            "trace_id": r.trace_id,
            "span_id": r.span_id,
            "parent_id": r.parent_id,
            "attrs": {k: str(v) for k, v in r.attrs.items()},
        }
        for r in _spans.get_spans()
    ]


def _traces_state() -> Optional[Dict[str, Any]]:
    """The tail store at crash time — the requests in flight (full span
    trees: what the process was *serving* when it died) plus the
    retained recent/slowest/shed-or-errored classes."""
    try:
        return _tracing.traces_snapshot()
    except Exception:  # forensics degrade field-by-field, never abort the bundle
        return None


def _alerts_state() -> Optional[Dict[str, Any]]:
    """Active alerts + the transition ring at crash time — whether a
    quality signal was already screaming before the process died."""
    try:
        from . import alerts as _alerts

        return _alerts.alerts_snapshot()
    except Exception:  # forensics degrade field-by-field, never abort the bundle
        return None


def _slo_state() -> Optional[Dict[str, Any]]:
    try:
        from . import slo as _slo

        return _slo.slo_report()
    except Exception:  # forensics degrade field-by-field, never abort the bundle
        return None


def _drift_state() -> Optional[Dict[str, Any]]:
    try:
        from . import sketch as _sketch

        return _sketch.drift_report()
    except Exception:  # forensics degrade field-by-field, never abort the bundle
        return None


def _canary_state() -> Optional[Dict[str, Any]]:
    """The canary decision plane at crash time — decision history, the
    live evidence window and veto reasons: whether a version swap was in
    flight (or just landed) when the process died.  Only read when the
    serving layer is already resident; a fit-only crash must not import
    the serving stack mid-crash."""
    try:
        cmod = sys.modules.get("heat_tpu_torch.serving.canary")
        return cmod.canary_snapshot() if cmod is not None else None
    except Exception:  # forensics degrade field-by-field, never abort the bundle
        return None


def _analysis_state() -> Optional[Dict[str, Any]]:
    """Recent program-lint diagnostics + the static peak-HBM estimate
    table — was the crash an OOM the J301 budget predicted?"""
    try:
        from ..analysis import diagnostics as _adiag
        from ..analysis import memory_model as _amem

        return {
            "mode": _adiag.analysis_mode(),
            "recent_diagnostics": [
                {"rule": d.rule, "location": d.location,
                 "message": d.message, "details": d.details}
                for d in _adiag.recent_diagnostics()[-20:]
            ],
            "hbm": _amem.peak_summary(),
        }
    except Exception:  # forensics degrade field-by-field, never abort the bundle
        return None


def _observatory_state() -> Optional[Dict[str, Any]]:
    """The roofline observatory at crash time: execution ledger (was a
    kernel suddenly slow?), the last HBM watermark sample vs the static
    prediction (was this an OOM the watermark saw coming?), and the
    calibration provenance.  Never calibrates — a crash dump must not
    run device kernels."""
    try:
        from . import observatory as _observatory

        return _observatory.snapshot(calibrate=False)
    except Exception:  # forensics degrade field-by-field, never abort the bundle
        return None


def _elastic_state() -> Optional[Dict[str, Any]]:
    """World size + loss/reshape counters at crash time — the first
    question a preemption postmortem asks."""
    try:
        from ..elastic.supervisor import elastic_state

        return elastic_state()
    except Exception:  # bundle section degrades, the crash dump must land
        return None


def _journal_state() -> Optional[Dict[str, Any]]:
    """The decision journal's hot ring at crash time — the control-plane
    actions (scale, rollback, preempt, reshard) that led INTO the crash,
    each with its causal link and evidence."""
    try:
        from . import journal as _journal

        return _journal.decisionz_report(limit=128)
    except Exception:  # forensics degrade field-by-field, never abort the bundle
        return None


def _tsdb_state() -> Optional[Dict[str, Any]]:
    """The embedded metric history's retained windows at crash time —
    the exact samples the journaled decisions cite as evidence."""
    try:
        from . import tsdb as _tsdb

        return _tsdb.tsdb_snapshot(max_points=64)
    except Exception:  # forensics degrade field-by-field, never abort the bundle
        return None


def build_bundle(
    exc: Optional[BaseException] = None,
    reason: str = "manual",
) -> Dict[str, Any]:
    """The bundle document (pure construction, no IO)."""
    from .server import _runtime_info  # same probe the /statusz page uses

    ck_ts = float(_metrics.gauge("checkpoint.last_step_ts").value or 0.0)
    doc: Dict[str, Any] = {
        "schema": BUNDLE_SCHEMA,
        "reason": reason,
        "timestamp": time.time(),
        "pid": os.getpid(),
        "exception": None,
        "knobs": _knob_values(),
        "metrics": _metrics.snapshot(),
        "spans": _span_dump(),
        "traces": _traces_state(),
        "alerts": _alerts_state(),
        "slo": _slo_state(),
        "drift": _drift_state(),
        "canary": _canary_state(),
        "dispatch": _dispatch_state(),
        "checkpoint": {
            "last_step": int(_metrics.gauge("checkpoint.last_step").value)
            if ck_ts > 0.0
            else None,
            "last_step_ts": ck_ts or None,
        },
        "tsan": {
            "mode": _tsan.mode(),
            "findings": _tsan.findings(),
        },
        "analysis": _analysis_state(),
        "observatory": _observatory_state(),
        "elastic": _elastic_state(),
        "journal": _journal_state(),
        "tsdb": _tsdb_state(),
        "runtime": _runtime_info(),
    }
    if exc is not None:
        doc["exception"] = {
            "type": type(exc).__name__,
            "message": str(exc),
            "traceback": _traceback.format_exception(type(exc), exc, exc.__traceback__),
            "site": getattr(exc, "site", None),
            "iteration": getattr(exc, "iteration", None),
        }
    return doc


def dump_bundle(
    exc: Optional[BaseException] = None,
    reason: str = "manual",
    directory: Optional[str] = None,
) -> str:
    """Write one crash bundle (atomic + CRC sidecar); returns its path.

    Public so a caller that *catches* a terminal fault (and therefore
    keeps the excepthook from ever seeing it) can still record the
    forensics before degrading.

    Re-entrancy-safe: two threads crashing concurrently serialize on the
    registered dump lock and write one bundle each — the path carries
    the crashing thread's id, so neither can clobber the other's
    evidence even within the same millisecond."""
    import json

    from ..resilience.atomic import atomic_write

    global _LAST_PATH
    directory = directory or _DIR
    if not directory:
        raise ValueError("flight recorder not installed and no directory given")
    doc = build_bundle(exc, reason=reason)
    path = os.path.join(
        directory,
        f"flight_{int(doc['timestamp'] * 1e3)}_{os.getpid()}"
        f"_t{threading.get_ident()}.json",
    )
    with _DUMP_LOCK:
        _tsan.note_access("telemetry.flight_recorder.state")
        with atomic_write(path) as tmp:
            with open(tmp, "w") as f:
                json.dump(doc, f, indent=1, default=str)
        _LAST_PATH = path
    _BUNDLES.inc()
    return path


# ----------------------------------------------------------------------
# hooks
# ----------------------------------------------------------------------
def _record(exc: Optional[BaseException], reason: str) -> None:
    if exc is None or isinstance(exc, (KeyboardInterrupt, SystemExit)):
        return
    try:
        dump_bundle(exc, reason=reason)
    except Exception:  # a bundle-write failure must never mask the crash itself
        pass


def _sys_hook(exc_type, exc, tb):
    _record(exc, reason="unhandled_exception")
    prev = _PREV_SYS_HOOK or sys.__excepthook__
    prev(exc_type, exc, tb)


def _thread_hook(args):  # pragma: no cover - exercised via subprocess tests
    _record(args.exc_value, reason=f"thread_crash:{getattr(args.thread, 'name', '?')}")
    if _PREV_THREAD_HOOK is not None:
        _PREV_THREAD_HOOK(args)
