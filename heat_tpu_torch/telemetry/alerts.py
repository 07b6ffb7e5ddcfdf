"""Alert/event subsystem: deduplicated fired/resolved quality events
(counterpart of heat_tpu/telemetry/alerts.py).

The SLO monitors (:mod:`~heat_tpu_torch.telemetry.slo`) and drift checks
(:mod:`~heat_tpu_torch.telemetry.sketch`) need somewhere to *put* a verdict —
"this replica is burning its latency budget", "this model's input
distribution left its baseline" — that an operator (or the serving layer's
canary auto-promote) can consume without scraping raw metrics.  This
module is that sink:

* an **active table** of currently-firing alerts, deduplicated by
  ``(name, labels)`` — re-firing an already-active alert only refreshes
  its observed value, it never produces a second event;
* a bounded **event ring** (``HEAT_TPU_ALERT_RING``) recording only the
  *transitions* — ``fired`` and ``resolved`` — so a flapping monitor
  produces a readable timeline instead of a firehose;
* each alert carries a **severity** (``page`` > ``warn`` > ``info``),
  the observed value vs its threshold, and — when the firing monitor
  could find one — the nearest **exemplar trace_id**, the link from an
  aggregate verdict back to one concrete request retained in
  ``/tracez``.

Alerts surface on ``/sloz`` / ``/driftz`` / ``/statusz``, travel in
cross-worker snapshots (``aggregate.tag_snapshot`` ships them;
``merge_snapshots`` folds every worker's view into one deterministic
timeline), and land in crash flight-recorder bundles rendered by the
inspect CLI.

Thread-safety: monitors fire from the SLO tick thread, drift checks
from batcher threads, and readers are HTTP handler threads — every
structure below is only touched under the registered
``telemetry.alerts`` lock.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..core import _env
from ..analysis import tsan as _tsan
from ..analysis.protocols import ACTOR_ALERTS, ALERT_FIRE, ALERT_RESOLVE
from . import journal as _journal
from . import metrics as _metrics

__all__ = [
    "Alert",
    "SEVERITIES",
    "active_alerts",
    "alert_events",
    "alerts_snapshot",
    "clear_alerts",
    "fire",
    "is_firing",
    "merge_alert_snapshots",
    "resolve",
]

#: severities in escalation order (index = rank; higher is worse)
SEVERITIES = ("info", "warn", "page")

# read through the knob registry (core/_env.py)
_RING_SIZE = _env.env_int("HEAT_TPU_ALERT_RING")

_FIRED_C = _metrics.counter("alerts.fired", "alert fired transitions recorded")
_RESOLVED_C = _metrics.counter("alerts.resolved", "alert resolved transitions recorded")
_ACTIVE_G = _metrics.gauge("alerts.active", "alerts currently firing")


class Alert:
    """One deduplicated alert: identity, severity, live state.

    ``key`` is the dedup identity: the alert name plus its sorted
    labels.  ``value``/``threshold`` are the monitor's observed number
    vs its objective at the last (re-)fire; ``trace_id`` the nearest
    exemplar the monitor could attach."""

    __slots__ = ("name", "labels", "severity", "message", "value",
                 "threshold", "trace_id", "fired_ts", "updated_ts")

    def __init__(
        self,
        name: str,
        labels: Dict[str, str],
        severity: str,
        message: str,
        value: Optional[float],
        threshold: Optional[float],
        trace_id: Optional[str],
        fired_ts: float,
    ):
        self.name = name
        self.labels = dict(labels)
        self.severity = severity
        self.message = message
        self.value = value
        self.threshold = threshold
        self.trace_id = trace_id
        self.fired_ts = fired_ts
        self.updated_ts = fired_ts

    @property
    def key(self) -> str:
        return alert_key(self.name, self.labels)

    def doc(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "labels": dict(sorted(self.labels.items())),
            "severity": self.severity,
            "message": self.message,
            "value": self.value,
            "threshold": self.threshold,
            "trace_id": self.trace_id,
            "fired_ts": self.fired_ts,
            "updated_ts": self.updated_ts,
        }


def alert_key(name: str, labels: Optional[Dict[str, str]] = None) -> str:
    """The dedup identity of an alert: ``name{k=v,...}`` (keys sorted)."""
    if not labels:
        return name
    inner = ",".join(f"{k}={v}" for k, v in sorted(labels.items()))
    return f"{name}{{{inner}}}"


#: active table + transition ring, both under the registered lock
_LOCK = _tsan.register_lock("telemetry.alerts")
_ACTIVE: Dict[str, Alert] = {}
_EVENTS: "deque[Dict[str, Any]]" = deque(maxlen=max(1, _RING_SIZE))


def refresh_env() -> None:
    """Re-read ``HEAT_TPU_ALERT_RING`` (tests that flip the env
    mid-process); resizes the event ring, keeping the newest events."""
    global _RING_SIZE, _EVENTS
    _RING_SIZE = _env.env_int("HEAT_TPU_ALERT_RING")
    with _LOCK:
        _tsan.note_access("telemetry.alerts.state")
        _EVENTS = deque(_EVENTS, maxlen=max(1, _RING_SIZE))


def fire(
    name: str,
    severity: str = "warn",
    message: str = "",
    value: Optional[float] = None,
    threshold: Optional[float] = None,
    trace_id: Optional[str] = None,
    labels: Optional[Dict[str, str]] = None,
    cause: Optional[str] = None,
    evidence: Optional[Dict[str, Any]] = None,
) -> bool:
    """Fire (or refresh) an alert; returns True on the fired *transition*.

    A first fire for ``(name, labels)`` records a ``fired`` event in the
    ring and counts in ``alerts.fired``; re-firing an active alert only
    updates its observed value/message/exemplar (dedup — no event).

    The fired transition also lands in the control-plane **decision
    journal** (actor ``alerts``, action ``fire``), carrying the firing
    monitor's ``evidence`` — by convention the exact metric values it
    compared plus the TSDB ``series`` names whose samples are
    resolvable via ``/queryz`` — and an optional ``cause`` event_id
    linking this alert to the upstream decision that provoked it."""
    if severity not in SEVERITIES:
        raise ValueError(f"severity must be one of {SEVERITIES}, got {severity!r}")
    key = alert_key(name, labels)
    now = time.time()
    with _LOCK:
        _tsan.note_access("telemetry.alerts.state")
        a = _ACTIVE.get(key)
        if a is not None:
            a.value = value
            a.message = message or a.message
            a.severity = severity
            a.updated_ts = now
            if trace_id is not None:
                a.trace_id = trace_id
            return False
        a = Alert(
            name, labels or {}, severity, message, value, threshold,
            trace_id, now,
        )
        _ACTIVE[key] = a
        _EVENTS.append(dict(a.doc(), event="fired", ts=now))
        _ACTIVE_G.set(len(_ACTIVE))
    _FIRED_C.inc()
    # journal after the alert lock is released: emit takes the journal
    # lock (and may append a durable segment) — never nested under ours
    ev = {"alert": key, "value": value, "threshold": threshold}
    ev.update(evidence or {})
    _journal.emit(
        ACTOR_ALERTS, ALERT_FIRE,
        model=(labels or {}).get("model"),
        tenant=(labels or {}).get("tenant"),
        severity=severity,
        message=message or f"alert {key} fired",
        cause=cause,
        trace_id=trace_id,
        evidence=ev,
    )
    return True


def resolve(name: str, labels: Optional[Dict[str, str]] = None) -> bool:
    """Resolve an active alert; returns True on the resolved
    *transition* (False when it was not firing — resolving is
    idempotent, quiet monitors can call it every tick).  The resolved
    transition is journaled (actor ``alerts``, action ``resolve``) with
    its cause linked back to the retained fire event, so an incident's
    timeline shows how long the condition held."""
    key = alert_key(name, labels)
    now = time.time()
    with _LOCK:
        _tsan.note_access("telemetry.alerts.state")
        a = _ACTIVE.pop(key, None)
        if a is None:
            return False
        doc = a.doc()
        active_s = round(now - a.fired_ts, 3)
        _EVENTS.append(dict(doc, event="resolved", ts=now, active_s=active_s))
        _ACTIVE_G.set(len(_ACTIVE))
    _RESOLVED_C.inc()
    fired_id = None
    for e in reversed(_journal.journal_events()):
        if (e.get("actor") == "alerts" and e.get("action") == "fire"
                and (e.get("evidence") or {}).get("alert") == key):
            fired_id = e.get("event_id")
            break
    _journal.emit(
        ACTOR_ALERTS, ALERT_RESOLVE,
        model=doc["labels"].get("model"),
        tenant=doc["labels"].get("tenant"),
        severity="info",
        message=f"alert {key} resolved after {active_s}s",
        cause=fired_id,
        trace_id=doc.get("trace_id"),
        evidence={"alert": key, "active_s": active_s},
    )
    return True


def is_firing(name: str, labels: Optional[Dict[str, str]] = None) -> bool:
    """Whether the alert is currently active."""
    with _LOCK:
        _tsan.note_access("telemetry.alerts.state", write=False)
        return alert_key(name, labels) in _ACTIVE


def active_alerts() -> List[Dict[str, Any]]:
    """Currently-firing alerts, worst severity first then by key."""
    with _LOCK:
        _tsan.note_access("telemetry.alerts.state", write=False)
        docs = [a.doc() for a in _ACTIVE.values()]
    return sorted(
        docs, key=lambda d: (-SEVERITIES.index(d["severity"]), d["name"],
                             tuple(sorted(d["labels"].items())))
    )


def alert_events(limit: Optional[int] = None) -> List[Dict[str, Any]]:
    """The transition ring, oldest first (``limit`` trims to the newest)."""
    with _LOCK:
        _tsan.note_access("telemetry.alerts.state", write=False)
        events = list(_EVENTS)
    return events[-limit:] if limit else events


def alerts_snapshot() -> Dict[str, Any]:
    """Active table + transition ring as one JSON-safe document — the
    form that travels in cross-worker snapshots and crash bundles."""
    return {
        "ring": _RING_SIZE,
        "active": active_alerts(),
        "events": alert_events(),
    }


def clear_alerts() -> None:
    """Drop every active alert and ring event (tests, ``reset_all``)."""
    with _LOCK:
        _tsan.note_access("telemetry.alerts.state")
        _ACTIVE.clear()
        _EVENTS.clear()
        _ACTIVE_G.set(0)


def merge_alert_snapshots(
    tagged: Sequence[Tuple[str, Dict[str, Any]]]
) -> Dict[str, Any]:
    """Fold per-worker alert snapshots into one deterministic view.

    ``tagged`` is ``[(worker_index, alerts_snapshot_doc), ...]``.
    Active alerts union by ``(key, worker)`` — the same SLO firing on
    two workers stays two rows, because it *is* two replicas burning
    budget; events interleave ordered by ``(ts, worker)``.  Pure
    function of its inputs (``aggregate.merge_snapshots`` calls it)."""
    active: List[Dict[str, Any]] = []
    events: List[Dict[str, Any]] = []
    for ix, snap in sorted(tagged, key=lambda t: str(t[0])):
        for a in (snap or {}).get("active") or []:
            active.append(dict(a, worker=str(ix)))
        for e in (snap or {}).get("events") or []:
            events.append(dict(e, worker=str(ix)))
    active.sort(
        key=lambda d: (-SEVERITIES.index(d.get("severity", "info")),
                       d.get("name", ""), d.get("worker", ""))
    )
    events.sort(key=lambda e: (e.get("ts", 0.0), e.get("worker", ""),
                               e.get("name", "")))
    return {
        "active": active,
        "events": events,
        "active_count": len(active),
        "worst_severity": active[0]["severity"] if active else None,
    }
