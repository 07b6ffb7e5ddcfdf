"""Control-plane decision journal: every autonomous action, explainable
(counterpart of heat_tpu/telemetry/journal.py).

The one sink every controller reports into:

* a typed :class:`DecisionEvent` — event_id, wall + monotonic
  timestamps, the **actor** (which controller) and **action** (what it
  did), the model/tenant it acted on, an optional **cause** event_id
  (the upstream decision that triggered this one), the nearest exemplar
  ``trace_id``, and an **evidence** dict carrying the exact metric
  values the controller saw;
* a bounded **hot ring** (``HEAT_TPU_JOURNAL_RING``) for live reports,
  snapshots and crash bundles;
* a **durable append-only segment log** (``HEAT_TPU_JOURNAL_DIR``):
  immutable ``journal-<start:012d>-<count:08d>.jsonl`` segments
  committed by atomic rename with CRC32 sidecars, the start offset
  resumed from the committed filenames — so a restarted process appends
  after its predecessor and :func:`read_journal` reconstructs the full
  timeline from the directory alone.

The entry format, the segment names and the sidecars are the
reference's: a journal written by either package is read, and verified,
by the other.  Every emit is stepped through the declared protocols
(:mod:`heat_tpu_torch.analysis.conformance`).

Thread-safety: controllers emit from their own threads while readers
read — every structure below is only touched under the registered
``telemetry.journal`` lock; the durable segment write runs under it too
(control-plane decision rates are a few events per incident, not a hot
path).
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..analysis import conformance as _conformance
from ..analysis import tsan as _tsan
from . import metrics as _metrics

__all__ = [
    "DecisionEvent",
    "causal_chain",
    "decisionz_report",
    "emit",
    "find_last",
    "get_event",
    "journal_dir",
    "journal_events",
    "journal_snapshot",
    "merge_journal_snapshots",
    "read_journal",
    "refresh_env",
    "render_decisionz_html",
    "reset_journal",
    "set_journal_dir",
]

# knobs read from the environment directly, with the reference's defaults
_RING_SIZE = int(os.environ.get("HEAT_TPU_JOURNAL_RING", "256"))
_DIR: Optional[str] = os.environ.get("HEAT_TPU_JOURNAL_DIR") or None

_EMITTED_C = _metrics.counter("journal.events", "decision-journal events emitted")
_SEGMENTS_C = _metrics.counter(
    "journal.segments_written", "durable decision-journal segments committed"
)

#: durable segment names: ``journal-<start seq:012d>-<count:08d>.jsonl``
#: (the streaming segment-log naming scheme; the committed filenames ARE
#: the index, so a fresh process derives the next sequence number from a
#: directory listing alone)
_SEGMENT_RE = re.compile(r"^journal-(\d{12})-(\d{8})\.jsonl$")


class DecisionEvent:
    """One autonomous control-plane decision, causally linkable.

    ``event_id`` is unique across restarts and replicas (process epoch +
    sequence); ``cause`` is the ``event_id`` of the upstream decision
    that triggered this one (None for a root event); ``evidence`` holds
    the exact metric values the controller saw when it decided —
    including, by convention, a ``series`` list naming the TSDB series
    whose samples are resolvable via ``/queryz``."""

    __slots__ = ("event_id", "seq", "ts", "mono", "actor", "action", "model",
                 "tenant", "severity", "message", "cause", "trace_id",
                 "evidence")

    def __init__(self, event_id: str, seq: int, ts: float, mono: float,
                 actor: str, action: str, model: Optional[str],
                 tenant: Optional[str], severity: str, message: str,
                 cause: Optional[str], trace_id: Optional[str],
                 evidence: Dict[str, Any]):
        self.event_id = event_id
        self.seq = seq
        self.ts = ts
        self.mono = mono
        self.actor = actor
        self.action = action
        self.model = model
        self.tenant = tenant
        self.severity = severity
        self.message = message
        self.cause = cause
        self.trace_id = trace_id
        self.evidence = evidence

    def doc(self) -> Dict[str, Any]:
        return {
            "event_id": self.event_id,
            "seq": self.seq,
            "ts": self.ts,
            "mono": self.mono,
            "actor": self.actor,
            "action": self.action,
            "model": self.model,
            "tenant": self.tenant,
            "severity": self.severity,
            "message": self.message,
            "cause": self.cause,
            "trace_id": self.trace_id,
            "evidence": self.evidence,
        }


#: hot ring + durable-writer cursor, both under the registered lock.
#: The process epoch makes event_ids unique across restarts sharing one
#: journal directory (replay merges incarnations by event_id).
_LOCK = _tsan.register_lock("telemetry.journal")
_EVENTS: "deque[DecisionEvent]" = deque(maxlen=max(1, _RING_SIZE))
_EPOCH = f"{os.getpid():x}-{int(time.time() * 1000):x}"
_SEQ = 0
_NEXT_START: Optional[int] = None  # durable seq cursor; None = dir not scanned


def refresh_env() -> None:
    """Re-read ``HEAT_TPU_JOURNAL_RING`` / ``HEAT_TPU_JOURNAL_DIR``
    (tests that flip the env mid-process); resizes the hot ring keeping
    the newest events and re-anchors the durable writer."""
    global _RING_SIZE, _EVENTS, _DIR, _NEXT_START
    _RING_SIZE = int(os.environ.get("HEAT_TPU_JOURNAL_RING", "256"))
    with _LOCK:
        _tsan.note_access("telemetry.journal.state")
        _EVENTS = deque(_EVENTS, maxlen=max(1, _RING_SIZE))
        _DIR = os.environ.get("HEAT_TPU_JOURNAL_DIR") or None
        _NEXT_START = None


def set_journal_dir(directory: Optional[str]) -> None:
    """Arm (or disarm, with None) the durable journal programmatically —
    the non-env path tests and embedding services use."""
    global _DIR, _NEXT_START
    with _LOCK:
        _tsan.note_access("telemetry.journal.state")
        _DIR = str(directory) if directory else None
        _NEXT_START = None


def journal_dir() -> Optional[str]:
    """The armed durable-journal directory (None = hot ring only)."""
    with _LOCK:
        _tsan.note_access("telemetry.journal.state", write=False)
        return _DIR


def reset_journal() -> None:
    """Drop the hot ring and re-anchor the durable cursor (tests).  The
    durable directory's committed segments are never deleted — they are
    the record."""
    global _SEQ, _NEXT_START
    with _LOCK:
        _tsan.note_access("telemetry.journal.state")
        _EVENTS.clear()
        _SEQ = 0
        _NEXT_START = None
    # a fresh journal means fresh controllers: the protocol conformance
    # checker forgets its tracked machine instances too (outside our
    # lock — it takes its own leaf lock)
    _conformance.reset_conformance()


def _scan_next_start_locked(directory: str) -> int:
    """Next durable sequence number: end offset derived from the
    committed segment filenames (caller holds the lock)."""
    end = 0
    try:
        names = os.listdir(directory)
    except OSError:
        return 0
    for name in names:
        m = _SEGMENT_RE.match(name)
        if m:
            end = max(end, int(m.group(1)) + int(m.group(2)))
    return end


def _append_durable_locked(ev: DecisionEvent) -> None:
    """Commit one event as an immutable single-event segment (caller
    holds the lock).  Atomic rename + CRC sidecar via the resilience
    writer — a reader (or the replay CLI) can observe a committed
    segment or nothing, never a torn line."""
    global _NEXT_START
    directory = _DIR
    if not directory:
        return
    # lazy import: resilience imports telemetry.metrics at its top
    from ..resilience.atomic import atomic_write

    os.makedirs(directory, exist_ok=True)
    if _NEXT_START is None:
        _NEXT_START = _scan_next_start_locked(directory)
    path = os.path.join(
        directory, f"journal-{_NEXT_START:012d}-{1:08d}.jsonl"
    )
    with atomic_write(path, fault_site="io.write") as tmp:
        with open(tmp, "w") as f:
            f.write(json.dumps(ev.doc(), default=str) + "\n")
    _NEXT_START += 1
    _SEGMENTS_C.inc()


def emit(
    actor: str,
    action: str,
    model: Optional[str] = None,
    tenant: Optional[str] = None,
    severity: str = "info",
    message: str = "",
    cause: Optional[str] = None,
    trace_id: Optional[str] = None,
    evidence: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """Record one control-plane decision; returns its document (callers
    chain the returned ``event_id`` into downstream ``cause`` links).

    ``evidence`` must be JSON-safe — it is exactly what the controller
    saw when it decided, and it travels verbatim into the durable log,
    snapshots and crash bundles."""
    global _SEQ
    now = time.time()
    mono = time.monotonic()
    with _LOCK:
        _tsan.note_access("telemetry.journal.state")
        _SEQ += 1
        ev = DecisionEvent(
            event_id=f"{_EPOCH}-{_SEQ:06d}",
            seq=_SEQ,
            ts=now,
            mono=mono,
            actor=str(actor),
            action=str(action),
            model=model,
            tenant=tenant,
            severity=str(severity),
            message=str(message),
            cause=cause,
            trace_id=trace_id,
            evidence=dict(evidence or {}),
        )
        _EVENTS.append(ev)
        try:
            _append_durable_locked(ev)
        except Exception:
            pass
    _EMITTED_C.inc()
    doc = ev.doc()
    # protocol conformance hook — one module-global read when off; runs
    # strictly after our lock is released (the reference's violation
    # report fires an alert, which re-enters emit() one level deep)
    _conformance.note_emit(doc)
    return doc


def journal_events(limit: Optional[int] = None) -> List[Dict[str, Any]]:
    """The hot ring, oldest first (``limit`` trims to the newest)."""
    with _LOCK:
        _tsan.note_access("telemetry.journal.state", write=False)
        events = [e.doc() for e in _EVENTS]
    return events[-limit:] if limit else events


def get_event(event_id: str) -> Optional[Dict[str, Any]]:
    """One retained event by id (hot ring only; :func:`read_journal`
    covers the durable log)."""
    with _LOCK:
        _tsan.note_access("telemetry.journal.state", write=False)
        for e in _EVENTS:
            if e.event_id == event_id:
                return e.doc()
    return None


def find_last(
    actor: Optional[str] = None,
    action: Optional[str] = None,
    model: Optional[str] = None,
) -> Optional[Dict[str, Any]]:
    """Newest retained event matching every given field — how a
    downstream controller locates its upstream cause (e.g. the refresh
    driver finding the ``drift:<model>`` alert-fire event)."""
    with _LOCK:
        _tsan.note_access("telemetry.journal.state", write=False)
        for e in reversed(_EVENTS):
            if actor is not None and e.actor != actor:
                continue
            if action is not None and e.action != action:
                continue
            if model is not None and e.model != model:
                continue
            return e.doc()
    return None


def causal_chain(
    event_id: str,
    events: Optional[Sequence[Dict[str, Any]]] = None,
) -> Dict[str, Any]:
    """The "explain" view of one event: its cause chain walked to the
    root (oldest first) plus its direct and transitive effects.

    Pure over ``events`` when given (e.g. :func:`read_journal`'s durable
    log); defaults to the hot ring.  Cycles and dangling cause ids
    terminate the walk instead of looping."""
    pool = list(events) if events is not None else journal_events()
    by_id = {e.get("event_id"): e for e in pool}
    target = by_id.get(event_id)
    if target is None:
        return {"event_id": event_id, "found": False, "chain": [], "effects": []}
    chain: List[Dict[str, Any]] = [target]
    seen = {event_id}
    cur = target
    while cur.get("cause") and cur["cause"] in by_id and cur["cause"] not in seen:
        cur = by_id[cur["cause"]]
        seen.add(cur["event_id"])
        chain.insert(0, cur)
    effects: List[Dict[str, Any]] = []
    frontier = {event_id}
    while frontier:
        nxt = set()
        for e in pool:
            eid = e.get("event_id")
            if e.get("cause") in frontier and eid not in seen:
                effects.append(e)
                seen.add(eid)
                nxt.add(eid)
        frontier = nxt
    effects.sort(key=lambda e: (e.get("ts", 0.0), e.get("event_id", "")))
    return {"event_id": event_id, "found": True, "chain": chain,
            "effects": effects}


# ----------------------------------------------------------------------
# durable log readers (the replay CLI's substrate)
# ----------------------------------------------------------------------
def read_journal(directory: str) -> List[Dict[str, Any]]:
    """Every event in the durable log, checksum-verified, ordered by
    segment sequence then timestamp, deduplicated by ``event_id`` —
    the record a postmortem reads after the process is gone."""
    from ..resilience.atomic import verify_checksum

    segs: List[Tuple[int, int, str]] = []
    if os.path.isdir(directory):
        for name in os.listdir(directory):
            m = _SEGMENT_RE.match(name)
            if m:
                segs.append((int(m.group(1)), int(m.group(2)),
                             os.path.join(directory, name)))
    segs.sort()
    out: List[Dict[str, Any]] = []
    seen: set = set()
    for _start, _count, path in segs:
        verify_checksum(path)
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                ev = json.loads(line)
                eid = ev.get("event_id")
                if eid in seen:
                    continue
                seen.add(eid)
                out.append(ev)
    out.sort(key=lambda e: (e.get("ts", 0.0), e.get("event_id", "")))
    return out


# ----------------------------------------------------------------------
# reports: /decisionz, snapshots, crash bundles, fleet rollup
# ----------------------------------------------------------------------
def decisionz_report(limit: Optional[int] = None) -> Dict[str, Any]:
    """The machine form of ``/decisionz``: the hot ring plus the
    durable-log arming state."""
    with _LOCK:
        _tsan.note_access("telemetry.journal.state", write=False)
        directory = _DIR
    return {
        "timestamp": time.time(),
        "ring": _RING_SIZE,
        "dir": directory,
        "events": journal_events(limit),
    }


def journal_snapshot(limit: int = 64) -> Dict[str, Any]:
    """Compact journal state for cross-worker snapshots and crash
    bundles: the newest retained events."""
    return {"ring": _RING_SIZE, "events": journal_events(limit=limit)}


def merge_journal_snapshots(
    tagged: Sequence[Tuple[str, Optional[Dict[str, Any]]]]
) -> Dict[str, Any]:
    """Fold per-worker journal snapshots into one deterministic fleet
    timeline.  ``tagged`` is ``[(worker_index, journal_snapshot_doc),
    ...]``; events interleave ordered by ``(ts, worker, event_id)`` —
    pure function of its inputs (``aggregate.merge_snapshots`` and the
    fleet router's ``/fleetz`` rollup both call it)."""
    events: List[Dict[str, Any]] = []
    actors: Dict[str, int] = {}
    for ix, snap in sorted(tagged, key=lambda t: str(t[0])):
        for e in (snap or {}).get("events") or []:
            events.append(dict(e, worker=str(ix)))
    events.sort(key=lambda e: (e.get("ts", 0.0), e.get("worker", ""),
                               e.get("event_id", "")))
    for e in events:
        actors[e.get("actor", "?")] = actors.get(e.get("actor", "?"), 0) + 1
    return {
        "events": events,
        "event_count": len(events),
        "actors": dict(sorted(actors.items())),
    }


_SEV_COLOR = {"page": "#ffd6d6", "warn": "#ffe9c6", "info": ""}


def _evidence_summary(ev: Dict[str, Any], max_len: int = 160) -> str:
    parts = []
    for k in sorted(ev.get("evidence") or {}):
        v = ev["evidence"][k]
        parts.append(f"{k}={v}")
    s = ", ".join(parts)
    return s if len(s) <= max_len else s[: max_len - 1] + "…"


def _protocol_cell(ann: Optional[Dict[str, Any]], esc) -> str:
    """One table cell describing the event's declared protocol step —
    ``protocol: from → to`` — or the H805 violation it committed."""
    if ann is None:
        return "<td>—</td>"
    if ann.get("ok"):
        return (
            f"<td>{esc(ann.get('protocol'))}: {esc(ann.get('from'))} "
            f"&rarr; {esc(ann.get('to'))}</td>"
        )
    return (
        "<td style='background:#ffd6d6'><b>H805</b> "
        f"{esc(ann.get('message'))}</td>"
    )


def _event_rows_html(
    events: List[Dict[str, Any]],
    esc,
    annotations: Optional[Dict[str, Dict[str, Any]]] = None,
) -> List[str]:
    proto_th = "<th>protocol</th>" if annotations is not None else ""
    parts = [
        "<table><tr><th>ts</th><th>actor</th><th>action</th><th>model</th>"
        "<th>sev</th><th>message</th><th>evidence</th>" + proto_th +
        "<th>cause</th><th>exemplar</th><th>event</th></tr>"
    ]
    for e in events:
        tid = e.get("trace_id")
        cause = e.get("cause")
        proto_td = (
            _protocol_cell(annotations.get(str(e.get("event_id"))), esc)
            if annotations is not None else ""
        )
        parts.append(
            f"<tr style='background:{_SEV_COLOR.get(e.get('severity'), '')}'>"
            f"<td>{esc(round(e.get('ts', 0), 3))}</td>"
            f"<td>{esc(e.get('actor'))}</td><td>{esc(e.get('action'))}</td>"
            f"<td>{esc(e.get('model') or e.get('tenant') or '—')}</td>"
            f"<td>{esc(e.get('severity'))}</td>"
            f"<td>{esc(e.get('message'))}</td>"
            f"<td>{esc(_evidence_summary(e))}</td>"
            + proto_td
            + (
                f"<td><a href='/decisionz?event_id={esc(cause)}'>{esc(cause)}</a></td>"
                if cause else "<td>—</td>"
            )
            + (
                f"<td><a href='/tracez?trace_id={esc(tid)}'>{esc(tid)}</a></td>"
                if tid else "<td>—</td>"
            )
            + f"<td><a href='/decisionz?event_id={esc(e.get('event_id'))}'>"
            f"{esc(e.get('event_id'))}</a></td></tr>"
        )
    parts.append("</table>")
    return parts


def render_decisionz_html(event_id: Optional[str] = None) -> str:
    """The human form of ``/decisionz``: the decision timeline (newest
    first, severity-tinted, cause + exemplar linked), or — with
    ``event_id`` — the causal-chain "explain" view of one decision."""
    import html as _html

    def esc(v) -> str:
        return _html.escape(str(v), quote=True)

    rep = decisionz_report()
    parts = [
        "<html><head><title>/decisionz</title><style>"
        "table{border-collapse:collapse}td,th{border:1px solid #999;"
        "padding:3px 6px;font:12px monospace}</style></head><body>",
    ]
    if event_id is not None:
        doc = causal_chain(event_id)
        parts.append(f"<h1>/decisionz — explain {esc(event_id)}</h1>")
        if not doc["found"]:
            parts.append(
                f"<p>event {esc(event_id)} is not retained in the hot ring "
                "(try the durable log: telemetry.journal.read_journal of "
                f"{esc(rep['dir'] or '<dir>')})</p>"
            )
        else:
            # the explain view annotates every event with its declared
            # protocol transition (state before → after), flagging H805
            # violations inline — stepped over the whole retained ring
            # so tracked states are right even for mid-ring events
            annotations = _conformance.annotate(rep["events"])
            parts.append(
                f"<h2>causal chain ({len(doc['chain'])} event(s), root first)</h2>"
            )
            parts.extend(_event_rows_html(doc["chain"], esc, annotations))
            parts.append(f"<h2>downstream effects ({len(doc['effects'])})</h2>")
            if doc["effects"]:
                parts.extend(_event_rows_html(doc["effects"], esc, annotations))
            else:
                parts.append("<p>(none retained)</p>")
        parts.append("<p><a href='/decisionz'>full timeline</a></p>")
    else:
        parts.append("<h1>/decisionz — control-plane decision journal</h1>")
        parts.append(
            f"<p>{len(rep['events'])} event(s) retained (ring {rep['ring']}); "
            "durable log: "
            + (esc(rep["dir"]) if rep["dir"] else
               "off (set HEAT_TPU_JOURNAL_DIR)")
            + "</p>"
        )
        if rep["events"]:
            parts.extend(_event_rows_html(list(reversed(rep["events"])), esc))
        else:
            parts.append("<p>(no decisions journaled yet)</p>")
    parts.append("</body></html>")
    return "".join(parts)
