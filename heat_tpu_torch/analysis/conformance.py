"""Runtime protocol conformance over the live decision journal
(counterpart of heat_tpu/analysis/conformance.py).

Every ``telemetry.journal.emit`` call is stepped through the state
machines declared in :mod:`.protocols`: the ``(actor, action)`` pair
selects the declared transition set, the protocol's ``scope`` picks the
machine *instance* (per model, per replica, per alert, per gate), and
the instance's tracked state advances -- or doesn't, which is the bug.
An illegal transition (an action the tracked state has no declared
edge for, or an undeclared action from a declared actor) surfaces as an
``analysis.diags.H805`` diagnostic (counter + recent ring, warn / raise
per the mode).  The verdicts are the reference's on the same events.

With ``HEAT_TPU_PROTOCOL_CHECK=0`` (the default) the per-emit hook is
one module-global read.  Armed (``1``/``warn``) each emit costs one dict
lookup plus a small state update under the dedicated leaf
``analysis.conformance`` lock; ``raise`` additionally turns the first
violation into a :class:`~.diagnostics.ProgramLintError` at the emit
site.

:func:`annotate` is the pure offline form of the same stepping (a
journal read back from disk), resetting instance states at
process-epoch boundaries (a restarted process's controllers
legitimately start over).
"""

from __future__ import annotations

import os
import threading
from typing import Any, Dict, Iterable, List, Optional, Tuple

from . import tsan as _tsan
from .protocols import PROTOCOLS, transition_index

__all__ = [
    "RULES",
    "annotate",
    "conformance_report",
    "note_emit",
    "protocol_mode",
    "refresh_env",
    "reset_conformance",
    "set_protocol_mode",
    "violations",
]

#: the runtime rule this checker reports under (the AST-side H801-H804
#: live in analysis/ast_lint.py RULES)
RULES = {
    "H805": "journal event is an illegal transition of its declared "
            "control-plane protocol (analysis/protocols.py)",
}

MODE_OFF = "off"
MODE_WARN = "warn"
MODE_RAISE = "raise"

# mirror analysis/diagnostics.py's spellings (kept local: this module
# must import nothing heavy at journal-import time)
_MODE_ALIASES = {
    "0": MODE_OFF, "off": MODE_OFF, "false": MODE_OFF, "no": MODE_OFF,
    "1": MODE_WARN, "on": MODE_WARN, "warn": MODE_WARN, "true": MODE_WARN,
    "raise": MODE_RAISE, "error": MODE_RAISE, "2": MODE_RAISE,
}


def _parse_mode(raw: Optional[str]) -> str:
    # read from the environment directly, with the reference's default
    if raw is None:
        raw = "0"
    mode = _MODE_ALIASES.get(str(raw).strip().lower())
    if mode is None:
        raise ValueError(
            f"HEAT_TPU_PROTOCOL_CHECK={raw!r}: expected one of 0/1/raise"
        )
    return mode


_MODE = _parse_mode(os.environ.get("HEAT_TPU_PROTOCOL_CHECK"))

#: ``(actor, action) -> (protocol, scope, ((from, to), ...))``
_INDEX = transition_index()
_ACTORS = frozenset(rec["actor"] for rec in PROTOCOLS.values())
_INITIAL = {name: rec["initial"] for name, rec in PROTOCOLS.items()}

#: tracked machine instances: ``(protocol, scope_key) -> state``; the
#: recent-violations list is bounded (not a full audit log: the journal
#: itself is that)
_LOCK = _tsan.register_lock("analysis.conformance")
_STATES: Dict[Tuple[str, Optional[str]], str] = {}
_RECENT: List[Dict[str, Any]] = []
_VIOLATION_COUNT = 0
_RECENT_CAP = 256


def protocol_mode() -> str:
    """Current conformance mode: ``"off"``, ``"warn"`` or ``"raise"``."""
    return _MODE


def set_protocol_mode(mode: str) -> str:
    """Set the conformance mode at runtime (overrides the env var);
    accepts the env spellings (``0/1/raise``); returns the previous
    mode."""
    global _MODE
    prev = _MODE
    _MODE = _parse_mode(mode)
    return prev


def refresh_env() -> str:
    """Re-read ``HEAT_TPU_PROTOCOL_CHECK`` (tests that flip the env var
    mid-process); returns the new mode."""
    global _MODE
    _MODE = _parse_mode(os.environ.get("HEAT_TPU_PROTOCOL_CHECK"))
    return _MODE


def reset_conformance() -> None:
    """Forget every tracked machine instance and recorded violation
    (``telemetry.journal.reset_journal`` calls this: a fresh journal
    means fresh controllers)."""
    global _VIOLATION_COUNT
    with _LOCK:
        _tsan.note_access("analysis.conformance.state")
        _STATES.clear()
        del _RECENT[:]
        _VIOLATION_COUNT = 0


# ----------------------------------------------------------------------
# the stepping core (shared by the live hook and the pure annotators)
# ----------------------------------------------------------------------
def _scope_key(scope: str, doc: Dict[str, Any]) -> Optional[str]:
    if scope == "model":
        return doc.get("model")
    if scope in ("replica", "alert", "gate"):
        ev = doc.get("evidence") or {}
        v = ev.get(scope)
        return None if v is None else str(v)
    return None  # "global"


def _step(
    states: Dict[Tuple[str, Optional[str]], str], doc: Dict[str, Any]
) -> Optional[Dict[str, Any]]:
    """Advance the tracked machines by one journal event; returns the
    annotation record (``None`` for non-protocol actors)."""
    actor = doc.get("actor")
    action = doc.get("action")
    entry = _INDEX.get((actor, action))
    if entry is None:
        if actor not in _ACTORS:
            return None  # not a controller this registry governs
        return {
            "ok": False,
            "protocol": None,
            "scope_key": None,
            "from": None,
            "to": None,
            "message": (
                f"actor {actor!r} emitted undeclared action {action!r} "
                f"(no protocol in analysis/protocols.py declares it)"
            ),
        }
    proto, scope, edges = entry
    key = _scope_key(scope, doc)
    cur = states.get((proto, key), _INITIAL[proto])
    for frm, to in edges:
        if frm == cur:
            states[(proto, key)] = to
            return {
                "ok": True,
                "protocol": proto,
                "scope_key": key,
                "from": cur,
                "to": to,
                "message": None,
            }
    # illegal: no declared edge for this action out of the tracked
    # state.  Resync onto the action's first declared target so one
    # violation doesn't cascade into a false report per later event.
    resync = edges[0][1]
    states[(proto, key)] = resync
    legal = sorted({frm for frm, _ in edges})
    return {
        "ok": False,
        "protocol": proto,
        "scope_key": key,
        "from": cur,
        "to": resync,
        "message": (
            f"protocol {proto!r}"
            + (f" instance {key!r}" if key is not None else "")
            + f": action {action!r} is illegal from state {cur!r} "
            f"(declared only from {legal})"
        ),
    }


def _report(ann: Dict[str, Any], doc: Dict[str, Any], mode: str) -> None:
    """Surface one violation as the H805 diagnostic (which raises in
    raise mode).  Runs with NO locks held.  The reference also fires a
    ``protocol:<actor>`` warn alert first; the port's alerts come with
    the rest of telemetry (ROADMAP item 17a)."""
    from . import diagnostics as _diag

    _diag.emit(
        _diag.Diagnostic(
            rule="H805",
            message=ann["message"],
            location=f"journal:{doc.get('event_id')}",
            source="dispatch",
            details={
                "actor": doc.get("actor"),
                "action": doc.get("action"),
                "protocol": ann["protocol"],
                "scope_key": ann["scope_key"],
                "state": ann["from"],
            },
        ),
        mode=mode,
    )


def note_emit(doc: Dict[str, Any]) -> None:
    """The per-emit hook ``telemetry.journal.emit`` calls after its own
    lock is released.  One module-global read when off."""
    mode = _MODE
    if mode == MODE_OFF:
        return
    global _VIOLATION_COUNT
    with _LOCK:
        _tsan.note_access("analysis.conformance.state")
        ann = _step(_STATES, doc)
        if ann is not None and not ann["ok"]:
            _VIOLATION_COUNT += 1
            if len(_RECENT) < _RECENT_CAP:
                _RECENT.append({
                    "event_id": doc.get("event_id"),
                    "actor": doc.get("actor"),
                    "action": doc.get("action"),
                    "protocol": ann["protocol"],
                    "scope_key": ann["scope_key"],
                    "from": ann["from"],
                    "message": ann["message"],
                })
    if ann is not None and not ann["ok"]:
        _report(ann, doc, mode)


def violations() -> List[Dict[str, Any]]:
    """Recent recorded violations (bounded), oldest first."""
    with _LOCK:
        _tsan.note_access("analysis.conformance.state", write=False)
        return [dict(v) for v in _RECENT]


def conformance_report() -> Dict[str, Any]:
    """Mode, tracked-instance count and violation totals."""
    with _LOCK:
        _tsan.note_access("analysis.conformance.state", write=False)
        return {
            "mode": _MODE,
            "tracked_instances": len(_STATES),
            "violations": _VIOLATION_COUNT,
            "recent": [dict(v) for v in _RECENT],
        }


# ----------------------------------------------------------------------
# pure offline stepping (no globals): a journal read back from disk
# ----------------------------------------------------------------------
def _epoch_of(event_id: str) -> str:
    # event_id = "<pid:x>-<start ms:x>-<seq:06d>"; everything before the
    # final dash is the process epoch
    return str(event_id).rsplit("-", 1)[0]


def annotate(events: Iterable[Dict[str, Any]]) -> Dict[str, Dict[str, Any]]:
    """Step an event sequence (emission order) through fresh machines;
    returns ``event_id -> annotation`` where each annotation carries
    ``ok``, ``protocol``, ``scope_key``, ``from``, ``to`` and (on a
    violation) ``message``.  Machine instances reset whenever the
    process epoch embedded in ``event_id`` changes — a restarted
    process's controllers start from their initial states."""
    states: Dict[Tuple[str, Optional[str]], str] = {}
    epoch: Optional[str] = None
    out: Dict[str, Dict[str, Any]] = {}
    for doc in events:
        eid = doc.get("event_id")
        if eid is None:
            continue
        ep = _epoch_of(eid)
        if ep != epoch:
            states.clear()
            epoch = ep
        ann = _step(states, doc)
        if ann is not None:
            out[str(eid)] = ann
    return out
