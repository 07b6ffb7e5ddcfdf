"""Runtime concurrency sanitizer: lock-order cycles and unguarded access
(counterpart of heat_tpu/analysis/tsan.py).

Every lock in
:data:`~heat_tpu_torch.analysis.concurrency.LOCK_REGISTRY` is created through
:func:`register_lock`, which returns an instrumented proxy.  Disarmed
(the production default) the proxy costs one module-global read per
acquire/release.  Armed (``HEAT_TPU_TSAN=1``, or :func:`arm`), every
acquisition records a compact per-thread stack and feeds the global
**lock-order graph**; every :func:`note_access` checkpoint at a
registered shared structure verifies the accessing thread either holds
the structure's registered lock or is the main thread.  Two finding
kinds result, reported as structured
:class:`~heat_tpu_torch.analysis.diagnostics.Diagnostic` records (rule IDs
``tsan.lock_cycle`` / ``tsan.unguarded_access``) that flow into the
telemetry registry (``analysis.diags.{rule}`` counters), the
recent-diagnostics ring, and the flight-recorder crash bundle:

* **lock_cycle** — the lock-order graph acquired a cycle: some thread
  took A then B while another path takes B then A.  Both acquisition
  stacks (the edge that closed the cycle and the recorded reverse
  path) are attached.  This is a *potential deadlock* even if the run
  never wedged — the interleaving that deadlocks is a scheduler
  accident away.
* **unguarded_access** — a registered shared structure (metrics
  registry, span ring, trace store, journal, fault-site counters) was
  touched from a non-main thread without its
  registered lock held.  The accessing stack and the most recent
  recorded access stack are both attached.

``HEAT_TPU_TSAN=raise`` additionally raises
:class:`~heat_tpu_torch.analysis.diagnostics.ProgramLintError` at the
finding site; ``HEAT_TPU_TSAN_DUMP=<path>``
writes the findings list as JSON at process exit so a test-runner
subprocess can be audited from outside.

Findings are kept in a process-lifetime list (:func:`findings`) that
``telemetry.reset_all()`` does NOT clear — a sanitized test lane counts
them across the whole run.  This module is pure stdlib at import time
(telemetry/diagnostics are imported lazily at the first finding), so
the low-level modules that create locks at import — ``telemetry.
metrics`` is among the first modules the package loads — can depend on
it without cycles.
"""

from __future__ import annotations

import atexit
import json
import os
import sys
import threading
from typing import Any, Dict, List, Optional, Tuple

from ..core import _env
from .concurrency import LOCK_REGISTRY, registered_structures

__all__ = [
    "TsanLock",
    "arm",
    "clear_findings",
    "disarm",
    "enabled",
    "finding_count",
    "findings",
    "lock_graph",
    "mode",
    "note_access",
    "refresh_env",
    "register_lock",
    "register_structure",
]

MODE_OFF = "off"
MODE_WARN = "warn"
MODE_RAISE = "raise"

_MODE_ALIASES = {
    "0": MODE_OFF, "off": MODE_OFF, "false": MODE_OFF, "no": MODE_OFF,
    "1": MODE_WARN, "on": MODE_WARN, "warn": MODE_WARN, "true": MODE_WARN,
    "raise": MODE_RAISE, "error": MODE_RAISE, "2": MODE_RAISE,
}

#: findings list bound (a runaway finding loop must not grow unbounded)
_MAX_FINDINGS = 256


def _parse_mode(raw: Optional[str]) -> str:
    if raw is None:
        raw = "0"
    m = _MODE_ALIASES.get(str(raw).strip().lower())
    if m is None:
        raise ValueError(f"HEAT_TPU_TSAN={raw!r}: expected one of 0/1/raise")
    return m


# the knobs, read at import through the registry (core/_env.py imports
# nothing of the package): the low-level modules that create registered
# locks import this one first
_MODE = _parse_mode(_env.env_str("HEAT_TPU_TSAN"))
_ARMED = _MODE != MODE_OFF
_STACK_DEPTH = int(_env.env_str("HEAT_TPU_TSAN_STACK_DEPTH") or _env.knob_default("HEAT_TPU_TSAN_STACK_DEPTH"))

_TLS = threading.local()

#: internal bookkeeping lock — deliberately a RAW lock, not a TsanLock:
#: the sanitizer must not sanitize itself
_STATE_LOCK = threading.Lock()

#: (a, b) -> edge record: lock a was held while lock b was acquired
_EDGES: Dict[Tuple[str, str], Dict[str, Any]] = {}

#: cycles already reported (frozenset of member locks) — report once
_REPORTED_CYCLES: set = set()

#: (structure, location) pairs already reported — report once per site
_REPORTED_ACCESS: set = set()

#: process-lifetime findings (NOT cleared by telemetry.reset_all)
_FINDINGS: List[Dict[str, Any]] = []

#: structure name -> owning lock name (registry + test additions)
_STRUCTS: Dict[str, str] = registered_structures()

#: most recent access stack per structure (attached to unguarded reports)
_LAST_ACCESS: Dict[str, Tuple[str, ...]] = {}


def mode() -> str:
    """Current sanitizer mode: ``"off"``, ``"warn"`` or ``"raise"``."""
    return _MODE


def enabled() -> bool:
    """Whether the sanitizer is armed (recording)."""
    return _ARMED


def arm(new_mode: str = "1") -> str:
    """Arm the sanitizer at runtime (overrides the env var); accepts the
    env spellings (``1``/``raise``); returns the previous mode."""
    global _MODE, _ARMED
    prev = _MODE
    _MODE = _parse_mode(new_mode)
    if _MODE == MODE_OFF:
        raise ValueError("arm() needs an armed mode (1/raise); use disarm()")
    _ARMED = True
    return prev


def disarm() -> str:
    """Disarm the sanitizer; held-lock bookkeeping stops immediately
    (per-thread held lists are cleared lazily); returns the previous
    mode."""
    global _MODE, _ARMED
    prev = _MODE
    _MODE = MODE_OFF
    _ARMED = False
    return prev


def refresh_env() -> str:
    """Re-read ``HEAT_TPU_TSAN`` (tests that flip the env var
    mid-process); returns the new mode."""
    global _MODE, _ARMED
    _MODE = _parse_mode(_env.env_str("HEAT_TPU_TSAN"))
    _ARMED = _MODE != MODE_OFF
    return _MODE


def findings() -> List[Dict[str, Any]]:
    """Every finding recorded this process (bounded), oldest first."""
    with _STATE_LOCK:
        return [dict(f) for f in _FINDINGS]


def finding_count() -> int:
    """Number of findings recorded this process."""
    with _STATE_LOCK:
        return len(_FINDINGS)


def clear_findings() -> None:
    """Drop recorded findings, the lock-order graph, and the
    report-once dedup state (test isolation)."""
    with _STATE_LOCK:
        _FINDINGS.clear()
        _EDGES.clear()
        _REPORTED_CYCLES.clear()
        _REPORTED_ACCESS.clear()
        _LAST_ACCESS.clear()


def lock_graph() -> Dict[Tuple[str, str], Dict[str, Any]]:
    """Copy of the recorded lock-order edges: ``(held, acquired) ->
    {stacks, threads, count}``."""
    with _STATE_LOCK:
        return {k: dict(v) for k, v in _EDGES.items()}


# ----------------------------------------------------------------------
# registration
# ----------------------------------------------------------------------
def register_structure(name: str, lock_name: str) -> None:
    """Register an extra guarded structure at runtime (tests; production
    structures belong in ``concurrency.LOCK_REGISTRY``)."""
    _STRUCTS[name] = lock_name


def register_lock(name: str, lock=None) -> "TsanLock":
    """Create the registered lock ``name`` as an instrumented proxy.

    ``name`` must appear in ``concurrency.LOCK_REGISTRY`` (names under
    ``test.`` are exempt, for fixtures) — mirroring how the typed env
    accessors refuse unregistered knobs.  ``lock`` defaults to a fresh
    ``threading.Lock``; pass a ``threading.RLock()`` for re-entrant
    guards."""
    if name not in LOCK_REGISTRY and not name.startswith("test."):
        raise KeyError(
            f"{name!r} is not a registered lock; add it to heat_tpu_torch."
            "analysis.concurrency.LOCK_REGISTRY (file, spellings, "
            "structures, doc)"
        )
    return TsanLock(name, lock)


# ----------------------------------------------------------------------
# per-thread state + stack capture
# ----------------------------------------------------------------------
def _held() -> List[Tuple[str, Tuple[str, ...]]]:
    h = getattr(_TLS, "held", None)
    if h is None:
        h = _TLS.held = []
    return h


def _capture(skip: int = 2) -> Tuple[str, ...]:
    """Compact acquisition stack: ``file:line:function`` per frame,
    innermost first, without line-text extraction (cheap enough to pay
    per acquire while armed)."""
    try:
        f = sys._getframe(skip)
    except ValueError:  # pragma: no cover - shallow stack
        return ()
    out: List[str] = []
    while f is not None and len(out) < _STACK_DEPTH:
        co = f.f_code
        out.append(f"{co.co_filename}:{f.f_lineno}:{co.co_name}")
        f = f.f_back
    return tuple(out)


def _reporting() -> bool:
    return getattr(_TLS, "reporting", False)


# ----------------------------------------------------------------------
# reporting
# ----------------------------------------------------------------------
def _report(rule: str, message: str, details: Dict[str, Any]) -> None:
    """Record one finding and surface it through the shared diagnostics
    pipeline.  Re-entrancy-guarded: the telemetry counters the pipeline
    bumps take registered locks themselves."""
    rec = {"rule": rule, "message": message, **details}
    with _STATE_LOCK:
        if len(_FINDINGS) < _MAX_FINDINGS:
            _FINDINGS.append(rec)
    _TLS.reporting = True
    try:
        from . import diagnostics as _diag

        _diag.emit(
            _diag.Diagnostic(
                rule=rule, message=message, source="tsan", details=details
            ),
            mode=_diag.MODE_RAISE if _MODE == MODE_RAISE else _diag.MODE_WARN,
        )
    finally:
        _TLS.reporting = False


def _note_edge(
    held_name: str,
    held_stack: Tuple[str, ...],
    acq_name: str,
    acq_stack: Tuple[str, ...],
) -> None:
    """Record the order edge held_name -> acq_name; on a NEW edge, look
    for a reverse path (a cycle = a potential deadlock)."""
    key = (held_name, acq_name)
    cycle_path = None
    with _STATE_LOCK:
        rec = _EDGES.get(key)
        if rec is not None:
            rec["count"] += 1
            return
        _EDGES[key] = {
            "held_stack": held_stack,
            "acquire_stack": acq_stack,
            "thread": threading.current_thread().name,
            "count": 1,
        }
        # DFS: does acq_name already reach held_name?
        path = _find_path(acq_name, held_name)
        if path is not None:
            members = frozenset(path + [acq_name])
            if members not in _REPORTED_CYCLES:
                _REPORTED_CYCLES.add(members)
                cycle_path = path
    if cycle_path is not None:
        edges = []
        with _STATE_LOCK:
            chain = [acq_name] + cycle_path
            for a, b in zip(chain, chain[1:]):
                e = _EDGES.get((a, b))
                edges.append(
                    {
                        "held": a,
                        "acquired": b,
                        "held_stack": list(e["held_stack"]) if e else [],
                        "acquire_stack": list(e["acquire_stack"]) if e else [],
                        "thread": e["thread"] if e else "?",
                    }
                )
        # full chain: held -> acquired -> ... -> held (cycle_path ends at
        # held_name, closing the loop)
        chain_nodes = [held_name, acq_name] + cycle_path
        _report(
            "tsan.lock_cycle",
            f"lock-order cycle: {' -> '.join(chain_nodes)}"
            f" (some thread holds {held_name!r} while acquiring {acq_name!r};"
            f" another path acquires them in the reverse order) — a"
            f" scheduler-dependent deadlock",
            {
                "cycle": chain_nodes,
                "closing_edge": {
                    "held": held_name,
                    "acquired": acq_name,
                    "held_stack": list(held_stack),
                    "acquire_stack": list(acq_stack),
                    "thread": threading.current_thread().name,
                },
                "reverse_path": edges,
            },
        )


def _find_path(src: str, dst: str) -> Optional[List[str]]:
    """DFS over _EDGES from ``src`` to ``dst`` (caller holds
    _STATE_LOCK); returns the node path [next, ..., dst] or None."""
    stack = [(src, [])]
    seen = {src}
    while stack:
        node, path = stack.pop()
        for (a, b) in _EDGES:
            if a != node or b in seen:
                continue
            if b == dst:
                return path + [b]
            seen.add(b)
            stack.append((b, path + [b]))
    return None


# ----------------------------------------------------------------------
# the instrumented lock
# ----------------------------------------------------------------------
class TsanLock:
    """Instrumented proxy over a ``threading.Lock``/``RLock``.

    Disarmed: acquire/release delegate after one module-global read.
    Armed: acquisition order feeds the global lock-order graph with a
    compact stack per hold.  The proxy is what ``with`` statements over
    registered locks actually hold; create via :func:`register_lock`."""

    __slots__ = ("name", "_lock")

    def __init__(self, name: str, lock=None):
        self.name = name
        self._lock = lock if lock is not None else threading.Lock()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        ok = self._lock.acquire(blocking, timeout)
        if ok and _ARMED and not _reporting():
            held = _held()
            stack = _capture()
            for held_name, held_stack in held:
                if held_name != self.name:
                    _note_edge(held_name, held_stack, self.name, stack)
            held.append((self.name, stack))
        return ok

    def release(self) -> None:
        if _ARMED and not _reporting():
            held = _held()
            for i in range(len(held) - 1, -1, -1):
                if held[i][0] == self.name:
                    del held[i]
                    break
        self._lock.release()

    def locked(self) -> bool:
        return self._lock.locked()

    def held_by_current_thread(self) -> bool:
        """Whether the current thread is (tsan-)tracked as holding this
        lock.  Only meaningful while armed."""
        return any(n == self.name for n, _ in _held())

    def __enter__(self) -> "TsanLock":
        self.acquire()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"TsanLock({self.name!r})"


# ----------------------------------------------------------------------
# guarded-structure access checkpoints
# ----------------------------------------------------------------------
def note_access(structure: str, write: bool = True) -> None:
    """Checkpoint one access to a registered shared structure.

    Free (one global read) while disarmed.  Armed: the access is OK when
    the current thread holds the structure's registered lock, or when it
    is the main thread (single-writer-main is the framework's sanctioned
    lock-free pattern — the GIL orders main-thread access against
    *nothing*, which is exactly why off-main access needs the lock).
    Anything else is a ``tsan.unguarded_access`` finding carrying both
    stacks."""
    if not _ARMED or _reporting():
        return
    lock_name = _STRUCTS.get(structure)
    if lock_name is None:
        raise KeyError(
            f"{structure!r} is not a registered guarded structure; add it "
            "to a lock's 'structures' tuple in heat_tpu_torch.analysis."
            "concurrency.LOCK_REGISTRY (or tsan.register_structure for "
            "test fixtures)"
        )
    stack = _capture()
    if any(n == lock_name for n, _ in _held()):
        with _STATE_LOCK:
            _LAST_ACCESS[structure] = stack
        return
    if threading.current_thread() is threading.main_thread():
        with _STATE_LOCK:
            _LAST_ACCESS[structure] = stack
        return
    loc = stack[0] if stack else "?"
    with _STATE_LOCK:
        key = (structure, loc)
        if key in _REPORTED_ACCESS:
            return
        _REPORTED_ACCESS.add(key)
        last = list(_LAST_ACCESS.get(structure, ()))
    _report(
        "tsan.unguarded_access",
        f"shared structure {structure!r} {'written' if write else 'read'} "
        f"from thread {threading.current_thread().name!r} without holding "
        f"its registered lock {lock_name!r}",
        {
            "structure": structure,
            "lock": lock_name,
            "write": bool(write),
            "thread": threading.current_thread().name,
            "access_stack": list(stack),
            "last_access_stack": last,
        },
    )


# ----------------------------------------------------------------------
# exit dump (the sanitized CI lane's audit artifact)
# ----------------------------------------------------------------------
@atexit.register
def _dump_at_exit() -> None:  # pragma: no cover - exercised via subprocess
    """``HEAT_TPU_TSAN_DUMP=<path>``: write the findings list as JSON at
    interpreter exit (checked at exit time).  Plain json.dump: the
    atomic writer lives above this module in the import graph, and a
    reader treats a missing or torn file as a failed run anyway."""
    path = _env.env_str("HEAT_TPU_TSAN_DUMP")
    if not path:
        return
    try:
        doc = {"pid": os.getpid(), "mode": _MODE, "findings": findings()}
        with open(path, "w") as f:
            json.dump(doc, f, indent=1, default=str)
    except Exception:
        pass
