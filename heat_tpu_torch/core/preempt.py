"""Cooperative preemption of long checkpointed fits (QoS scheduling;
counterpart of heat_tpu/core/preempt.py).

The serving layer and the analytics fits share one device pool (the
paper's premise), so a latency spike arriving while a multi-minute
batch fit owns the chips is the steady state, not the exception.  This
module is the handshake that resolves the contention without killing
the fit's progress:

* A **requester** (the admission controller when a latency-class
  request is admitted under ``HEAT_TPU_QOS_PREEMPT_ON_LATENCY``, or an
  operator/test directly) calls :meth:`PreemptionGate.request` — a
  level-triggered signal ("the latency lane needs the chips"), not an
  edge: it stays pending until :meth:`PreemptionGate.clear`, so every
  fit that reaches a chunk boundary while the spike is on yields, not
  just the first one.
* A **fit** consults the gate between chunks of
  :func:`~heat_tpu_torch.core.base.resumable_fit_loop` via
  :meth:`PreemptionGate.take` — *after* the boundary checkpoint is
  scheduled, so the pause is durable (the checkpoint machinery already
  guarantees killed+resumed == uninterrupted bitwise; a cooperative
  preemption simply stops at the same boundary a kill would).  A fit
  running without a checkpointer has nothing durable to pause into, so
  the gate refuses to preempt it (counted in
  ``qos.preempt_ignored``) — losing an un-checkpointed fit's work
  would cost more device time than the spike saves.

The honoring fit evaluates the ``qos.preempt`` fault site immediately
before raising :class:`~heat_tpu_torch.resilience.errors.PreemptedError`, so
kill-and-resume tests can script "host dies at the exact moment the
fit yields" (``HEAT_TPU_FAULT_PLAN='{"qos.preempt": [{"at": 0,
"kind": "kill"}]}'``) and assert the resumed result is bitwise-equal
either way.
"""

from __future__ import annotations

import itertools
from typing import Dict, Optional

from ..analysis import tsan as _tsan
from ..analysis.protocols import ACTOR_PREEMPT, PREEMPT_CLEAR, PREEMPT_RAISE
from ..telemetry import journal as _journal
from ..telemetry import metrics as _tm

__all__ = ["PreemptionGate", "preemption_gate"]

#: requests/honors/refusals are process-lifetime counters in the shared
#: telemetry registry, so a bench or /varz scrape can see preemption
#: pressure without holding the gate
_REQUESTS_C = _tm.counter("qos.preempt_requests")
_PREEMPTIONS_C = _tm.counter("qos.preemptions")
_IGNORED_C = _tm.counter("qos.preempt_ignored")
_PENDING_G = _tm.gauge(
    "qos.preempt_pending", "1 while a preemption request is outstanding"
)


class PreemptionGate:
    """Level-triggered yield request between latency traffic and fits.

    ``request()`` raises the level (idempotent — re-requesting while
    pending refreshes the reason but counts one spike, not many),
    ``clear()`` lowers it, ``take(durable=...)`` is the fit-side poll
    at a chunk boundary.  ``take`` deliberately does NOT consume the
    pending request: the spike persists until the requester clears it,
    so *every* checkpointed fit hitting a boundary during the spike
    yields.
    """

    def __init__(self) -> None:
        # requesters are admission/handler threads, pollers are fit
        # threads: the registered lock keeps the pending slot and the
        # per-gate counters coherent and sanitizer-checkable
        self._lock = _tsan.register_lock("core.preemption")
        self._reason: Optional[str] = None
        self._requests = 0
        self._preemptions = 0
        self._ignored = 0
        #: stable per-gate key the journal events carry (the protocol
        #: conformance checker tracks one raise/clear machine per gate)
        self._gate_key = f"gate{next(_GATE_SEQ)}"

    # -- requester side -------------------------------------------------
    def request(self, reason: str = "latency spike") -> None:
        """Ask running checkpointed fits to yield at their next chunk
        boundary.  Level-triggered: stays pending until :meth:`clear`."""
        with self._lock:
            _tsan.note_access("core.preemption.state")
            fresh = self._reason is None
            self._reason = str(reason)
            if fresh:
                self._requests += 1
                _REQUESTS_C.inc()
        if fresh:
            _PENDING_G.set(1.0)
            # journal after our lock is released (emit takes its own)
            _journal.emit(
                ACTOR_PREEMPT, PREEMPT_RAISE,
                severity="warn",
                message=f"preemption requested: {reason}",
                evidence={"reason": str(reason), "gate": self._gate_key},
            )

    def clear(self) -> None:
        """Withdraw the request (the latency lane drained)."""
        with self._lock:
            _tsan.note_access("core.preemption.state")
            was, self._reason = self._reason, None
        _PENDING_G.set(0.0)
        if was is not None:
            raised = _journal.find_last(actor=ACTOR_PREEMPT, action=PREEMPT_RAISE)
            _journal.emit(
                ACTOR_PREEMPT, PREEMPT_CLEAR,
                severity="info",
                message=f"preemption cleared: {was}",
                cause=raised["event_id"] if raised else None,
                evidence={"reason": was, "gate": self._gate_key},
            )

    # -- fit side -------------------------------------------------------
    def pending(self) -> Optional[str]:
        """The outstanding request's reason, or None."""
        with self._lock:
            _tsan.note_access("core.preemption.state")
            return self._reason

    def take(self, durable: bool) -> Optional[str]:
        """Fit-side poll at a chunk boundary.

        Returns the reason to yield for, or None to keep computing.
        ``durable`` says whether this fit has a committed checkpoint to
        pause into — without one the gate refuses (the request stays
        pending for fits that can honor it) and counts the refusal.
        """
        with self._lock:
            _tsan.note_access("core.preemption.state")
            reason = self._reason
            if reason is None:
                return None
            if not durable:
                self._ignored += 1
                _IGNORED_C.inc()
                return None
            self._preemptions += 1
            _PREEMPTIONS_C.inc()
            return reason

    def stats(self) -> Dict[str, object]:
        """Snapshot of this gate's lifetime accounting."""
        with self._lock:
            _tsan.note_access("core.preemption.state")
            return {
                "pending": self._reason,
                "requests": self._requests,
                "preemptions": self._preemptions,
                "ignored": self._ignored,
            }


#: per-process gate counter behind each gate's journal scope key
_GATE_SEQ = itertools.count()

_GATE = PreemptionGate()


def preemption_gate() -> PreemptionGate:
    """The process-wide gate (admission arms it, fit loops poll it)."""
    return _GATE
