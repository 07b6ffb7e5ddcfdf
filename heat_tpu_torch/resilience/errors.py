"""Typed failure taxonomy of the resilience layer (counterpart of
heat_tpu/resilience/errors.py, class for class).

Failure split into classes the rest of the layer can act on
mechanically; the classes, their bases and their attributes are the
reference's, so ``except ChecksumError`` reads the same in both
packages:

* :class:`TransientFault` — a failure that a bounded retry is expected
  to clear (flaky filesystem, preempted bootstrap, injected test
  fault).  Subclasses ``OSError`` so the io retry filters treat real
  POSIX errors and injected transients identically.
* :class:`PermanentFault` — a failure retrying cannot fix.  The retry
  machinery re-raises it immediately, whatever the policy's filter
  says.
* :class:`ChecksumError` — a file's content does not match its CRC32
  sidecar: a torn or corrupted write that must fail loudly instead of
  returning garbage.  Never retried (the bytes on disk will not
  change).
* :class:`DivergenceError` — an iterative fit produced non-finite
  values.  Carries the last finite iterate and its iteration index so
  a caller can degrade gracefully (restart from ``last_good``, shrink
  the step, report a usable partial result).
"""

from __future__ import annotations

from typing import Any, Optional

__all__ = [
    "ResilienceError",
    "TransientFault",
    "PermanentFault",
    "ChecksumError",
    "DivergenceError",
    "NoReplicaError",
    "OverloadedError",
    "PreemptedError",
    "ReshapeError",
    "WorkerLostError",
]


class ResilienceError(Exception):
    """Base of every failure type the resilience layer raises."""


class TransientFault(ResilienceError, OSError):
    """A retryable failure (also raised by the fault injector for
    ``kind='transient'`` plan entries)."""

    def __init__(self, message: str = "transient fault", site: Optional[str] = None, index: Optional[int] = None):
        super().__init__(message)
        self.site = site
        self.index = index


class PermanentFault(ResilienceError, RuntimeError):
    """A non-retryable failure: the retry machinery re-raises it
    immediately (also raised for ``kind='permanent'`` plan entries)."""

    def __init__(self, message: str = "permanent fault", site: Optional[str] = None, index: Optional[int] = None):
        super().__init__(message)
        self.site = site
        self.index = index


class ChecksumError(ResilienceError, OSError):
    """File content disagrees with its CRC32 sidecar.  Excluded from
    retry: re-reading corrupt bytes yields the same corrupt bytes."""

    def __init__(self, path: str, expected: int, actual: int):
        super().__init__(
            f"checksum mismatch for {path!r}: sidecar records crc32 "
            f"{expected:#010x} but the file hashes to {actual:#010x} — "
            "the file is torn or corrupted; restore it from a replica "
            "or delete the sidecar to force an unverified load"
        )
        self.path = path
        self.expected = expected
        self.actual = actual


class WorkerLostError(ResilienceError, RuntimeError):
    """A participant of the SPMD world stopped responding (preempted
    host, dead heartbeat, failed collective).  Carries what the detector
    knew: ``lost`` (how many participants are gone, best-effort),
    ``world_size`` (the size of the world the loss was observed in) and
    ``heartbeat_age`` (seconds since the last observed heartbeat, when
    heartbeat-based detection fired).  The elastic supervisor reacts by
    reshaping the mesh to the survivors and resuming from the last
    durable checkpoint; without a supervisor it propagates like any
    other fatal error."""

    def __init__(
        self,
        message: str = "worker lost",
        lost: int = 1,
        world_size: Optional[int] = None,
        heartbeat_age: Optional[float] = None,
    ):
        super().__init__(message)
        self.lost = int(lost)
        self.world_size = world_size
        self.heartbeat_age = heartbeat_age


class ReshapeError(ResilienceError, ValueError):
    """An elastic mesh reshape or a cross-world checkpoint restore
    cannot be performed: target world invalid (zero/negative, more
    devices than exist), or restored state does not fit the template
    (shape/dtype mismatch).  Never retried — the inputs will not
    change."""

    def __init__(
        self,
        message: str,
        old_size: Optional[int] = None,
        new_size: Optional[int] = None,
        leaf: Optional[str] = None,
    ):
        super().__init__(message)
        self.old_size = old_size
        self.new_size = new_size
        self.leaf = leaf


class OverloadedError(ResilienceError, RuntimeError):
    """The serving layer shed this request instead of queueing it.

    Deliberate load shedding, not a malfunction: either the caller's
    tenant is over its token-bucket quota (``cause="quota"``, with
    ``retry_after_s`` saying when the bucket will cover the request) or
    the service-wide admission queue is at its depth bound
    (``cause="queue"``).  The HTTP surface maps it to 429 with a
    ``Retry-After`` header.  Never retried by the resilience machinery
    — an immediate retry is exactly the traffic the shed exists to
    refuse; back off for ``retry_after_s`` instead."""

    def __init__(
        self,
        message: str = "overloaded",
        tenant: Optional[str] = None,
        cause: str = "queue",
        retry_after_s: Optional[float] = None,
    ):
        super().__init__(message)
        self.tenant = tenant
        self.cause = cause
        self.retry_after_s = retry_after_s


class PreemptedError(ResilienceError, RuntimeError):
    """A checkpointed batch fit yielded at a chunk boundary.

    Deliberate scheduling, not a malfunction: a latency spike (or an
    operator) asked the ``PreemptionGate`` (:mod:`heat_tpu_torch.core.preempt`)
    to reclaim the chips, and the fit paused at the first chunk boundary
    after the request — the point where its checkpoint (committed with
    ``converged=False``) already makes the pause durable.  Re-running
    the same fit with ``resume_from`` pointing at ``checkpoint_dir``
    continues the identical iteration sequence, so the resumed result is
    bitwise-equal to the uninterrupted fit.  Never retried by the
    resilience machinery — resuming *while the spike is still on* is
    exactly the contention the preemption exists to end."""

    def __init__(
        self,
        message: str = "fit preempted",
        iteration: Optional[int] = None,
        checkpoint_dir: Optional[str] = None,
        reason: Optional[str] = None,
    ):
        super().__init__(message)
        self.iteration = iteration
        self.checkpoint_dir = checkpoint_dir
        self.reason = reason


class NoReplicaError(ResilienceError, RuntimeError):
    """The fleet router found no replica able to take a request: every
    replica hosting the model is unready (warming, draining, ejected by
    its circuit breaker) or unreachable, and bounded failover exhausted
    its attempts.  The HTTP surface maps it to a typed 503 with a
    ``Retry-After`` (the router's health-poll period: by then a probe
    or a recovered replica may have changed the verdict).  Never
    retried by the resilience machinery — the router already performed
    the bounded retry this error reports the failure of."""

    def __init__(
        self,
        message: str = "no replica available",
        model: Optional[str] = None,
        attempts: int = 0,
        retry_after_s: Optional[float] = None,
    ):
        super().__init__(message)
        self.model = model
        self.attempts = int(attempts)
        self.retry_after_s = retry_after_s


class DivergenceError(ResilienceError, ArithmeticError):
    """An iterative fit produced NaN/Inf.

    ``iteration`` is the first iteration at which non-finite values were
    observed; ``last_good`` is the most recent finite iterate (host
    numpy/None), so callers can resume or report it instead of silently
    converging to NaN.
    """

    def __init__(
        self,
        message: str,
        iteration: Optional[int] = None,
        last_good: Any = None,
        last_good_iteration: Optional[int] = None,
    ):
        super().__init__(message)
        self.iteration = iteration
        self.last_good = last_good
        self.last_good_iteration = last_good_iteration
