"""Bounded-exponential-backoff retry for transient failures (counterpart
of heat_tpu/resilience/retry.py).

One policy object covers the ``parallel.init()`` process-group
bootstrap and every io load/save, plus anything user code wants to
wrap.  The policies, their env knobs and their counters are the
reference's: the same failures give the same attempts and delays.
Design points:

* **Typed filter** — only exceptions in ``retryable`` are retried;
  :class:`PermanentFault`, :class:`ChecksumError` and
  :class:`DivergenceError` are re-raised immediately whatever the
  filter says (retrying cannot fix them).
* **Deterministic no-sleep mode** — ``no_sleep=True`` (or
  ``HEAT_TPU_RETRY_NO_SLEEP=1``) records the would-be delays but never
  sleeps, so failure tests run at full speed with an asserted backoff
  schedule.
* **Per-attempt timeout** — ``attempt_timeout`` runs the attempt in a
  worker thread and treats exceeding the budget as a retryable failure
  (the hung-filesystem case).  Off by default: it changes the execution
  thread, which matters for signal handling.
* **Counters** — module-level :func:`retry_stats` aggregates retries /
  gave-ups across all policies (``retry.*`` in the telemetry registry).
"""

from __future__ import annotations

import functools
import time
from typing import Callable, List, Optional, Tuple, Type

from .errors import (
    ChecksumError,
    DivergenceError,
    NoReplicaError,
    OverloadedError,
    PermanentFault,
    ReshapeError,
    TransientFault,
)
from ..core import _env
from ..telemetry import metrics as _tm

__all__ = [
    "RetryPolicy",
    "RetryTimeout",
    "retry_stats",
    "reset_retry_stats",
    "default_io_policy",
    "default_init_policy",
]

#: aggregate retry counters across every policy in the process —
#: registered in the shared telemetry registry as ``retry.*``
_STAT_NAMES = ("calls", "retries", "gave_up", "succeeded_after_retry", "faults_survived")
_STATS = {k: _tm.counter(f"retry.{k}") for k in _STAT_NAMES}


def _bump(key: str, n: int = 1) -> None:
    _STATS[key].inc(n)


def retry_stats() -> dict:
    """Aggregate retry counters across every policy in the process — a
    thin view over the shared telemetry registry (``retry.*``)."""
    return {k: _STATS[k].value for k in _STAT_NAMES}


def reset_retry_stats() -> None:
    """Zero the retry counters; delegates to
    ``telemetry.reset_all("retry")``."""
    from ..telemetry import reset_all

    reset_all("retry")


class RetryTimeout(TransientFault):
    """An attempt exceeded the policy's per-attempt timeout (retryable)."""


#: exception types retrying can never fix — checked before the
#: retryable filter, so even a filter of ``(Exception,)`` cannot loop
#: on them
NON_RETRYABLE = (
    PermanentFault, ChecksumError, DivergenceError, ReshapeError,
    OverloadedError, NoReplicaError,
)


class RetryPolicy:
    """Bounded exponential backoff: delay ``base_delay * backoff**i``
    capped at ``max_delay``, at most ``max_attempts`` attempts."""

    def __init__(
        self,
        max_attempts: int = 3,
        base_delay: float = 0.05,
        max_delay: float = 2.0,
        backoff: float = 2.0,
        retryable: Tuple[Type[BaseException], ...] = (OSError, TimeoutError),
        attempt_timeout: Optional[float] = None,
        no_sleep: Optional[bool] = None,
        sleep: Callable[[float], None] = time.sleep,
    ):
        if max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, got {max_attempts}")
        if base_delay < 0 or max_delay < 0 or backoff < 1.0:
            raise ValueError("delays must be >= 0 and backoff >= 1.0")
        self.max_attempts = int(max_attempts)
        self.base_delay = float(base_delay)
        self.max_delay = float(max_delay)
        self.backoff = float(backoff)
        self.retryable = tuple(retryable)
        self.attempt_timeout = attempt_timeout
        if no_sleep is None:
            # the reference's reading of this bool knob: only "1" turns it on
            no_sleep = _env.env_str("HEAT_TPU_RETRY_NO_SLEEP") == "1"
        self.no_sleep = bool(no_sleep)
        self._sleep = sleep
        #: delays slept (or recorded, in no-sleep mode) by the most
        #: recent :meth:`call` — the backoff-schedule assertion surface
        self.last_delays: List[float] = []

    def delay(self, attempt: int) -> float:
        """Backoff delay after failed attempt ``attempt`` (0-based)."""
        return min(self.base_delay * (self.backoff ** attempt), self.max_delay)

    def schedule(self) -> List[float]:
        """The full delay schedule a maximally unlucky call would sleep."""
        return [self.delay(i) for i in range(self.max_attempts - 1)]

    def is_retryable(self, exc: BaseException) -> bool:
        if isinstance(exc, NON_RETRYABLE):
            return False
        return isinstance(exc, self.retryable)

    def _attempt(self, fn: Callable, args, kwargs):
        if self.attempt_timeout is None:
            return fn(*args, **kwargs)
        from concurrent.futures import ThreadPoolExecutor, TimeoutError as FutTimeout

        with ThreadPoolExecutor(max_workers=1) as pool:
            fut = pool.submit(fn, *args, **kwargs)
            try:
                return fut.result(timeout=self.attempt_timeout)
            except FutTimeout:
                fut.cancel()
                raise RetryTimeout(
                    f"attempt exceeded {self.attempt_timeout}s timeout"
                ) from None

    def call(self, fn: Callable, *args, **kwargs):
        """Run ``fn(*args, **kwargs)`` under this policy."""
        _bump("calls")
        self.last_delays = []
        attempt = 0
        while True:
            try:
                out = self._attempt(fn, args, kwargs)
            except BaseException as e:
                if not self.is_retryable(e) or attempt >= self.max_attempts - 1:
                    if self.is_retryable(e):
                        _bump("gave_up")
                    raise
                d = self.delay(attempt)
                self.last_delays.append(d)
                _bump("retries")
                if not self.no_sleep and d > 0:
                    self._sleep(d)
                attempt += 1
                continue
            if attempt > 0:
                _bump("succeeded_after_retry")
                _bump("faults_survived", attempt)
            return out

    def wrap(self, fn: Callable) -> Callable:
        """Decorator form: every call of ``fn`` runs under the policy."""

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            return self.call(fn, *args, **kwargs)

        wrapper.__wrapped__ = fn
        wrapper.retry_policy = self
        return wrapper

    __call__ = wrap

    def __repr__(self) -> str:
        return (
            f"RetryPolicy(max_attempts={self.max_attempts}, "
            f"base_delay={self.base_delay}, max_delay={self.max_delay}, "
            f"backoff={self.backoff}, no_sleep={self.no_sleep})"
        )


def _env_policy(prefix: str, retryable=(OSError, TimeoutError)) -> RetryPolicy:
    return RetryPolicy(
        max_attempts=_env.env_int(f"{prefix}_ATTEMPTS"),
        base_delay=_env.env_float(f"{prefix}_BASE_DELAY"),
        max_delay=_env.env_float(f"{prefix}_MAX_DELAY"),
        retryable=retryable,
    )


def default_io_policy() -> RetryPolicy:
    """Policy io loads/saves run under.

    Built per call so ``HEAT_TPU_IO_RETRY_{ATTEMPTS,BASE_DELAY,
    MAX_DELAY}`` and ``HEAT_TPU_RETRY_NO_SLEEP`` take effect without
    re-importing; construction is a handful of env reads, noise next to
    any actual file IO."""
    return _env_policy("HEAT_TPU_IO_RETRY")


def default_init_policy() -> RetryPolicy:
    """Policy the ``parallel.init()`` process-group bootstrap runs under
    (a rendezvous that comes up after its workers is the transient being
    absorbed; RuntimeError is included because ``torch.distributed``
    reports a failed rendezvous as one, DistNetworkError among them)."""
    return _env_policy(
        "HEAT_TPU_INIT_RETRY",
        retryable=(OSError, TimeoutError, RuntimeError),
    )
