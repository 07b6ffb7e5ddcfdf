"""Resilience layer (counterpart of heat_tpu/resilience): deterministic
fault injection, retrying atomic IO, and divergence guards.

A lost rank, a torn file or a failed rendezvous aborts a whole SPMD
program.  This subsystem makes failure a first-class, deterministically
testable scenario across four layers, each with the reference's names,
plan format, env knobs and counters:

* :mod:`~heat_tpu_torch.resilience.faults` — seeded fault injector wired
  through named injection points (``comm.init``, ``comm.collective`` (the
  SpGEMM ring's count re-sync), ``io.open``/``io.write``), scriptable
  per call index via a plan dict or the ``HEAT_TPU_FAULT_PLAN`` env
  hook.
* :mod:`~heat_tpu_torch.resilience.retry` — :class:`RetryPolicy`
  (bounded exponential backoff, deterministic no-sleep test mode,
  per-attempt timeout, typed retryable filter) applied to
  ``parallel.init()`` and the io loads/saves.
* :mod:`~heat_tpu_torch.resilience.atomic` — write-temp-fsync-rename
  with CRC32 sidecars: torn writes are never visible, corrupt files
  fail loudly (:class:`ChecksumError`).
* :mod:`~heat_tpu_torch.resilience.guard` — :func:`guard_finite` /
  :class:`DivergenceError` for NaN/Inf divergence in iterative fits,
  carrying the last finite iterate.

Checkpointing (:mod:`heat_tpu_torch.utils.checkpoint`) and the resumable
fits (:func:`heat_tpu_torch.core.base.resumable_fit_loop`) build on these.
"""

from __future__ import annotations

from .errors import (
    ChecksumError,
    DivergenceError,
    NoReplicaError,
    OverloadedError,
    PermanentFault,
    PreemptedError,
    ReshapeError,
    ResilienceError,
    TransientFault,
    WorkerLostError,
)
from .faults import (
    FaultInjector,
    active_injector,
    fault_plan,
    fault_stats,
    inject,
    refresh_env_plan,
    reset_fault_stats,
)
from .retry import (
    RetryPolicy,
    RetryTimeout,
    default_init_policy,
    default_io_policy,
    reset_retry_stats,
    retry_stats,
)
from .atomic import (
    atomic_write,
    checksum_path,
    crc32_file,
    read_checksum,
    verify_checksum,
    write_checksum,
)
from .guard import all_finite, guard_finite

__all__ = [
    "ChecksumError",
    "DivergenceError",
    "FaultInjector",
    "PermanentFault",
    "NoReplicaError",
    "OverloadedError",
    "PreemptedError",
    "ReshapeError",
    "ResilienceError",
    "RetryPolicy",
    "RetryTimeout",
    "TransientFault",
    "WorkerLostError",
    "active_injector",
    "all_finite",
    "atomic_write",
    "checksum_path",
    "crc32_file",
    "default_init_policy",
    "default_io_policy",
    "fault_plan",
    "fault_stats",
    "guard_finite",
    "inject",
    "read_checksum",
    "refresh_env_plan",
    "reset_fault_stats",
    "reset_retry_stats",
    "retry_stats",
    "verify_checksum",
    "write_checksum",
    "resilience_stats",
]


def resilience_stats() -> dict:
    """One merged counter snapshot (faults + retries)."""
    out = dict(fault_stats())
    out.update(retry_stats())
    return out
