"""Overlap layer: hide host-side latency behind the card's work (counterpart
of heat_tpu/utils/overlap.py).

* :class:`AsyncCheckpointer` takes a snapshot of the state and runs the
  checkpointer's atomic write (staged directory, CRC32 sidecars, one
  rename, io retry policy) on a background writer thread, so that a fit's
  next chunk runs while the step is written.  At most **one** save is in
  flight; a writer error re-raises at the next ``save()``/``wait()``/
  ``close()``.  Fault site: ``checkpoint.async_write`` (evaluated on the
  writer thread once the snapshot has landed, before the write).
* The **overlap counters** (:func:`overlap_stats`): ``async_saves`` /
  ``sync_saves`` / ``ckpt_stall_ms`` from the checkpoint path,
  ``prefetch_hits`` / ``prefetch_misses`` from the device prefetcher
  (:mod:`heat_tpu_torch.utils.data.prefetch`, the partial HDF5 loader) and
  ``grad_buckets`` from the bucketed gradient reduction
  (:func:`heat_tpu_torch.nn.data_parallel.reduce_gradients`).

No collective runs on the writer thread: gloo and NCCL need every rank to
issue its collectives in one order, and a thread racing the fit's would
break it.  So a save gathers each DNDarray leaf on the calling thread and
starts the copies to the host there (``non_blocking`` into pinned memory,
behind one recorded CUDA event); the writer waits on the event, and only
rank 0's writer touches the files.  Each rank's writer records its own
outcome, and the all-reduce that agrees on it runs on the calling thread in
:meth:`AsyncCheckpointer.wait`, at the next save or boundary.

``HEAT_TPU_ASYNC_CKPT=0`` turns the async path off (resumable fits save
synchronously).
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..analysis import tsan as _tsan
from ..resilience.faults import inject as _inject
from ..telemetry import metrics as _tm
from ..telemetry import tracing as _tracing
from ..telemetry.spans import span as _span

__all__ = [
    "AsyncCheckpointer",
    "async_checkpoint_enabled",
    "overlap_stats",
    "reset_overlap_stats",
    "snapshot_state",
]


def async_checkpoint_enabled() -> bool:
    """Whether resumable fits use the async checkpoint path (default on;
    ``HEAT_TPU_ASYNC_CKPT=0`` selects synchronous saves)."""
    v = os.environ.get("HEAT_TPU_ASYNC_CKPT")
    if v is None:
        return True
    return v.strip().lower() not in ("0", "false", "no", "off")


# ----------------------------------------------------------------------
# the overlap counters, ``overlap.*`` in the shared telemetry registry
# ----------------------------------------------------------------------
_COUNTER_NAMES = (
    "async_saves",
    "sync_saves",
    "ckpt_stall_ms",
    "prefetch_hits",
    "prefetch_misses",
    "grad_buckets",
)
_STATS = {n: _tm.counter(f"overlap.{n}") for n in _COUNTER_NAMES}


def _bump(name: str, amount=1) -> None:
    _STATS[name].inc(amount)


def overlap_stats() -> Dict[str, Any]:
    """Snapshot of the overlap counters.

    ``async_saves``/``sync_saves`` count checkpoint writes by schedule;
    ``ckpt_stall_ms`` is the wall time the *caller* spent inside async
    ``save()``/``wait()`` (the snapshot, the agreement and any wait for a
    write still running); ``prefetch_hits``/``prefetch_misses`` count
    batches staged on the card ahead of the consumer against those staged
    on demand (``prefetch_hit_rate`` derives from them); ``grad_buckets``
    counts the collective buckets the bucketed gradient reduction issued."""
    s: Dict[str, Any] = {n: _STATS[n].value for n in _COUNTER_NAMES}
    s["ckpt_stall_ms"] = float(s["ckpt_stall_ms"])
    total = s["prefetch_hits"] + s["prefetch_misses"]
    s["prefetch_hit_rate"] = (s["prefetch_hits"] / total) if total else 0.0
    return s


def reset_overlap_stats() -> None:
    """Zero all overlap counters (``telemetry.reset_all("overlap")``)."""
    from ..telemetry import reset_all

    reset_all("overlap")


# ----------------------------------------------------------------------
# async checkpointing
# ----------------------------------------------------------------------
def _to_host(t: torch.Tensor) -> torch.Tensor:
    """A host copy of ``t``: from the card a ``non_blocking`` copy into
    pinned memory (complete once the stream reaches it), else a clone."""
    t = t.detach()
    if t.is_cuda:
        host = torch.empty(tuple(t.shape), dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        return host
    return t.clone()


def _snapshot(state: Any, cuda: List[bool]) -> Any:
    from ..core.dndarray import DNDarray  # lazy: avoid an import cycle
    from .checkpoint import DNDSnapshot

    if isinstance(state, DNDarray):
        dense = state._dense()  # the gather, on the calling thread
        cuda.append(dense.is_cuda)
        return DNDSnapshot(_to_host(dense), state.split, state.comm.size, state.dtype)
    if isinstance(state, torch.Tensor):
        cuda.append(state.is_cuda)
        return _to_host(state)
    if isinstance(state, np.ndarray):
        return np.array(state, copy=True)
    if isinstance(state, dict):
        return {k: _snapshot(v, cuda) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        out = [_snapshot(v, cuda) for v in state]
        return tuple(out) if isinstance(state, tuple) else out
    return state


def snapshot_state(state: Any) -> Any:
    """A consistent snapshot of a checkpoint payload, taken on the calling
    thread: each DNDarray leaf gathered (a collective) into a
    :class:`~heat_tpu_torch.utils.checkpoint.DNDSnapshot`, each tensor
    copied to the host (from the card a ``non_blocking`` copy into pinned
    memory: synchronize before reading it), each numpy array copied;
    scalars and strings pass through."""
    return _snapshot(state, [])


class AsyncCheckpointer:
    """Non-blocking front end over a
    :class:`~heat_tpu_torch.utils.checkpoint.Checkpointer`.

    ``save(step, state)`` takes the snapshot and hands the atomic write to a
    background writer thread, so a fit overlaps the write with its next
    chunk.  The write path is the synchronous checkpointer's, so every
    atomicity and bitwise-resume guarantee carries over; what changes is
    *when* an error is seen:

    * at most one save is in flight; a second ``save()`` waits for the
      first;
    * a writer error is stored and re-raised at the next ``save()``,
      ``wait()`` or ``close()`` on every rank (the failing rank raises its
      own error, the others one of the same kind) — never swallowed;
    * ``close()`` (or leaving a ``with`` block) drains the writer.

    The read-side methods (``restore``/``latest_step``/``all_steps``/
    ``metadata``/``world_size``) first wait for any write in flight.  Every
    rank of the checkpointer's communication calls each method."""

    def __init__(self, checkpointer, max_pending: int = 1):
        from .checkpoint import Checkpointer  # lazy: avoid an import cycle

        if isinstance(checkpointer, str):
            checkpointer = Checkpointer(checkpointer)
        self.checkpointer = checkpointer
        if max_pending != 1:
            raise ValueError(
                f"AsyncCheckpointer is bounded at exactly 1 in-flight save, "
                f"got max_pending={max_pending!r}"
            )
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        # written by the background writer, swapped out by the fit thread
        self._error_lock = _tsan.register_lock("overlap.async_writer")

    # -- write side -----------------------------------------------------
    def save(self, step: int, state: Any, extra_metadata=None, async_: bool = True) -> None:
        """Enqueue one checkpoint write (or run it synchronously with
        ``async_=False``).  Blocks for the previous write (at most one in
        flight), its agreed outcome and the snapshot."""
        t0 = time.perf_counter()
        self.wait()
        if not async_:
            with _span("checkpoint.save", step=step, mode="sync"):
                self.checkpointer.save(step, state, extra_metadata)
            _bump("sync_saves")
            return
        with _span("checkpoint.save", step=step, mode="async"):
            cuda: List[bool] = []
            snap = _snapshot(state, cuda)
            ready = None
            if any(cuda):
                ready = torch.cuda.Event()
                ready.record()  # after every copy to the host on this stream
            ctx = _tracing.current_context()  # the caller's trace, handed to the writer

            def _write():
                try:
                    with _tracing.use_context(ctx), _span("checkpoint.async_write", step=step):
                        if ready is not None:
                            ready.synchronize()
                        _inject("checkpoint.async_write", step=step)
                        self.checkpointer._save_local(step, snap, extra_metadata)
                except BaseException as e:  # surfaced at the next save/wait/close
                    with self._error_lock:
                        _tsan.note_access("overlap.async_writer.state")
                        self._error = e

        t = threading.Thread(target=_write, name=f"heat-tpu-async-ckpt-{step}", daemon=True)
        self._thread = t
        t.start()
        _bump("async_saves")
        _bump("ckpt_stall_ms", (time.perf_counter() - t0) * 1e3)

    def wait(self) -> None:
        """Block until no write is in flight; every rank re-raises where any
        rank's writer failed (one all-reduce of the outcome, on this
        thread)."""
        from ..core.io import _together

        t = self._thread
        if t is None or t is threading.current_thread():
            return
        t0 = time.perf_counter()
        with _span("checkpoint.drain"):
            t.join()
        self._thread = None
        with self._error_lock:
            _tsan.note_access("overlap.async_writer.state")
            err, self._error = self._error, None

        def outcome():
            if err is not None:
                raise err

        try:
            _together(self.checkpointer.comm, None, outcome, self.directory)
        finally:
            _bump("ckpt_stall_ms", (time.perf_counter() - t0) * 1e3)

    def close(self) -> None:
        """Drain the writer (idempotent); re-raises a pending error."""
        self.wait()

    def __enter__(self) -> "AsyncCheckpointer":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None:
            self.close()
        else:
            # the body's exception wins over a writer error
            try:
                self.close()
            except BaseException:
                pass

    # -- read side (sees in-flight writes through) ----------------------
    def restore(self, step=None, template=None, comm=None):
        """Drain the write in flight, then restore (see
        ``Checkpointer.restore``)."""
        self.wait()
        with _span("checkpoint.restore", step=step if step is not None else -1):
            return self.checkpointer.restore(step, template, comm)

    def latest_step(self):
        self.wait()
        return self.checkpointer.latest_step()

    def world_size(self, step=None):
        self.wait()
        return self.checkpointer.world_size(step)

    def all_steps(self) -> List[int]:
        self.wait()
        return self.checkpointer.all_steps()

    def metadata(self, step: int):
        self.wait()
        return self.checkpointer.metadata(step)

    @property
    def directory(self) -> str:
        return self.checkpointer.directory

    @property
    def comm(self):
        return self.checkpointer.comm
