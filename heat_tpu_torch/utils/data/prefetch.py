"""Look-ahead staging of batches on the card (counterpart of
heat_tpu/utils/data/prefetch.py).

:func:`prefetch_to_device` wraps an iterator of batches: it keeps the next
``size`` batches staged on the card while the consumer computes on the
current one.  Each tensor is pinned in host memory and copied on a side
CUDA stream, and an event is recorded after the copies; before a staged
batch is handed out the consumer's stream waits on that event, and each
tensor is marked as used on the consumer's stream (``record_stream``) so
that the allocator does not reuse its memory early.  On the CPU a batch is
handed out as it is.

Counters: a batch that was staged before the consumer asked for it is a
hit (:data:`PREFETCH_HITS`), one staged on demand a miss
(:data:`PREFETCH_MISSES`); :func:`prefetch_stats` reads both.  They move
into ``utils.overlap.overlap_stats`` with ROADMAP item 15b.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from ...core.devices import sanitize_device
from ...core.dndarray import DNDarray

__all__ = ["prefetch_stats", "prefetch_to_device", "sharding_for_batch"]

#: batches handed out that were staged ahead of the consumer
PREFETCH_HITS = 0
#: batches staged on demand (the look-ahead ran dry)
PREFETCH_MISSES = 0


def prefetch_stats(reset: bool = False) -> dict:
    """``{"prefetch_hits": ..., "prefetch_misses": ...}`` of this process;
    ``reset`` sets both to 0 after reading them."""
    global PREFETCH_HITS, PREFETCH_MISSES
    out = {"prefetch_hits": PREFETCH_HITS, "prefetch_misses": PREFETCH_MISSES}
    if reset:
        PREFETCH_HITS = PREFETCH_MISSES = 0
    return out


def sharding_for_batch(batch_extent: int, comm=None, split: int = 0) -> Optional[Tuple[int, int]]:
    """This rank's rows ``(lo, hi)`` of a batch of ``batch_extent`` rows in
    the canonical layout (the reference's split sharding), or None where
    the extent does not tile the ranks (the reference's default
    placement).  ``split`` names the batch axis, as there."""
    from ...parallel.comm import sanitize_comm

    comm = sanitize_comm(comm)
    if comm.size > 0 and batch_extent % comm.size == 0:
        lo, lshape, _ = comm.chunk((batch_extent,), 0)
        return lo, lo + lshape[0]
    return None


def _leaves(batch: Any, fn):
    """``batch`` with ``fn`` applied to every tensor, DNDarray and numpy
    array in it (tuples, lists and dicts are walked); other values as they
    are."""
    if isinstance(batch, (tuple, list)):
        return type(batch)(_leaves(b, fn) for b in batch)
    if isinstance(batch, dict):
        return {k: _leaves(v, fn) for k, v in batch.items()}
    if isinstance(batch, (torch.Tensor, DNDarray, np.ndarray)):
        return fn(batch)
    return batch


class _DevicePrefetcher:
    """A bounded look-ahead of batches staged on ``device``."""

    def __init__(self, it: Iterable, size: int, rows: Optional[Tuple[int, int]], device):
        self._it: Optional[Iterator] = iter(it)
        self._size = size
        self._rows = rows
        self._device = sanitize_device(device)
        dev = self._device.torch_device
        self._stream = torch.cuda.Stream(device=dev) if dev.type == "cuda" else None
        self._buf: "deque" = deque()
        self._fill()  # batches 0 .. size-1 staged before the first is asked for

    def _copy(self, t: torch.Tensor) -> torch.Tensor:
        dev = self._device.torch_device
        if self._rows is not None and t.ndim:
            t = t[self._rows[0]:self._rows[1]]
        if self._stream is None or t.device == dev:
            return t.to(dev)
        src = t.pin_memory() if t.device.type == "cpu" else t
        with torch.cuda.stream(self._stream):
            return src.to(dev, non_blocking=True)

    def _stage_leaf(self, x):
        if isinstance(x, DNDarray):
            if x.larray_padded.device == self._device.torch_device:
                return x
            local = self._copy(x.larray_padded) if self._rows is None else self._copy(x.larray)
            if self._rows is not None:
                return DNDarray(local, tuple(local.shape), x.dtype, None, self._device, x.comm)
            return DNDarray(local, x.gshape, x.dtype, x.split, self._device, x.comm)
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x))
        return self._copy(x)

    def _stage(self, batch):
        if self._stream is not None:
            # the side stream's copies follow the work queued before them
            self._stream.wait_stream(torch.cuda.current_stream(self._device.torch_device))
        staged = _leaves(batch, self._stage_leaf)
        done = None
        if self._stream is not None:
            done = torch.cuda.Event()
            done.record(self._stream)
        return staged, done

    def _fill(self) -> None:
        while self._it is not None and len(self._buf) < self._size:
            try:
                nxt = next(self._it)
            except StopIteration:
                self._it = None
                return
            self._buf.append(self._stage(nxt))

    def __iter__(self) -> "_DevicePrefetcher":
        return self

    def __next__(self):
        global PREFETCH_HITS, PREFETCH_MISSES
        if self._buf:
            PREFETCH_HITS += 1
            staged, done = self._buf.popleft()
        elif self._it is None:
            raise StopIteration
        else:  # the look-ahead ran dry: stage on demand
            staged, done = self._stage(next(self._it))
            PREFETCH_MISSES += 1
        if done is not None:
            stream = torch.cuda.current_stream(self._device.torch_device)
            stream.wait_event(done)

            def used(x):
                t = x.larray_padded if isinstance(x, DNDarray) else x
                if t.is_cuda:
                    t.record_stream(stream)
                return x

            _leaves(staged, used)
        self._fill()  # start the next copies at once
        return staged

    def close(self) -> None:
        """Release the source iterator without draining it (a generator's
        ``finally`` blocks run); idempotent, the iterator is exhausted
        afterwards."""
        it, self._it = self._it, None
        self._buf.clear()
        closer = getattr(it, "close", None)
        if callable(closer):
            closer()

    def __enter__(self) -> "_DevicePrefetcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def prefetch_to_device(it: Iterable, size: int = 2, sharding: Optional[Tuple[int, int]] = None,
                       device=None) -> Iterator:
    """Wrap ``it`` so that batches are staged on ``device`` (the default
    device, the card unless the caller chose the CPU) ``size`` batches
    ahead.  A batch is a tensor, DNDarray or numpy array, or a tuple, list
    or dict of them (other values pass through).  ``sharding`` (the rows
    :func:`sharding_for_batch` gives) cuts every leaf to this rank's rows
    first.  The order is kept; the returned iterator can be closed, also
    as a context manager."""
    if size < 1:
        raise ValueError(f"prefetch size must be >= 1, got {size}")
    return _DevicePrefetcher(it, size, sharding, device)
