"""Out-of-core datasets streamed in windows (counterpart of
heat_tpu/utils/data/partial_dataset.py).

:class:`PartialH5Dataset` reads an HDF5 dataset a window of rows at a
time; its iterator, :class:`PartialH5DataLoaderIter`, reads window i + 1 on
a loader thread (:func:`queue_thread`) while the consumer works on window
i, and stages each window as a DNDarray on the default device: split along
its rows where they tile the ranks, whole on every rank otherwise (the
reference's split sharding and default placement).  A window that was
ready when the consumer asked for it is a prefetch hit, else a miss
(``prefetch_hits``/``prefetch_misses`` of the overlap counters).  ``h5py`` is imported
where a file is opened, so that importing the package never needs it: a
subclass that overrides :meth:`PartialH5Dataset.read_window` (and sets
``length``, ``load_length``, ``transforms``, ``dataset_names``, ``comm``)
streams from any source.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import List, Optional

import numpy as np
import torch

from ..overlap import _bump
from ...core.devices import sanitize_device
from ...core.dndarray import DNDarray

__all__ = ["PartialH5Dataset", "PartialH5DataLoaderIter", "queue_thread"]


def queue_thread(q: "queue.Queue") -> None:
    """A loader thread's loop (heat's partial_dataset.py:20): take a
    ``(func, *args)`` tuple or a callable off the queue, run it and mark the
    item done; ``None`` ends the loop."""
    while True:
        items = q.get()
        if items is None:
            q.task_done()
            return
        if isinstance(items, tuple):
            items[0](*items[1:])
        else:
            items()
        q.task_done()


class PartialH5Dataset:
    """An HDF5 dataset streamed in windows of ``load_length`` rows (heat's
    partial_dataset.py:32).  ``comm`` is the communication the windows are
    split over (by default the current one)."""

    def __init__(self, file: str, comm=None, dataset_names: Optional[List[str]] = None, initial_load: int = 7000,
                 load_length: int = 1000, use_gpu: bool = True, np_buffer: bool = True,
                 np_buffer_dataset_names: Optional[List[str]] = None, transforms=None):
        import h5py

        self.file = file
        self.comm = comm
        self.dataset_names = dataset_names or ["data"]
        self.initial_load = initial_load
        self.load_length = load_length
        self.transforms = transforms
        with h5py.File(file, "r") as f:
            self.length = f[self.dataset_names[0]].shape[0]

    def read_window(self, start: int, stop: int) -> List[np.ndarray]:
        """The rows ``[start, stop)`` of every named dataset (runs on the
        loader thread)."""
        import h5py

        with h5py.File(self.file, "r") as f:
            return [np.asarray(f[name][start:stop]) for name in self.dataset_names]

    def __len__(self) -> int:
        return self.length

    def __iter__(self) -> "PartialH5DataLoaderIter":
        return PartialH5DataLoaderIter(self)


class PartialH5DataLoaderIter:
    """The windows of a :class:`PartialH5Dataset`, in order (heat's
    partial_dataset.py:224): a daemon thread reads and stages the next
    window while the current one is consumed."""

    #: how long close() waits for a loader thread stuck in a read
    _CLOSE_TIMEOUT_S = 10.0

    def __init__(self, dataset: PartialH5Dataset):
        from ...parallel.comm import sanitize_comm

        self._ds = dataset
        self._comm = sanitize_comm(getattr(dataset, "comm", None))
        self._device = sanitize_device(None)
        self._pos = 0
        self._work: "queue.Queue" = queue.Queue()
        self._ready: "queue.Queue" = queue.Queue(maxsize=2)
        # close() may race itself (the consumer's end, an error, __del__):
        # one caller alone retires the thread
        self._lifecycle = threading.Lock()
        self._thread = threading.Thread(target=queue_thread, args=(self._work,), daemon=True)
        self._thread.start()
        self._windows_queued = 0
        self._queue_next_read()  # start the pipeline

    def _stage(self, chunk: np.ndarray) -> DNDarray:
        """One window on the default device: split along its rows where they
        tile the ranks, else whole on every rank."""
        t = torch.from_numpy(np.ascontiguousarray(chunk))
        split = 0 if t.ndim >= 1 and t.shape[0] % self._comm.size == 0 else None
        return DNDarray.from_dense(t, split, self._device, self._comm)

    def _read_window(self, start: int, stop: int) -> None:
        try:
            out = []
            for chunk in self._ds.read_window(start, stop):
                arr = self._stage(chunk)
                if self._ds.transforms is not None and callable(self._ds.transforms):
                    arr = self._ds.transforms(arr)
                out.append(arr)
            if self._device.torch_device.type == "cuda":
                torch.cuda.current_stream(self._device.torch_device).synchronize()
            self._ready.put(out[0] if len(out) == 1 else tuple(out))
        except BaseException as e:  # handed to the consumer, which raises it
            self._ready.put(e)

    def _queue_next_read(self) -> None:
        if self._pos >= self._ds.length:
            return
        stop = min(self._pos + self._ds.load_length, self._ds.length)
        self._work.put((self._read_window, self._pos, stop))
        self._pos = stop
        self._windows_queued += 1

    def close(self) -> None:
        """Retire the loader thread (idempotent): the thread may wait to put
        a window into the full ready queue, so windows are drained until it
        takes the end marker, for at most ``_CLOSE_TIMEOUT_S``."""
        lifecycle = getattr(self, "_lifecycle", None)
        if lifecycle is None:  # __init__ failed before the thread existed
            return
        with lifecycle:
            t, self._thread = self._thread, None
        if t is None:
            return
        self._work.put(None)
        deadline = time.monotonic() + self._CLOSE_TIMEOUT_S
        while t.is_alive() and time.monotonic() < deadline:
            try:
                self._ready.get_nowait()
            except queue.Empty:
                pass
            t.join(timeout=0.02)
        self._windows_queued = 0

    def __del__(self):
        self.close()

    def __iter__(self):
        return self

    def __next__(self):
        if self._windows_queued == 0 or self._thread is None:
            self.close()
            raise StopIteration
        _bump("prefetch_misses" if self._ready.empty() else "prefetch_hits")
        batch = self._ready.get()
        self._windows_queued -= 1
        if isinstance(batch, BaseException):
            self.close()
            raise batch
        self._queue_next_read()  # the next read overlaps this window's use
        return batch
