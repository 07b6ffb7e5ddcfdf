"""Data loading (counterpart of heat_tpu/utils/data/datatools.py).

A :class:`Dataset` holds one or more DNDarrays that share the sample axis,
and :class:`DataLoader` iterates minibatches of it.  A minibatch is the
rows of its indices, taken by DNDarray indexing: for a split array each
rank answers the indices whose rows it holds and one exchange lays the
batch out split along its rows (no rank gathers the dataset).  The epoch
shuffle draws ``random.randperm`` (bitwise the reference's draw) on the
data's device.  :func:`dataset_ishuffle` starts a shuffle of the whole
dataset on a side CUDA stream and :func:`dataset_irecv` waits for it
before installing the shuffled arrays (on the CPU both run in order).
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence, Union

import torch

from ...core import random
from ...core.dndarray import DNDarray

__all__ = ["DataLoader", "Dataset", "dataset_shuffle", "dataset_ishuffle", "dataset_irecv"]


class Dataset:
    """Aligned DNDarrays over one sample axis (heat's datatools.py:144);
    ``transforms[i]`` (a callable or None) is applied to the i-th array's
    minibatch."""

    def __init__(self, array: Union[DNDarray, Sequence[DNDarray]], transforms=None, ishuffle: bool = False):
        arrays = [array] if isinstance(array, DNDarray) else list(array)
        if not arrays:
            raise ValueError("Dataset needs at least one array")
        n = arrays[0].shape[0]
        for a in arrays:
            if a.shape[0] != n:
                raise ValueError("all arrays must share the sample dimension")
        self.arrays = arrays
        self.transforms = transforms if transforms is not None else []
        self.ishuffle = ishuffle

    def __len__(self) -> int:
        return self.arrays[0].shape[0]

    def __getitem__(self, index):
        items = []
        for i, a in enumerate(self.arrays):
            key = index
            if isinstance(index, torch.Tensor):
                key = index.to(a.larray_padded.device)
            item = a[key]
            t = self.transforms[i] if i < len(self.transforms) else None
            items.append(t(item) if callable(t) else item)
        return items[0] if len(items) == 1 else tuple(items)

    def Shuffle(self) -> None:
        """A random permutation of the sample axis (heat's
        ``Dataset.Shuffle``, datatools.py:200)."""
        dataset_shuffle(self)

    def Ishuffle(self) -> None:
        """Start a shuffle, completed by :func:`dataset_irecv`
        (``Dataset.Ishuffle``, datatools.py:210)."""
        dataset_ishuffle(self)


class DataLoader:
    """Minibatches of a :class:`Dataset` (heat's datatools.py:16): ``shuffle``
    draws a new permutation each epoch, ``drop_last`` drops a short last
    batch, ``ishuffle`` completes the shuffle started in the previous epoch
    and starts the next, ``prefetch=N`` stages the next N batches on the
    card ahead of the consumer (:func:`~heat_tpu_torch.utils.data.prefetch.
    prefetch_to_device`)."""

    def __init__(self, dataset: Union[Dataset, DNDarray], batch_size: int = 1, shuffle: bool = True,
                 drop_last: bool = False, ishuffle: bool = False, prefetch: int = 0):
        if isinstance(dataset, DNDarray):
            dataset = Dataset(dataset)
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.ishuffle = ishuffle
        self.prefetch = int(prefetch)
        self._epoch = 0
        self._live_prefetcher = None

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def __iter__(self) -> Iterator:
        if self.prefetch > 0:
            from .prefetch import prefetch_to_device

            # kept so that close() can release an epoch not consumed to its end
            self._live_prefetcher = prefetch_to_device(self._batches(), size=self.prefetch)
            return self._live_prefetcher
        return self._batches()

    def close(self) -> None:
        """Release the last prefetched epoch's iterator without draining it
        (idempotent)."""
        p, self._live_prefetcher = self._live_prefetcher, None
        if p is not None:
            p.close()

    def _batches(self) -> Iterator:
        if self.ishuffle or getattr(self.dataset, "ishuffle", False):
            # complete the shuffle started at the end of the previous epoch
            dataset_irecv(self.dataset)
            dataset_ishuffle(self.dataset)
        n = len(self.dataset)
        device = self.dataset.arrays[0].device
        if self.shuffle:
            perm = random.randperm(n, device=device).larray
        else:
            perm = torch.arange(n, device=device.torch_device)
        self._epoch += 1
        for start in range(0, n, self.batch_size):
            idx = perm[start:start + self.batch_size]
            if self.drop_last and idx.numel() < self.batch_size:
                return
            yield self.dataset[idx]


def dataset_shuffle(dataset: Dataset, attrs: Optional[List] = None) -> None:
    """Shuffle the sample axis in place (heat's datatools.py:247): the start
    and the completion back to back."""
    dataset_ishuffle(dataset, attrs)
    dataset_irecv(dataset)


def dataset_ishuffle(dataset: Dataset, attrs: Optional[List] = None) -> None:
    """Start a shuffle of the sample axis (heat's datatools.py:305): one
    permutation for every array, the rows gathered on a side stream of the
    card (which first waits for the work queued before it); the shuffled
    arrays wait on the dataset for :func:`dataset_irecv`."""
    n = len(dataset)
    device = dataset.arrays[0].device
    perm = random.randperm(n, device=device).larray
    side = torch.cuda.Stream(device=perm.device) if perm.is_cuda else None
    if side is not None:
        side.wait_stream(torch.cuda.current_stream(perm.device))
        with torch.cuda.stream(side):
            pending = [a[perm] for a in dataset.arrays]
        done = torch.cuda.Event()
        done.record(side)
    else:
        pending, done = [a[perm] for a in dataset.arrays], None
    dataset._pending_shuffle = (pending, done)


def dataset_irecv(dataset: Dataset) -> None:
    """Complete a shuffle started by :func:`dataset_ishuffle` (heat's
    datatools.py:344): the consumer's stream waits for the side stream's
    event, the shuffled tensors are marked as used on it, and the arrays
    are installed in place."""
    pending = getattr(dataset, "_pending_shuffle", None)
    if pending is None:
        return
    arrays, done = pending
    if done is not None:
        stream = torch.cuda.current_stream(arrays[0].larray_padded.device)
        stream.wait_event(done)
        for a in arrays:
            a.larray_padded.record_stream(stream)
    dataset.arrays[:] = arrays
    dataset._pending_shuffle = None
