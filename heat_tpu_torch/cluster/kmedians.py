"""KMedians (counterpart of heat_tpu/cluster/kmedians.py).

Each iteration labels the points by their nearest centre in city-block
distance and moves every centre with members to the feature-wise median of
its members, ``jnp.nanmedian``'s: the midpoint ``(low + high) * 0.5``, in
the points' type, of the two middle order statistics of the non-NaN values
(one and the same for an odd count), NaN where there is none; a centre
without members stays.  It stops when ``sum((new - c)^2)``, in float32, is
at most ``tol`` or after ``max_iter`` iterations.

No point is gathered.  The two order statistics of every (cluster,
feature) are found exactly across the ranks by bisection over the
order-preserving integer image of the values (:func:`_ordered`): each of
the 32 rounds (64 for float64 points) counts, on each rank's own rows, the
members at or below each pivot and sums the k x f x 2 counts with one psum.
An iteration reads the host k + 1 times: the size of each centre's members
on this rank, and the shift.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from ..core.dndarray import DNDarray
from ..spatial import distance
from ._kcluster import _KCluster, _fit_input, _members

__all__ = ["KMedians"]

_KEY_TYPES = {torch.float16: torch.int16, torch.bfloat16: torch.int16, torch.float32: torch.int32,
              torch.float64: torch.int64}


def _ordered(x: torch.Tensor) -> torch.Tensor:
    """The values of x as signed integers of their width in the values'
    order (a float's bits, the magnitude bits flipped where it is negative);
    NaN last of all."""
    kind = _KEY_TYPES[x.dtype]
    bits = x.view(kind)
    top = torch.iinfo(kind).max
    key = torch.bitwise_xor(bits, (bits >> (bits.element_size() * 8 - 1)) & top)
    return key.masked_fill_(torch.isnan(x), top)


def _from_ordered(key: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The values whose :func:`_ordered` keys are ``key`` (int64 holding
    keys of ``dtype``'s width)."""
    kind = _KEY_TYPES[dtype]
    key = key.to(kind)
    return torch.bitwise_xor(key, (key >> (key.element_size() * 8 - 1)) & torch.iinfo(kind).max).view(dtype)


def _order_statistics(keys, ranks: torch.Tensor, reduce) -> torch.Tensor:
    """The keys of the order statistics ``ranks`` (k, f, s; 0-based) of each
    centre's members along each feature: for each, the least pivot at or
    below which more than ``rank`` members' keys lie, by bisection over the
    keys' whole range (one round per bit).  ``keys[j]`` holds this rank's
    keys of centre j's members feature by feature, (f, rows), so that each
    count runs along a contiguous axis; ``reduce`` sums the counts over the
    ranks."""
    info = torch.iinfo(keys[0].dtype)
    lo = torch.full(ranks.shape, info.min, dtype=torch.int64, device=ranks.device)
    hi = torch.full(ranks.shape, info.max, dtype=torch.int64, device=ranks.device)
    for _ in range(info.bits):
        mid = (lo >> 1) + (hi >> 1) + (lo & hi & 1)  # floor((lo + hi) / 2) without overflow
        pivot = mid.to(keys[0].dtype)
        below = torch.stack([(kj[:, None, :] <= pivot[j][:, :, None]).sum(-1) for j, kj in enumerate(keys)])
        enough = reduce(below) > ranks
        hi = torch.where(enough, mid, hi)
        lo = torch.where(enough, lo, mid + 1)
    return lo


def _medians(x: DNDarray, key: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """One KMedians update of ``centers`` (k, f) on x, whose values'
    :func:`_ordered` keys are ``key``: the members' medians, the old centre
    where a centre has none."""
    members, counts, reduce = _members(x, centers)
    keys = [key[m].T.contiguous() for m in members]
    # members with a value (not NaN) of each feature
    valued = reduce(torch.stack([(kj != torch.iinfo(key.dtype).max).sum(1) for kj in keys]))
    ranks = torch.stack([(valued - 1) // 2, valued // 2], dim=-1).clamp_(min=0)
    stats = _order_statistics(keys, ranks, reduce)
    low, high = _from_ordered(stats[..., 0], x.larray.dtype), _from_ordered(stats[..., 1], x.larray.dtype)
    med = torch.where(valued > 0, (low + high) * 0.5, float("nan"))
    return torch.where(counts[:, None] > 0, med, centers)


class KMedians(_KCluster):
    """K-Medians with city-block assignment."""

    def __init__(
        self,
        n_clusters: int = 8,
        init: Union[str, DNDarray] = "random",
        max_iter: int = 300,
        tol: float = 1e-4,
        random_state: Optional[int] = None,
        checkpoint_every: Optional[int] = None,
        checkpoint_dir: Optional[str] = None,
        resume_from: Optional[str] = None,
    ):
        if isinstance(init, str) and init == "kmedians++":
            init = "probability_based"
        super().__init__(
            metric=lambda x, y: distance.manhattan(x, y),
            n_clusters=n_clusters,
            init=init,
            max_iter=max_iter,
            tol=tol,
            random_state=random_state,
            checkpoint_every=checkpoint_every,
            checkpoint_dir=checkpoint_dir,
            resume_from=resume_from,
        )

    def fit(self, x: DNDarray) -> "KMedians":
        """Median updates while the shift exceeds ``tol`` (compared in
        float32, as the reference's loop does), at most ``max_iter``; then
        one assignment for ``labels_`` and ``inertia_``."""
        x = _fit_input(x)
        self._initialize_cluster_centers(x)
        centers = self._cluster_centers.larray
        key = _ordered(x.larray)
        tol = float(np.float32(self.tol))
        i, shift = 0, float("inf")
        while i < self.max_iter and shift > tol:
            new = _medians(x, key, centers)
            shift = float(torch.sum((new - centers) ** 2).to(torch.float32))
            centers, i = new, i + 1
        self._n_iter = i
        self._cluster_centers = DNDarray.from_dense(centers, None, x.device, x.comm)
        self._labels = self._assign_to_cluster(x, eval_functional_value=True)
        return self
