"""Batch-parallel clustering (counterpart of
heat_tpu/cluster/batchparallelclustering.py).

With p ranks, the first p (n // p) rows make p batches of n // p rows (the
remainder is dropped; these are not the canonical chunks): batch r reaches
rank r by one exchange, rank r seeds it by k-means++ and runs its Lloyd
(or Lloyd-median) loop, one all-gather stacks the p k centres on every
rank, and one more seeded loop clusters them.  The keys are the JAX
package's: ``split(PRNGKey(seed), p + 1)``, key r for batch r, the last
for the merge, so the centres are the reference's.

Distances take the reference's direct form ``sum((x - c)^2)``, row blocks
of at most ``_BLOCK_ELEMENTS`` (no (n, k, f) tensor); the per-cluster sums
are one-hot products of each block in IEEE float32; medians are each
cluster's own members, sorted feature by feature.  Each loop reads its
stop test once an iteration on the host.
"""

from __future__ import annotations

import torch

from ..core import arithmetics, types
from ..core import random as ht_random
from ..core.base import BaseEstimator, ClusteringMixin
from ..core.dndarray import DNDarray, _move_rows, _owned
from ..core.linalg.basics import full_f32_matmul
from ..spatial.distance import _BLOCK_ELEMENTS

__all__ = ["BatchParallelKMeans", "BatchParallelKMedians"]

_HOST = torch.device("cpu")


def _block_rows(X: torch.Tensor, k: int) -> int:
    """Rows of X whose (rows, k, f) difference fits the block budget."""
    return max(1, _BLOCK_ELEMENTS // max(1, k * X.shape[1]))


def _blocks(X: torch.Tensor, k: int):
    return torch.split(X, _block_rows(X, k))


def _sq_dist(Xb: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """``sum((x - c)^2, -1)`` of a block against the centres: (rows, k)."""
    return ((Xb[:, None, :] - centers[None, :, :]) ** 2).sum(-1)


def _nearest(X: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """Each row's nearest centre in the direct form (the first on ties)."""
    if X.shape[0] == 0:
        return torch.zeros(0, dtype=torch.int64, device=X.device)
    return torch.cat([_sq_dist(b, centers).argmin(1) for b in _blocks(X, centers.shape[0])])


def _kmeans_plus_plus(key, X: torch.Tensor, k: int) -> torch.Tensor:
    """k-means++ seeding of one batch, the reference's draws: the first row
    by ``randint(sub, (), 0, n)``, each next one the first whose cumulative
    D^2 share reaches ``uniform(sub, ())`` (float64), a new subkey a round.
    The running minimum over the centres so far equals the reference's
    minimum over all of them (a minimum is exact); the cumulative sum runs
    in a fixed order (``arithmetics._CUMSUM``)."""
    n = X.shape[0]
    key, sub = ht_random._split(key)
    idx0 = int(ht_random._randint(sub, (), 0, n, types.int64, _HOST))
    centers = torch.zeros((k, X.shape[1]), dtype=X.dtype, device=X.device)
    centers[0] = X[idx0]
    d2 = torch.full((n,), float("inf"), dtype=X.dtype, device=X.device)
    for i in range(1, k):
        newest = centers[i - 1:i]
        d2 = torch.minimum(d2, torch.cat([_sq_dist(b, newest)[:, 0] for b in _blocks(X, 1)]))
        key, sub = ht_random._split(key)
        probs = d2 / torch.clamp(d2.sum(), min=1e-30)
        u = ht_random._uniform(sub, (), types.float64, _HOST).to(X.device)
        cum = arithmetics._CUMSUM(probs, 0).to(torch.float64)
        nxt = torch.searchsorted(cum, u.reshape(1)).clamp(max=n - 1)
        centers[i] = X[nxt[0]]
    return centers


def _cluster_sums(X: torch.Tensor, labels: torch.Tensor, k: int) -> torch.Tensor:
    """Per-cluster sums, the reference's ``one_hot.T @ X`` a row block at a
    time (IEEE float32, no float atomics)."""
    sums = torch.zeros((k, X.shape[1]), dtype=X.dtype, device=X.device)
    ids = torch.arange(k, device=X.device)
    with full_f32_matmul():
        for xb, lb in zip(_blocks(X, k), torch.split(labels, _block_rows(X, k))):
            sums += (lb[:, None] == ids[None, :]).to(X.dtype).T @ xb
    return sums


def _member_medians(X: torch.Tensor, labels: torch.Tensor, centers: torch.Tensor, counts: torch.Tensor):
    """``jnp.nanmedian`` of each cluster's members, feature by feature (the
    mean of the two middle non-NaN values, in X's type), cluster by
    cluster; an empty cluster keeps its centre."""
    from ..core.napi import _jnp_quantile

    new = centers.clone()
    half = torch.tensor(0.5, dtype=X.dtype, device=X.device)
    for j in range(centers.shape[0]):
        if int(counts[j]) == 0:
            continue
        new[j] = _jnp_quantile(X[labels == j], half, 0, "midpoint", False, True)
    return new


def _lloyd_batch(key, X: torch.Tensor, k: int, max_iter: int, tol: float, medians: bool) -> torch.Tensor:
    """One batch's seeded k-means (k-medians) loop, ``while i < max_iter and
    shift > tol`` with the squared centre movement as the shift."""
    centers = _kmeans_plus_plus(key, X, k)
    tol_t = torch.tensor(tol, dtype=X.dtype, device=X.device)
    i, moving = 0, True
    while i < max_iter and moving:
        labels = _nearest(X, centers)
        counts = torch.bincount(labels, minlength=k)
        if medians:
            new = _member_medians(X, labels, centers, counts)
        else:
            c = counts.to(X.dtype)[:, None]
            new = torch.where(c > 0, _cluster_sums(X, labels, k) / torch.clamp(c, min=1.0), centers)
        moving = bool(((new - centers) ** 2).sum() > tol_t)
        centers = new
        i += 1
    return centers


def _my_batch(x: DNDarray, per: int) -> torch.Tensor:
    """Rows [rank per, (rank + 1) per) of split=0 (or unsplit) points on
    this rank: one exchange from the canonical chunks."""
    comm = x.comm
    if x.split is None:
        return x.larray[comm.rank * per:(comm.rank + 1) * per]
    runs = [(lo, hi - lo) for lo, hi in (_owned(comm, x.shape, 0, r) for r in range(comm.size))]
    ranges = [(r * per, (r + 1) * per) for r in range(comm.size)]
    return _move_rows(comm, x.larray, 0, runs, ranges)


class _BatchParallelKCluster(BaseEstimator, ClusteringMixin):
    """Shared machinery of the batch-parallel estimators."""

    def __init__(self, n_clusters, max_iter, tol, random_state, n_procs_to_merge, medians: bool):
        self.n_clusters = n_clusters
        self.max_iter = max_iter
        self.tol = tol
        self.random_state = random_state
        self.n_procs_to_merge = n_procs_to_merge
        self._medians = medians
        self._cluster_centers = None
        self._labels = None

    @property
    def cluster_centers_(self) -> DNDarray:
        return self._cluster_centers

    @property
    def labels_(self) -> DNDarray:
        return self._labels

    def fit(self, x: DNDarray):
        if not isinstance(x, DNDarray):
            raise TypeError(f"input needs to be a DNDarray, but was {type(x)}")
        if x.ndim != 2:
            raise ValueError(f"input needs to be 2D, but was {x.ndim}D")
        if x.split not in (0, None):
            raise ValueError(f"input needs to be split along the sample axis (0), but is split={x.split}")
        if not types.heat_type_is_inexact(x.dtype):
            x = x.astype(types.float32)
        k, n, p = self.n_clusters, x.shape[0], x.comm.size
        key = ht_random._key_from_seed(self.random_state if self.random_state is not None else 0)
        if p > 1 and n >= p * k:
            keys = ht_random._split(key, p + 1)
            mine = _lloyd_batch(keys[x.comm.rank], _my_batch(x, n // p), k, self.max_iter, self.tol, self._medians)
            stacked = x.comm.all_gather(mine.contiguous(), axis=0)
            final = _lloyd_batch(keys[p], stacked, k, self.max_iter, self.tol, self._medians)
        else:
            final = _lloyd_batch(key, x._dense(), k, self.max_iter, self.tol, self._medians)
        self._cluster_centers = DNDarray.from_dense(final, None, x.device, x.comm)
        self._labels = self.predict(x)
        return self

    def predict(self, x: DNDarray) -> DNDarray:
        """Each row's nearest centre (int32), on this rank's own rows."""
        if self._cluster_centers is None:
            raise RuntimeError("fit needs to be called before predict")
        local = x.larray_padded
        if not types.heat_type_is_inexact(x.dtype):
            local = local.to(torch.float32)
        centers = self._cluster_centers.larray.to(local.device, local.dtype)
        labels = _nearest(local, centers).to(torch.int32)
        return x._like(labels, (x.shape[0],), x.split)


class BatchParallelKMeans(_BatchParallelKCluster):
    """Batch-parallel K-Means: k-means++ and Lloyd on each rank's batch,
    then on the gathered centres."""

    def __init__(self, n_clusters=8, init="k-means++", max_iter=300, tol=1e-4, random_state=None,
                 n_procs_to_merge=None):
        if not isinstance(init, str):
            raise TypeError(f"init must be str, but was {type(init)}")
        if init not in ("k-means++", "++", "random"):
            raise ValueError(f'init must be "k-means++" or "random", but was {init}')
        super().__init__(n_clusters, max_iter, tol, random_state, n_procs_to_merge, medians=False)
        self.init = init


class BatchParallelKMedians(_BatchParallelKCluster):
    """Batch-parallel K-Medians: k-means++ seeding and median updates on
    each rank's batch, then on the gathered centres."""

    def __init__(self, n_clusters=8, init="k-medians++", max_iter=300, tol=1e-4, random_state=None,
                 n_procs_to_merge=None):
        if not isinstance(init, str):
            raise TypeError(f"init must be str, but was {type(init)}")
        if init not in ("k-medians++", "++", "random"):
            raise ValueError(f'init must be "k-medians++" or "random", but was {init}')
        super().__init__(n_clusters, max_iter, tol, random_state, n_procs_to_merge, medians=True)
        self.init = init
