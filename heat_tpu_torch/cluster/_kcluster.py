"""Shared k-clustering base (counterpart of heat_tpu/cluster/_kcluster.py).

Ported here: ``init="random"``, kmeans++ (``"kmeans++"``,
``"probability_based"``, ``"++"``; KMedians' and KMedoids' ``"kmedians++"``
and ``"kmedoids++"`` map to it) and an explicit array of centres, the
nearest-centre assignment with the fit's inertia, ``predict``, and the
per-cluster member statistics KMedians and KMedoids share
(:func:`_members`).  The checkpoint/resume options are not ported yet and
raise, as does KMeans' low-precision predict scope.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch

from ..core import random as ht_random
from ..core import arithmetics, statistics, types
from ..core.base import BaseEstimator, ClusteringMixin, lazy_scalar_property
from ..core.dndarray import DNDarray
from ..spatial import distance

__all__ = ["_KCluster"]


class _KCluster(BaseEstimator, ClusteringMixin):
    """Base class of k-statistics clustering."""

    def __init__(
        self,
        metric: Callable,
        n_clusters: int,
        init: Union[str, DNDarray],
        max_iter: int,
        tol: float,
        random_state: Optional[int],
        checkpoint_every: Optional[int] = None,
        checkpoint_dir: Optional[str] = None,
        resume_from: Optional[str] = None,
    ):
        if checkpoint_every is not None or checkpoint_dir is not None or resume_from is not None:
            raise NotImplementedError("resumable fits (checkpoint_every, checkpoint_dir, resume_from) are not ported yet")
        self.n_clusters = n_clusters
        self.init = init
        self.max_iter = max_iter
        self.tol = tol
        self.random_state = random_state
        self.checkpoint_every = checkpoint_every
        self.checkpoint_dir = checkpoint_dir
        self.resume_from = resume_from

        self._metric = metric
        self._cluster_centers = None
        self._labels = None
        self._inertia = None
        self._n_iter = None

    @property
    def cluster_centers_(self) -> DNDarray:
        return self._cluster_centers

    @property
    def labels_(self) -> DNDarray:
        return self._labels

    inertia_ = lazy_scalar_property("_inertia", float)
    n_iter_ = lazy_scalar_property("_n_iter", int)

    def _initialize_cluster_centers(self, x: DNDarray) -> None:
        """Random or explicit initialisation of ``_cluster_centers``."""
        if self.random_state is not None:
            ht_random.seed(self.random_state)
        n, f = x.shape
        k = self.n_clusters
        dtype = x.larray_padded.dtype if types.heat_type_is_inexact(x.dtype) else torch.float32
        if isinstance(self.init, DNDarray):
            if self.init.shape != (k, f):
                raise ValueError(f"passed centroids need to be of shape ({k}, {f}), but are {self.init.shape}")
            centers = self.init._dense().to(device=x.larray_padded.device, dtype=dtype)
        elif self.init == "random":
            # k distinct points: the first k of a stable argsort of one
            # uniform draw (the JAX package's jnp.argsort is stable too)
            u = ht_random.rand(n, device=x.device, comm=x.comm)._dense()
            idx = torch.argsort(u, stable=True)[:k]
            centers = _global_rows(x, idx).to(dtype)
        elif self.init in ("kmeans++", "probability_based", "++"):
            # the JAX package's draw order: the first centre's index, then
            # one uniform per added centre, then the greedy D^2 rounds
            first = int(ht_random.randint(0, n, size=(1,), device=x.device, comm=x.comm).larray[0])
            uniforms = [float(ht_random.rand(1, device=x.device, comm=x.comm).larray[0]) for _ in range(k - 1)]
            centers = _global_rows(x, _kmeanspp_indices(x, first, uniforms)).to(dtype)
        elif self.init == "batchparallel":
            raise NotImplementedError("batchparallel init: use BatchParallelKMeans")
        else:
            raise ValueError(f'init needs to be one of "random", ht.DNDarray or "kmeans++", but was {self.init}')
        self._cluster_centers = DNDarray.from_dense(centers, None, x.device, x.comm)

    def _assign_to_cluster(self, x: DNDarray, eval_functional_value: bool = False) -> DNDarray:
        """Label each sample with its nearest centre (the first on ties);
        with ``eval_functional_value`` also keep the inertia, the sum of
        the squared distances to it in the estimator's metric, as a lazy
        0-d value."""
        distances = self._metric(x, self._cluster_centers)
        if eval_functional_value:
            self._inertia = arithmetics.sum(statistics.min(distances, axis=1) ** 2).larray
        return statistics.argmin(distances, axis=1)

    def predict(self, x: DNDarray) -> DNDarray:
        """Nearest learned centre for each sample, in native float32."""
        if not isinstance(x, DNDarray):
            raise ValueError(f"input needs to be a DNDarray, but was {type(x)}")
        return self._assign_to_cluster(x)


def _fit_input(x: DNDarray) -> DNDarray:
    """The checks of a fit's input; integer points become float32.  Points
    split along columns raise, as the reference's distances do."""
    if not isinstance(x, DNDarray):
        raise ValueError(f"input needs to be a DNDarray, but was {type(x)}")
    if x.ndim != 2:
        raise ValueError(f"input needs to be 2D, but was {x.ndim}D")
    if x.split not in (None, 0):
        raise NotImplementedError(f"Splittings other than 0 or None currently not supported, got {x.split}")
    return x if types.heat_type_is_inexact(x.dtype) else x.astype(types.float32)


def _members(x: DNDarray, centers: torch.Tensor):
    """One assignment on this rank's true rows of x: ``(members, counts,
    reduce)``.  ``members`` is the (k, rows) truth of which centre is each
    row's nearest in city-block distance (the first on ties); ``counts`` the
    global member count of each centre; ``reduce`` sums a tensor over the
    ranks where x is split over several, else returns it."""
    local = x.larray
    reduce = x.comm.psum if x.is_distributed() else (lambda t: t)
    labels = distance._pairwise("manhattan", local, centers).argmin(1)
    members = labels[None, :] == torch.arange(centers.shape[0], device=local.device)[:, None]
    return members, reduce(members.sum(1)), reduce


def _global_rows(x: DNDarray, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``idx`` (global indices) of x, on every rank."""
    if x.split is None or x.comm.size == 1:
        return x.larray[idx]
    offset = x.comm.chunk(x.shape, x.split)[0]
    local = idx - offset
    mine = (local >= 0) & (local < x.lshape[0])
    rows = torch.zeros((idx.shape[0], x.shape[1]), dtype=x.larray_padded.dtype, device=idx.device)
    rows[mine] = x.larray_padded[local[mine]]
    return x.comm.psum(rows)


def _kmeanspp_indices(x: DNDarray, first: int, uniforms) -> torch.Tensor:
    """kmeans++ seeding of split=0 (or unsplit) points without gathering
    them: the global indices of the centres, row ``first`` and then one
    D^2-weighted pick (:func:`_kmeanspp_round`) per uniform in
    ``uniforms``."""
    if x.split not in (None, 0):
        raise NotImplementedError(f"kmeans++ seeds points split along rows or not split, got split={x.split}")
    local = x.larray
    ones = torch.ones(local.shape[1], dtype=local.dtype, device=local.device)
    # |x|^2 from 2^22 rows at a time: the squares of all of x would double its memory
    x2 = torch.cat([_row_dots(rows * rows, ones) for rows in torch.split(local, 1 << 22)]) if local.shape[0] else ones[:0]
    d2 = torch.full_like(x2, float("inf"))
    picks = [torch.tensor([first], dtype=torch.int64, device=local.device)]
    for u in uniforms:
        d2, pick = _kmeanspp_round(x, x2, d2, picks[-1], u)
        picks.append(pick)
    return torch.cat(picks)


def _kmeanspp_round(x: DNDarray, x2: torch.Tensor, d2: torch.Tensor, newest: torch.Tensor, u: float):
    """One greedy round of the JAX package's kmeans++ loop on this rank's
    rows: ``(d2, pick)``, the squared distances to the nearest centre so far
    and the global index (shape (1,)) of the next centre.

    D^2 is the minimum over the centres of ``|x|^2 + |c|^2 - 2 x.c``, kept as
    a running minimum ``d2`` that takes the ``newest`` centre's column (a
    minimum is exact, so this equals the minimum over all columns), clipped
    at 0 and divided by its sum (one psum).  The cumulative sum runs over
    the local rows in a fixed order (``arithmetics._CUMSUM``, on the card
    :func:`arithmetics._blocked_scan`: the same picks in every run),
    offset by the exscan of the ranks' totals; the pick is the first
    global row whose cumulative sum is at least ``u`` (a pmin of the
    ranks' candidates), the last row where there is none, as the
    reference's ``clip(searchsorted(cumsum, u), 0, n - 1)``."""
    local, comm, n = x.larray, x.comm, x.shape[0]
    offset = comm.chunk(x.shape, x.split)[0] if x.split == 0 else 0
    c = _global_rows(x, newest)[0].to(local.dtype)
    d2 = torch.minimum(d2, torch.add(x2 + (c * c).sum(), _row_dots(local, c), alpha=-2.0))
    w = torch.clamp(d2, min=0.0)
    total = comm.psum(w.sum().reshape(1))
    cum = arithmetics._CUMSUM(w / torch.clamp(total, min=1e-30), 0)
    carry = cum[-1:] if cum.numel() else torch.zeros(1, dtype=cum.dtype, device=cum.device)
    hits = (cum + comm.exscan(carry)) >= u
    none = torch.tensor([n], dtype=torch.int64, device=cum.device)
    candidate = torch.where(hits.any(), hits.to(torch.int32).argmax() + offset, none) if hits.numel() else none
    return d2, torch.clamp(comm.pmin(candidate), max=n - 1)


def _row_dots(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` for an (n, f) tensor and a vector of f, as one matrix
    product: ``g = 128 // f`` rows at a time, each (g f)-wide row against a
    block-diagonal (g f, g) copy of ``b``, the rows left over by a vector
    product.  cuBLAS's vector product over rows of 16 floats reads x at a
    fraction of the memory rate (chip_smoke.py, phase kmeanspp, times
    both)."""
    n, f = a.shape
    g = max(1, 128 // f)
    if g == 1:
        return a @ b
    whole = n - n % g
    out = torch.empty(n, dtype=a.dtype, device=a.device)
    torch.mm(a[:whole].reshape(whole // g, g * f), torch.block_diag(*[b[:, None]] * g),
             out=out[:whole].view(whole // g, g))
    torch.mv(a[whole:], b, out=out[whole:])
    return out
