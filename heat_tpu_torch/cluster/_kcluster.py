"""Shared k-clustering base (counterpart of heat_tpu/cluster/_kcluster.py).

Ported here: ``init="random"`` and an explicit array of centres, the
nearest-centre assignment and ``predict``.  kmeans++ seeding and the
checkpoint/resume options are not ported yet and raise.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch

from ..core import random as ht_random
from ..core import statistics, types
from ..core.base import BaseEstimator, ClusteringMixin, lazy_scalar_property, low_precision_predict_requested
from ..core.dndarray import DNDarray

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
            raise NotImplementedError("kmeans++ initialisation is not ported yet; use init='random' or an array")
        elif self.init == "batchparallel":
            raise NotImplementedError("batchparallel init: use BatchParallelKMeans")
        else:
            raise ValueError(f'init needs to be one of "random", ht.DNDarray or "kmeans++", but was {self.init}')
        self._cluster_centers = DNDarray.from_dense(centers, None, x.device, x.comm)

    def _assign_to_cluster(self, x: DNDarray) -> DNDarray:
        """Label each sample with its nearest centre."""
        distances = self._metric(x, self._cluster_centers)
        return statistics.argmin(distances, axis=1)

    def predict(self, x: DNDarray) -> DNDarray:
        """Nearest learned centre for each sample, in native float32."""
        if not isinstance(x, DNDarray):
            raise ValueError(f"input needs to be a DNDarray, but was {type(x)}")
        if low_precision_predict_requested():
            raise NotImplementedError("low-precision predict (HEAT_TPU_PREDICT_DTYPE) is not ported yet")
        return self._assign_to_cluster(x)


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
