"""Spectral clustering (counterpart of heat_tpu/cluster/spectral.py).

Similarity, then the normalised graph Laplacian, then a Lanczos embedding
from a ``randn`` start vector of the global stream, ``eigh`` of the
tridiagonal T, V times its eigenvectors, and KMeans (kmeans++) on the first
``n_clusters`` columns.  The JAX package fuses the embedding into one
program; here it runs eagerly, step by step, each under a profiler label
(``spectral.laplacian``, ``.lanczos``, ``.eigh``, ``.kmeans``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch.profiler import record_function

from ..core import random as ht_random
from ..core.base import BaseEstimator, ClusteringMixin
from ..core.dndarray import DNDarray
from ..core.linalg.basics import full_f32_matmul
from ..graph import Laplacian
from ..spatial import distance
from .kmeans import KMeans

__all__ = ["Spectral"]


def _make_similarity(metric: str, gamma: float):
    if metric == "rbf":
        sigma = math.sqrt(1.0 / (2.0 * gamma))
        return lambda x: distance.rbf(x, sigma=sigma)
    if metric == "euclidean":
        return lambda x: distance.cdist(x, quadratic_expansion=True)
    raise NotImplementedError(f"Other kernels than rbf and euclidean are currently not supported, got {metric!r}")


class Spectral(BaseEstimator, ClusteringMixin):
    """Spectral clustering on a similarity graph."""

    def __init__(
        self,
        n_clusters: Optional[int] = None,
        gamma: float = 1.0,
        metric: str = "rbf",
        laplacian: str = "fully_connected",
        threshold: float = 1.0,
        boundary: str = "upper",
        n_lanczos: int = 300,
        assign_labels: str = "kmeans",
        **params,
    ):
        self.n_clusters = n_clusters
        self.gamma = gamma
        self.metric = metric
        self.laplacian = laplacian
        self.threshold = threshold
        self.boundary = boundary
        self.n_lanczos = n_lanczos
        self.assign_labels = assign_labels

        self._laplacian = Laplacian(
            _make_similarity(metric, gamma), definition="norm_sym", mode=laplacian,
            threshold_key=boundary, threshold_value=threshold,
        )
        if assign_labels == "kmeans":
            self._cluster = KMeans(n_clusters=n_clusters, init="kmeans++") if n_clusters else KMeans(init="kmeans++")
        else:
            raise NotImplementedError(f"Other clustering methods than kmeans are currently not supported, got "
                                      f"{assign_labels!r}")
        self._labels = None
        self._eigenvectors = None

    @property
    def labels_(self) -> DNDarray:
        return self._labels

    def _spectral_embedding(self, x: DNDarray):
        """``(eigenvalues of T, V @ eigenvectors of T)``: the Laplacian of x,
        ``lanczos`` for min(n_lanczos, n) steps from a normalised ``randn(n)``
        drawn before the Laplacian is built, as the reference draws it."""
        from ..core.linalg import solver

        n = x.shape[0]
        m = min(self.n_lanczos, n)
        v0 = ht_random.randn(n, device=x.device, comm=x.comm)
        with record_function("spectral.laplacian"):
            L = self._laplacian.construct(x)
        vd = v0._dense()
        v0 = DNDarray.from_dense(vd / torch.linalg.vector_norm(vd), None, x.device, x.comm)
        with record_function("spectral.lanczos"):
            V, T = solver.lanczos(L, m, v0=v0)
        del L
        with record_function("spectral.eigh"):
            evals, evecs_T = torch.linalg.eigh(T._dense())
            with full_f32_matmul():
                embedding = V._dense() @ evecs_T.to(V.larray.dtype)
        return evals, DNDarray.from_dense(embedding, x.split, x.device, x.comm)

    def fit(self, x: DNDarray) -> "Spectral":
        """Embed, then cluster the leading eigenvectors."""
        if not isinstance(x, DNDarray):
            raise ValueError(f"input needs to be a DNDarray, but was {type(x)}")
        if x.ndim != 2:
            raise ValueError(f"input needs to be 2D, but was {x.ndim}D")
        evals, evecs = self._spectral_embedding(x)
        if self.n_clusters is None:
            # the eigengap heuristic: the largest gap among the first 50
            diffs = torch.diff(evals)
            self.n_clusters = int(torch.argmax(diffs[: min(50, diffs.shape[0])])) + 1
            self._cluster.n_clusters = self.n_clusters
        components = DNDarray.from_dense(evecs._dense()[:, : self.n_clusters], x.split, x.device, x.comm)
        with record_function("spectral.kmeans"):
            self._cluster.fit(components)
        self._labels = self._cluster.labels_
        self._eigenvectors = evecs
        return self

    def predict(self, x: DNDarray) -> DNDarray:
        """The labels of the fit (prediction is defined on the training data
        only, as in the reference)."""
        return self._labels
