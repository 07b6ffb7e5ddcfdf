"""Principal component analysis (counterpart of heat_tpu/decomposition/pca.py).

Ported: ``svd_solver="hierarchical"`` (``hsvd_rank`` for an int
``n_components``, ``hsvd_rtol`` for a float one), ``svd_solver=
"randomized"`` (``rsvd``, an int ``n_components`` only), ``transform``,
``inverse_transform`` and ``fit_transform``.  A hierarchical fit over data
split along rows gathers nothing of the data's size: the mean, the Gram
matrix and the total variance are local sums followed by one all-reduce
each; a randomized fit gathers the centred data, as the reference's does.
``svd_solver="full"``, the checkpoint parameters and low-precision
transforms are not ported yet and raise.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from ..core import random as ht_random
from ..core import statistics
from ..core.base import BaseEstimator, TransformMixin, lazy_scalar_property, low_precision_predict_requested
from ..core.dndarray import DNDarray
from ..core.linalg import basics, svdtools
from ..core.linalg.svd import svd as _exact_svd

__all__ = ["PCA"]


class PCA(BaseEstimator, TransformMixin):
    """Linear dimensionality reduction by the SVD of the centred data."""

    def __init__(
        self,
        n_components: Optional[Union[int, float]] = None,
        copy: bool = True,
        whiten: bool = False,
        svd_solver: str = "hierarchical",
        tol: Optional[float] = None,
        iterated_power: Union[str, int] = "auto",
        n_oversamples: int = 10,
        power_iteration_normalizer: str = "qr",
        random_state: Optional[int] = None,
        checkpoint_every: Optional[int] = None,
        checkpoint_dir: Optional[str] = None,
        resume_from: Optional[str] = None,
    ):
        if whiten:
            raise NotImplementedError("whitening is not supported")
        if svd_solver not in ("full", "hierarchical", "randomized"):
            raise ValueError(f"svd_solver must be 'full', 'hierarchical' or 'randomized', got {svd_solver!r}")
        if random_state is not None and not isinstance(random_state, int):
            raise ValueError(f"random_state must be None or int, got {type(random_state)}")
        if checkpoint_every is not None or checkpoint_dir is not None or resume_from is not None:
            raise NotImplementedError(
                "resumable fits (checkpoint_every, checkpoint_dir, resume_from) are not ported yet "
                "(ROADMAP Queue 1 item 15b)"
            )
        self.checkpoint_every = checkpoint_every
        self.checkpoint_dir = checkpoint_dir
        self.resume_from = resume_from

        self.n_components = n_components
        self.copy = copy
        self.whiten = whiten
        self.svd_solver = svd_solver
        self.tol = tol
        self.iterated_power = iterated_power
        self.n_oversamples = n_oversamples
        self.power_iteration_normalizer = power_iteration_normalizer
        self.random_state = random_state

        self.components_ = None
        self.explained_variance_ = None
        self.explained_variance_ratio_ = None
        self.singular_values_ = None
        self.mean_ = None
        self.n_components_ = None
        self._tevr = None
        self.noise_variance_ = None

    # a fit stores a device scalar; the host value is taken on first access
    total_explained_variance_ratio_ = lazy_scalar_property("_tevr", float)

    def fit(self, X: DNDarray, y=None) -> "PCA":
        """Estimate the principal components of ``X`` (samples along rows)."""
        if not isinstance(X, DNDarray):
            raise TypeError(f"X must be a DNDarray, got {type(X)}")
        if X.ndim != 2:
            raise ValueError(f"X must be 2D, got {X.ndim}D")
        if y is not None:
            raise ValueError("PCA is an unsupervised transform; y must be None")
        n, f = X.shape
        mean = statistics.mean(X, axis=0)
        self.mean_ = mean
        centered = X - mean
        if self.random_state is not None:
            ht_random.seed(self.random_state)

        rank_cap = min(n, f)
        if isinstance(self.n_components, float):
            if not 0.0 < self.n_components <= 1.0:
                raise ValueError("float n_components must be in (0, 1]")
            k, rtol = None, (1 - self.n_components) ** 0.5
        else:
            k, rtol = (min(self.n_components, rank_cap) if self.n_components else rank_cap), None

        if self.svd_solver == "full":
            # the exact SVD (TS-QR over row-split samples): every component
            # up to k, the variance ratio over the spectrum's own total
            U, S, V = _exact_svd(centered)
            s = S._dense()
            kk = k if k is not None else rank_cap
            self.components_ = DNDarray.from_dense(V._dense()[:, :kk].T, None, X.device, X.comm)
            self.singular_values_ = DNDarray.from_dense(s[:kk], None, X.device, X.comm)
            ev = s**2 / max(n - 1, 1)
            self.explained_variance_ = DNDarray.from_dense(ev[:kk], None, X.device, X.comm)
            ratio = ev / torch.clamp(torch.sum(ev), min=1e-30)
            self.explained_variance_ratio_ = DNDarray.from_dense(ratio[:kk], None, X.device, X.comm)
            self._tevr = torch.sum(ratio[:kk])
            self.n_components_ = kk
            return self
        if self.svd_solver == "randomized":
            if k is None:
                raise ValueError("randomized solver requires an integer n_components")
            p_iter = 0 if self.iterated_power == "auto" else int(self.iterated_power)
            U, S, V = svdtools.rsvd(centered, rank=k, n_oversamples=self.n_oversamples, power_iter=p_iter)
        elif rtol is not None:
            U, S, V, err = svdtools.hsvd_rtol(centered, rtol=rtol, compute_sv=True)
        else:
            U, S, V, err = svdtools.hsvd_rank(centered, maxrank=k, compute_sv=True)
        self.components_ = DNDarray.from_dense(V._dense().T, None, X.device, X.comm)
        self.singular_values_ = S
        s = S._dense()
        ev = s**2 / max(n - 1, 1)
        self.explained_variance_ = DNDarray.from_dense(ev, None, X.device, X.comm)
        total_var = torch.clamp(_sum_of_squares(centered) / max(n - 1, 1), min=1e-30)
        self.explained_variance_ratio_ = DNDarray.from_dense(ev / total_var, None, X.device, X.comm)
        if self.svd_solver == "randomized":
            self._tevr = torch.sum(ev) / total_var
            self.n_components_ = k
        else:
            self._tevr = 1.0 - err**2
            self.n_components_ = int(s.shape[0])
        return self

    def transform(self, X: DNDarray) -> DNDarray:
        """Project ``X`` onto the principal axes."""
        if self.components_ is None:
            raise RuntimeError("fit needs to be called before transform")
        if not isinstance(X, DNDarray):
            raise TypeError(f"X must be a DNDarray, got {type(X)}")
        if low_precision_predict_requested():
            raise NotImplementedError(
                "low-precision transform (HEAT_TPU_PREDICT_DTYPE) needs the precision scope, "
                "not ported yet (ROADMAP Queue 1 item 18)"
            )
        return basics.matmul(X - self.mean_, self.components_.T)

    def inverse_transform(self, X: DNDarray) -> DNDarray:
        """Map projected data back to the original space."""
        if self.components_ is None:
            raise RuntimeError("fit needs to be called before inverse_transform")
        return basics.matmul(X, self.components_) + self.mean_


def _sum_of_squares(x: DNDarray) -> torch.Tensor:
    """The float32 sum of squares of x's true entries: a local sum over this
    rank's chunk (padding left out), then one all-reduce.  Any float type
    is cast to float32 first, as the reference does."""
    ss = (torch.linalg.vector_norm(x.larray.to(torch.float32)) ** 2).reshape(1)
    return (ss if x.split is None else x.comm.psum(ss))[0]
