"""Gaussian naive Bayes (counterpart of heat_tpu/naive_bayes/gaussianNB.py).

``fit`` and ``partial_fit`` merge per-class moments in one step, as the JAX
package does: the class axis is an (n, c) mask of sample weights, the
per-class sums are products with it, the within-class variances come from
the data shifted by its global mean, and the smoothing term added to the
variances is taken off again before the next merge.  Points split along
rows stay on their ranks: every sum over the samples is a local sum plus
one all-reduce.  The joint log likelihood is the expanded quadratic form
in IEEE float32, each rank on its own rows.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..core.base import BaseEstimator, ClassificationMixin, _sample_rows, lazy_scalar_property
from ..core.dndarray import DNDarray
from ..core.linalg.basics import full_f32_matmul

__all__ = ["GaussianNB"]


def _samples(x: DNDarray, y: DNDarray, sample_weight):
    """``(x rows, y rows, weight rows, reduce, n)`` (:func:`_sample_rows`),
    exact types in float32, weights of one where none are given."""
    xd, (yd, w), reduce = _sample_rows(x, y, sample_weight)
    if not xd.is_floating_point():
        xd = xd.to(torch.float32)
    w = torch.ones(xd.shape[0], dtype=xd.dtype, device=xd.device) if w is None else w.to(xd.device, xd.dtype)
    return xd, yd.to(xd.device), w, reduce, x.shape[0]


def _gnb_update(xd, yd, w, reduce, n: int, cls, theta, var, counts, eps_applied, var_smoothing: float):
    """One moment merge over all classes (the JAX package's ``_gnb_update``)."""
    var_old = var - eps_applied
    mask = (yd[:, None] == cls[None, :]).to(xd.dtype) * w[:, None]
    n_new = reduce(mask.sum(0))
    safe = torch.clamp(n_new, min=1e-30)
    xbar = reduce(xd.sum(0)) / n
    xc = xd - xbar[None, :]
    with full_f32_matmul():
        mu_c = reduce(mask.T @ xc) / safe[:, None]
        ex2_c = reduce(mask.T @ (xc * xc)) / safe[:, None]
    var_new = torch.clamp(ex2_c - mu_c**2, min=0.0)
    mu_new = mu_c + xbar[None, :]

    n_old = counts
    n_tot = n_old + n_new
    safe_tot = torch.clamp(n_tot, min=1e-30)
    mu_tot = (n_old[:, None] * theta + n_new[:, None] * mu_new) / safe_tot[:, None]
    ssd = (n_old[:, None] * var_old + n_new[:, None] * var_new
           + (n_old * n_new / safe_tot)[:, None] * (theta - mu_new) ** 2)
    var_tot = ssd / safe_tot[:, None]
    keep = (n_tot > 0)[:, None]
    theta_out = torch.where(keep, mu_tot, theta)
    var_out = torch.where(keep, var_tot, var_old)
    eps = var_smoothing * torch.max(reduce((xc * xc).sum(0)) / n)
    return theta_out, var_out + eps, n_tot, eps


class GaussianNB(BaseEstimator, ClassificationMixin):
    """Gaussian likelihood naive Bayes classifier."""

    def __init__(self, priors: Optional[DNDarray] = None, var_smoothing: float = 1e-9):
        self.priors = priors
        self.var_smoothing = var_smoothing
        self.classes_ = None
        self.theta_ = None
        self.var_ = None
        self.class_count_ = None
        self.class_prior_ = None
        self._epsilon = None

    sigma_ = property(lambda self: self.var_)  # the reference's alias

    # a fit keeps the device scalar; the host reads it on first access
    epsilon_ = lazy_scalar_property("_epsilon", float)

    def fit(self, x: DNDarray, y: DNDarray, sample_weight: Optional[DNDarray] = None) -> "GaussianNB":
        """Estimate each class's mean and variance."""
        self.classes_ = None
        self.theta_ = None
        return self.partial_fit(x, y, classes=None, sample_weight=sample_weight)

    def partial_fit(self, x: DNDarray, y: DNDarray, classes=None,
                    sample_weight: Optional[DNDarray] = None) -> "GaussianNB":
        """Merge a batch's moments into the fitted ones."""
        if not isinstance(x, DNDarray) or not isinstance(y, DNDarray):
            raise TypeError("x and y need to be DNDarrays")
        if x.ndim != 2:
            raise ValueError(f"expected x to be 2D, got {x.ndim}D")
        xd, yd, w, reduce, n = _samples(x, y, sample_weight)
        dev = xd.device
        if self.classes_ is None:
            if classes is not None:
                cls = np.asarray(classes.numpy() if isinstance(classes, DNDarray) else classes)
                cls_t = torch.from_numpy(np.ascontiguousarray(cls))
            else:  # the sorted distinct labels (np.unique's), found without a gather
                from ..core.manipulations import unique

                cls_t = unique(y)._dense().reshape(-1)
            self.classes_ = DNDarray.from_dense(cls_t, None, x.device, x.comm)
            shape = (cls_t.shape[0], x.shape[1])
            self.theta_ = torch.zeros(shape, dtype=xd.dtype, device=dev)
            self.var_ = torch.zeros(shape, dtype=xd.dtype, device=dev)
            self.class_count_ = torch.zeros(shape[0], dtype=xd.dtype, device=dev)
        dense = lambda a: a.larray if isinstance(a, DNDarray) else a
        eps_applied = getattr(self, "_eps_applied", None)
        if eps_applied is None:
            eps_applied = torch.zeros((), dtype=xd.dtype, device=dev)
        theta, var, counts, eps = _gnb_update(
            xd, yd, w, reduce, n, dense(self.classes_).to(yd.dtype), dense(self.theta_), dense(self.var_),
            dense(self.class_count_), eps_applied, float(self.var_smoothing),
        )
        # kept on the device: taken off again before the next merge
        self._epsilon = eps
        self._eps_applied = eps
        if self.priors is not None:
            pri = self.priors._dense() if isinstance(self.priors, DNDarray) else torch.as_tensor(self.priors)
            pri = pri.to(dev)
        else:
            pri = counts / torch.clamp(counts.sum(), min=1e-30)
        wrap = lambda a: DNDarray.from_dense(a, None, x.device, x.comm)
        self.theta_ = wrap(theta)
        self.var_ = wrap(var)
        self.class_count_ = wrap(counts)
        self.class_prior_ = wrap(pri)
        return self

    def _rows(self, x: DNDarray):
        """``(rows, local)``: this rank's padded rows of x (``local`` True)
        where x is split along them or not split, else the whole array."""
        local = x.split in (None, 0)
        t = x.larray_padded if local else x._dense()
        return (t if t.is_floating_point() else t.to(torch.float32)), local

    def _joint_log_likelihood(self, xd: torch.Tensor) -> torch.Tensor:
        """Each class's joint log likelihood of the rows ``xd``: log prior,
        the normalisation and the quadratic form expanded into three
        products, (rows, classes)."""
        theta, var, prior = (a.larray.to(xd.device) for a in (self.theta_, self.var_, self.class_prior_))
        prior = torch.log(torch.clamp(prior, min=1e-30))
        norm = -0.5 * torch.sum(torch.log(2.0 * math.pi * var), dim=1)
        inv_var = 1.0 / var
        with full_f32_matmul():
            t1 = (xd * xd) @ inv_var.T
            t2 = xd @ (theta * inv_var).T
        t3 = torch.sum(theta * theta * inv_var, dim=1)
        quad = -0.5 * (t1 - 2.0 * t2 + t3[None, :])
        return prior[None, :] + norm[None, :] + quad

    def _per_row(self, x: DNDarray, result: torch.Tensor, local: bool, gshape) -> DNDarray:
        if local:
            return x._like(result, gshape, x.split)
        return DNDarray.from_dense(result, x.split, x.device, x.comm)

    def predict(self, x: DNDarray) -> DNDarray:
        """The most probable class of each sample."""
        if self.theta_ is None:
            raise RuntimeError("fit needs to be called before predict")
        xd, local = self._rows(x)
        cls = self.classes_.larray.to(xd.device)
        return self._per_row(x, cls[torch.argmax(self._joint_log_likelihood(xd), dim=1)], local, (x.shape[0],))

    def _log_proba(self, x: DNDarray):
        xd, local = self._rows(x)
        jll = self._joint_log_likelihood(xd)
        return jll - torch.logsumexp(jll, dim=1, keepdim=True), local

    def predict_proba(self, x: DNDarray) -> DNDarray:
        """Each class's probability for each sample."""
        lp, local = self._log_proba(x)
        return self._per_row(x, torch.exp(lp), local, (x.shape[0], lp.shape[1]))

    def predict_log_proba(self, x: DNDarray) -> DNDarray:
        lp, local = self._log_proba(x)
        return self._per_row(x, lp, local, (x.shape[0], lp.shape[1]))
