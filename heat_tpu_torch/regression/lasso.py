"""Lasso regression (counterpart of heat_tpu/regression/lasso.py).

Cyclic coordinate descent with soft thresholding over the data with an
intercept column of ones prepended: each coordinate's residual takes the
full product ``X @ theta``, as the JAX package's does, and the intercept
is not penalised.  The data are held transposed, so a coordinate's column
is one contiguous row.  Points split along rows stay on their ranks: each
coordinate's inner product is a local product plus one all-reduce.  The
stop test ``delta >= tol`` (delta the largest change of a sweep, in
float32) is read on the host once a sweep; :data:`STOP_TEST_READS` counts
those reads in the last fit (a resumable fit also reads it at each chunk
boundary).  ``predict`` evaluates the product as XLA's
compiler does, one fused multiply-add a feature in order, so a model
carried over from the JAX package predicts its values bitwise.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.base import (BaseEstimator, RegressionMixin, _sample_rows, lazy_scalar_property, resumable_fit_loop,
                         validate_resume_params)
from ..core import dispatch
from ..core.dndarray import DNDarray
from ..core.linalg.basics import full_f32_matmul

__all__ = ["Lasso"]

#: host reads of the stop test in the last fit (one a sweep)
STOP_TEST_READS = 0


def _soft_threshold(d: torch.Tensor, lam: float) -> torch.Tensor:
    return torch.sign(d) * torch.clamp(torch.abs(d) - lam, min=0.0)


def _soft_threshold_op(d: torch.Tensor, *, lam: float) -> torch.Tensor:
    return _soft_threshold(d, lam)


def _linear_predict_op(xd: torch.Tensor, th: torch.Tensor) -> torch.Tensor:
    """Intercept + coefficients, (n, 1) (the predict path the serving
    layer batches)."""
    return (_fma_matvec(xd, th[1:]) + th[0]).reshape(-1, 1)


def _fma_matvec(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for float32 or float64 rows as one fused multiply-add per
    feature, the features in order from a zero sum (XLA's matrix-vector
    product on the host, bitwise)."""
    from ..core.random import _fma32, _fma64

    fma = _fma32 if x.dtype == torch.float32 else _fma64
    acc = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
    for j in range(x.shape[1]):
        acc = fma(x[:, j], w[j].expand(x.shape[0]), acc)
    return acc


def _cd_loop(XT: torch.Tensor, yd: torch.Tensor, col_sq: torch.Tensor, lam: torch.Tensor, tol: torch.Tensor,
             max_iter: int, reduce, theta0=None):
    """Sweeps of cyclic coordinate descent from ``theta0`` (zeros by default)
    while ``it < max_iter`` and ``delta >= tol``: ``(theta, sweeps, delta)``,
    delta the last sweep's (inf where none ran).  Each stop test read on the
    host adds one to :data:`STOP_TEST_READS`; each sweep counts one
    ``dispatch.external_dispatches`` (the reference's fit is one on-device
    loop, one dispatch however many sweeps)."""
    global STOP_TEST_READS
    m = XT.shape[0]
    theta = torch.zeros(m, dtype=XT.dtype, device=XT.device) if theta0 is None else theta0
    it, delta = 0, float("inf")
    go = max_iter > 0
    with full_f32_matmul():
        while go:
            dispatch.record_external_dispatch()
            new = theta.clone()
            for j in range(m):
                resid = yd - new @ XT + XT[j] * new[j]
                rho = reduce(XT[j] @ resid)
                if j == 0:  # the intercept is not penalised
                    new[j] = rho / torch.clamp(col_sq[0], min=1e-30)
                else:
                    new[j] = _soft_threshold(rho, lam) / torch.clamp(col_sq[j], min=1e-30)
            delta = torch.max(torch.abs(new - theta)).to(torch.float32)
            theta, it = new, it + 1
            if it >= max_iter:
                break
            STOP_TEST_READS += 1
            go = bool(delta >= tol)
    return theta, it, delta


class Lasso(BaseEstimator, RegressionMixin):
    """L1-regularised linear regression by coordinate descent.
    ``checkpoint_every=N`` with ``checkpoint_dir`` checkpoints ``theta``
    every N sweeps; ``resume_from=dir`` continues a killed fit from its last
    checkpoint with the same sweep sequence."""

    def __init__(
        self,
        lam: float = 0.1,
        max_iter: int = 100,
        tol: float = 1e-6,
        checkpoint_every: Optional[int] = None,
        checkpoint_dir: Optional[str] = None,
        resume_from: Optional[str] = None,
    ):
        validate_resume_params(checkpoint_every, checkpoint_dir, resume_from)
        self._lam = lam
        self.max_iter = max_iter
        self.tol = tol
        self.checkpoint_every = checkpoint_every
        self.checkpoint_dir = checkpoint_dir
        self.resume_from = resume_from
        self._theta = None
        self._n_iter = None

    @property
    def coef_(self) -> Optional[DNDarray]:
        return None if self._theta is None else self._theta[1:]

    @property
    def intercept_(self) -> Optional[DNDarray]:
        return None if self._theta is None else self._theta[0]

    @property
    def lam(self) -> float:
        return self._lam

    @lam.setter
    def lam(self, arg: float):
        self._lam = arg

    @property
    def theta(self):
        return self._theta

    n_iter = lazy_scalar_property("_n_iter", int)

    def soft_threshold(self, rho):
        """``sign(rho) max(|rho| - lam, 0)``, elementwise (each rank on its
        own entries)."""
        lam = float(self._lam)
        if isinstance(rho, DNDarray):
            return rho._like(dispatch.eager_apply(_soft_threshold_op, (rho.larray_padded,), {"lam": lam}))
        return dispatch.eager_apply(_soft_threshold_op, (torch.as_tensor(rho),), {"lam": lam})

    def rmse(self, gt: DNDarray, yest: DNDarray) -> float:
        """Root mean squared error."""
        diff = gt._dense().reshape(-1) - yest._dense().reshape(-1).to(gt.larray.device)
        return float(torch.sqrt(torch.mean(diff * diff)))

    def fit(self, x: DNDarray, y: DNDarray) -> "Lasso":
        """Coordinate descent from zero (or from a checkpoint's theta)."""
        if not isinstance(x, DNDarray) or not isinstance(y, DNDarray):
            raise TypeError("x and y need to be DNDarrays")
        if x.ndim != 2:
            raise ValueError(f"x needs to be 2D, got {x.ndim}D")
        xd, (yd,), reduce = _sample_rows(x, y)
        if not xd.is_floating_point():
            xd = xd.to(torch.float32)
        yd = yd.to(xd.device, xd.dtype)
        XT = torch.cat([torch.ones((1, xd.shape[0]), dtype=xd.dtype, device=xd.device), xd.T]).contiguous()
        col_sq = reduce((XT * XT).sum(1))
        lam = torch.tensor(self._lam, dtype=xd.dtype, device=xd.device)
        tol = torch.tensor(self.tol, dtype=torch.float32, device=xd.device)
        global STOP_TEST_READS
        STOP_TEST_READS = 0
        if self.checkpoint_every is not None or self.resume_from is not None:
            # the same sweep sequence in chunks, theta checkpointed (and
            # guarded) every checkpoint_every sweeps; the sweeps go on while
            # delta >= tol in float32
            tol32 = float(tol)
            theta, it = resumable_fit_loop(
                lambda th, n: _cd_loop(XT, yd, col_sq, lam, tol, n, reduce,
                                       torch.as_tensor(th).to(device=XT.device, dtype=XT.dtype)),
                lambda: torch.zeros(XT.shape[0], dtype=XT.dtype, device=XT.device),
                self.max_iter,
                float(self.tol),
                checkpoint_every=self.checkpoint_every,
                checkpoint_dir=self.checkpoint_dir,
                resume_from=self.resume_from,
                site="lasso.iter",
                what="theta",
                converged_when=lambda d, t: d < tol32,
                comm=x.comm,
            )
            theta = torch.as_tensor(theta).to(device=XT.device, dtype=XT.dtype)
        else:
            theta, it, _ = _cd_loop(XT, yd, col_sq, lam, tol, self.max_iter, reduce)
        self._n_iter = it
        self._theta = DNDarray.from_dense(theta.reshape(-1, 1), None, x.device, x.comm)
        return self

    def predict(self, x: DNDarray) -> DNDarray:
        """Intercept plus the coefficients' product, (n, 1), split like x."""
        if self._theta is None:
            raise RuntimeError("fit needs to be called before predict")
        local = x.split in (None, 0)
        xd = x.larray_padded if local else x._dense()
        if not xd.is_floating_point():
            xd = xd.to(torch.float32)
        th = self._theta.larray.reshape(-1).to(xd.device, xd.dtype)
        yest = dispatch.eager_apply(_linear_predict_op, (xd, th))
        if local:
            return x._like(yest, (x.shape[0], 1), x.split)
        return DNDarray.from_dense(yest, x.split, x.device, x.comm)
