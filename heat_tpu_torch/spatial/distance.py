"""Pairwise distances (counterpart of heat_tpu/spatial/distance.py).

``cdist`` is local: each rank computes the distances of its row chunk of X
to the whole of Y (gathered when Y is split).  The JAX package's ppermute
ring, which never holds Y whole, is not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core import types
from ..core.dndarray import DNDarray
from ..core.linalg.basics import full_f32_matmul

__all__ = ["cdist"]


def _pairwise_sqeuclidean(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``|x_i - y_j|^2`` by the expanded form, one matrix product."""
    x_sq = torch.sum(x * x, dim=1, keepdim=True)
    y_sq = torch.sum(y * y, dim=1, keepdim=True).T
    with full_f32_matmul():
        cross = x @ y.T
    return torch.clamp(x_sq + y_sq - 2.0 * cross, min=0.0)


def _pairwise_direct(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Exact broadcast-subtract form: no cancellation for near-duplicate
    points, at the cost of an (n, m, f) intermediate."""
    diff = x[:, None, :] - y[None, :, :]
    return torch.sqrt(torch.sum(diff * diff, dim=-1))


def cdist(X: DNDarray, Y: Optional[DNDarray] = None, quadratic_expansion: bool = False) -> DNDarray:
    """Euclidean distance matrix between the rows of X and of Y (X itself
    when Y is None); split like X's rows."""
    for a in (X,) if Y is None else (X, Y):
        if not isinstance(a, DNDarray):
            raise TypeError(f"cdist takes DNDarrays, got {type(a)}")
        if a.ndim != 2:
            raise NotImplementedError(f"cdist takes 2-D arrays, got {a.ndim}-D")
    if X.split not in (None, 0):
        raise NotImplementedError(f"Splittings other than 0 or None currently not supported, got {X.split}")
    Y = X if Y is None else Y
    if X.shape[1] != Y.shape[1]:
        raise ValueError(f"X and Y must have the same number of features, got {X.shape[1]} and {Y.shape[1]}")
    x = X.larray_padded
    y = Y._dense()
    if not types.heat_type_is_inexact(X.dtype):
        x = x.to(torch.float32)
    if not types.heat_type_is_inexact(Y.dtype):
        y = y.to(torch.float32)
    if quadratic_expansion:
        d = torch.sqrt(_pairwise_sqeuclidean(x, y))
    else:
        d = _pairwise_direct(x, y)
    return X._like(d, (X.shape[0], Y.shape[0]), X.split)
