"""Complex-number operations (counterpart of heat_tpu/core/complex_math.py):
each on each rank's padded chunk; ``real_if_close`` decides over the whole
array with one all-reduce."""

from __future__ import annotations

import numpy as np
import torch

from . import _operations, types
from .dndarray import DNDarray

__all__ = ["angle", "conj", "conjugate", "imag", "real", "real_if_close"]


def angle(x, deg: bool = False, out=None) -> DNDarray:
    """The argument of complex values (0 or pi for real ones), in degrees
    with ``deg``; integer and bool input in float64, as JAX's."""
    def op(a):
        r = torch.angle(a if a.is_floating_point() or a.is_complex() else a.to(torch.float64))
        return torch.rad2deg(r) if deg else r

    def unsigned(a, t):  # no unsigned value lies below 0
        return torch.zeros(a.shape, dtype=torch.float64, device=a.device)

    return _operations.__local_op(op, x, out, no_cast=True, widened=unsigned)


def conjugate(x, out=None) -> DNDarray:
    """The complex conjugate (a copy of real values)."""
    return _operations.__local_op(lambda a: torch.conj_physical(a) if a.is_complex() else a.clone(), x, out,
                                  no_cast=True)


conj = conjugate


def imag(x, out=None) -> DNDarray:
    """The imaginary part (zeros of real values)."""
    def op(a):
        return a.imag.clone() if a.is_complex() else torch.zeros_like(a)

    return _operations.__local_op(op, x, out, no_cast=True)


def real(x, out=None) -> DNDarray:
    """The real part (a copy of real values)."""
    return _operations.__local_op(lambda a: a.real.clone() if a.is_complex() else a.clone(), x, out, no_cast=True)


def real_if_close(x, tol: float = 100.0) -> DNDarray:
    """The real part where every imaginary part lies within ``tol`` (in
    machine epsilons of the type when above 1) of zero, else ``x``: one
    all-reduce decides for the whole array."""
    if not isinstance(x, DNDarray):
        raise TypeError(f"expected x to be a DNDarray, but was {type(x)}")
    if not types.heat_type_is_complexfloating(x.dtype):
        return x
    data = x.larray_padded
    if tol > 1:
        tol = tol * float(np.finfo(types.numpy_type(types.canonical_heat_type(data.real.dtype))).eps)
    close = (x._masked(0).imag.abs() < tol).all()
    flag = x.comm.pmin(close.to(torch.int32).reshape(1))
    return real(x) if bool(flag[0]) else x
