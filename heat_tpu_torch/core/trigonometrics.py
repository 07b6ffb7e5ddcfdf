"""Trigonometric operations (counterpart of heat_tpu/core/trigonometrics.py):
each on each rank's padded chunk, integer input cast to float32 first.
``unwrap`` along the split axis differences across the ranks' boundaries
through a halo and adds its corrections by a scan (one exclusive scan over
the ranks)."""

from __future__ import annotations

import math

import torch

from . import _operations, types
from .arithmetics import _CUMSUM, _halos, _inexact
from .dndarray import DNDarray
from .stride_tricks import sanitize_axis

__all__ = [
    "arccos",
    "acos",
    "arccosh",
    "acosh",
    "arcsin",
    "asin",
    "arcsinh",
    "asinh",
    "arctan",
    "atan",
    "arctan2",
    "atan2",
    "arctanh",
    "atanh",
    "cos",
    "cosh",
    "deg2rad",
    "degrees",
    "rad2deg",
    "radians",
    "i0",
    "sin",
    "sinc",
    "sinh",
    "tan",
    "tanh",
    "unwrap",
]


def arccos(x, out=None) -> DNDarray:
    """The inverse cosine."""
    return _operations.__local_op(torch.acos, x, out)


acos = arccos


def arccosh(x, out=None) -> DNDarray:
    """The inverse hyperbolic cosine."""
    return _operations.__local_op(torch.acosh, x, out)


acosh = arccosh


def arcsin(x, out=None) -> DNDarray:
    """The inverse sine."""
    return _operations.__local_op(torch.asin, x, out)


asin = arcsin


def arcsinh(x, out=None) -> DNDarray:
    """The inverse hyperbolic sine."""
    return _operations.__local_op(torch.asinh, x, out)


asinh = arcsinh


def arctan(x, out=None) -> DNDarray:
    """The inverse tangent."""
    return _operations.__local_op(torch.atan, x, out)


atan = arctan


def _atan2(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``atan2``; of complex operands XLA's ``-i log((x + iy) / sqrt(x^2 + y^2))``."""
    if y.is_complex() or x.is_complex():
        y, x = torch.broadcast_tensors(*(t.to(torch.result_type(y, x)) for t in (y, x)))
        return -1j * torch.log((x + 1j * y) / torch.sqrt(x * x + y * y))
    return torch.atan2(y, x)


def _scaled(factor: float):
    """Multiplication by ``factor`` in the operand's own type (torch's
    deg2rad and rad2deg refuse complex operands)."""
    return lambda a: a * torch.tensor(factor, dtype=a.dtype)


def arctan2(t1, t2) -> DNDarray:
    """The angle of the point ``(t2, t1)``, by quadrant."""
    return _operations.__binary_op(_inexact(_atan2), t1, t2)


atan2 = arctan2


def arctanh(x, out=None) -> DNDarray:
    """The inverse hyperbolic tangent."""
    return _operations.__local_op(torch.atanh, x, out)


atanh = arctanh


def cos(x, out=None) -> DNDarray:
    """The cosine."""
    return _operations.__local_op(torch.cos, x, out)


def cosh(x, out=None) -> DNDarray:
    """The hyperbolic cosine."""
    return _operations.__local_op(torch.cosh, x, out)


def deg2rad(x, out=None) -> DNDarray:
    """Degrees to radians."""
    return _operations.__local_op(_scaled(math.pi / 180), x, out)


radians = deg2rad


def rad2deg(x, out=None) -> DNDarray:
    """Radians to degrees."""
    return _operations.__local_op(_scaled(180 / math.pi), x, out)


degrees = rad2deg


def sin(x, out=None) -> DNDarray:
    """The sine."""
    return _operations.__local_op(torch.sin, x, out)


def sinh(x, out=None) -> DNDarray:
    """The hyperbolic sine."""
    return _operations.__local_op(torch.sinh, x, out)


def tan(x, out=None) -> DNDarray:
    """The tangent."""
    return _operations.__local_op(torch.tan, x, out)


def tanh(x, out=None) -> DNDarray:
    """The hyperbolic tangent."""
    return _operations.__local_op(torch.tanh, x, out)


def sinc(x, out=None) -> DNDarray:
    """The normalized sinc, ``sin(pi x) / (pi x)``."""
    return _operations.__local_op(torch.sinc, x, out)


def i0(x, out=None) -> DNDarray:
    """The modified Bessel function of the first kind, of order 0."""
    _operations._refuse_complex("i0", ValueError, x)
    return _operations.__local_op(torch.i0, x, out)


def unwrap(p, discont=None, axis: int = -1, period: float = 2 * math.pi) -> DNDarray:
    """Unwrap a phase along ``axis``, as JAX's ``unwrap``: where two
    neighbours differ by more than ``discont`` (``period / 2`` by default)
    the rest of the signal moves by multiples of ``period``.  Along the
    split axis each rank differences its first row against the previous
    rank's last (a halo), and the corrections add up by a scan."""
    if not isinstance(p, DNDarray):
        raise TypeError(f"expected p to be a DNDarray, but was {type(p)}")
    if types.heat_type_is_complexfloating(p.dtype):
        raise ValueError("jnp.unwrap does not support complex inputs.")
    axis = sanitize_axis(p.shape, axis)
    target = p.dtype if types.heat_type_is_inexact(p.dtype) else types.result_type(p.dtype, 1.0)
    x = p.astype(target)
    if p.shape[axis] == 0:
        return x
    dt = target.torch_type()
    period_t = torch.tensor(period, dtype=dt)
    discont_t = period_t / 2 if discont is None else torch.tensor(discont, dtype=dt)
    interval = period_t / 2
    data = x.larray_padded
    if x.split == axis:
        prev, _ = _halos(x, 1)
        first = data.narrow(axis, 0, 1) if prev is None else prev.to(data.device)
        before = torch.cat([first, data.narrow(axis, 0, data.shape[axis] - 1)], dim=axis)
    else:
        before = torch.cat([data.narrow(axis, 0, 1), data.narrow(axis, 0, data.shape[axis] - 1)], dim=axis)
    dd = data - before  # 0 at the first row: no correction there
    dev = data.device
    interval, period_t, discont_t = interval.to(dev), period_t.to(dev), discont_t.to(dev)
    ddmod = torch.remainder(dd + interval, period_t) - interval
    ddmod = torch.where((ddmod == -interval) & (dd > 0), interval, ddmod)
    correct = torch.where(dd.abs() < discont_t, torch.zeros_like(dd), ddmod - dd)
    corrections = _operations.__cum_op(x._like(correct, dtype=target), axis, _CUMSUM, torch.add, 0)
    return x._like(data + corrections.larray_padded, dtype=target)._propagate_layout_from(p)
