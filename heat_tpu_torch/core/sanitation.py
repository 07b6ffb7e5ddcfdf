"""Input and output validation (counterpart of heat_tpu/core/sanitation.py)."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from . import types
from .dndarray import DNDarray

__all__ = [
    "sanitize_distribution",
    "sanitize_in",
    "sanitize_in_nd_realfloating",
    "sanitize_in_tensor",
    "sanitize_infinity",
    "sanitize_lshape",
    "sanitize_out",
    "sanitize_sequence",
    "scalar_to_1d",
    "store_out",
]


def sanitize_infinity(x):
    """The largest value of the input's type: a float type's largest finite
    value, an integer type's largest integer."""
    t = types.heat_type_of(x)
    if types.heat_type_is_inexact(t):
        return types.finfo(t).max
    return types.iinfo(t).max


def sanitize_sequence(seq) -> list:
    """A list or tuple as a list; anything else raises."""
    if isinstance(seq, list):
        return seq
    if isinstance(seq, tuple):
        return list(seq)
    raise TypeError(f"seq must be a list or a tuple, got {type(seq)}")


def sanitize_distribution(*args: DNDarray, target: DNDarray, diff_map=None):
    """Each of ``args`` laid out as ``target``: an array of ``target``'s
    shape and another split is resplit (one all-to-all); the canonical
    layout follows from the split, so nothing else moves."""
    out = []
    for a in args:
        sanitize_in(a)
        if a.split != target.split and a.shape == target.shape:
            a = a.resplit(target.split)
        out.append(a)
    return out[0] if len(out) == 1 else tuple(out)


def sanitize_in(x) -> None:
    """Raise unless ``x`` is a DNDarray."""
    if not isinstance(x, DNDarray):
        raise TypeError(f"input needs to be a DNDarray, but was {type(x)}")


def sanitize_in_nd_realfloating(x, name: str, allowed_dims: Sequence[int]) -> None:
    """Raise unless ``x`` is a real floating DNDarray of one of ``allowed_dims``."""
    sanitize_in(x)
    if x.ndim not in allowed_dims:
        raise ValueError(f"{name} must be {allowed_dims}-dimensional, but is {x.ndim}-dimensional")
    if not types.heat_type_is_realfloating(x.dtype):
        raise TypeError(f"{name} must be real floating, got {x.dtype.__name__}")


def sanitize_in_tensor(x) -> None:
    """Raise unless ``x`` is a torch tensor (the reference's: a jax array)."""
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"input needs to be a torch tensor, but was {type(x)}")


def sanitize_lshape(array: DNDarray, tensor) -> None:
    """Raise unless ``tensor`` has the shape of the array's true local chunk."""
    tshape = tuple(tensor.shape)
    if tshape != array.lshape:
        raise ValueError(f"local tensor must have shape {array.lshape}, got {tshape}")


def sanitize_out(out, output_shape: Tuple[int, ...], output_split: Optional[int], output_device,
                 output_comm=None) -> None:
    """Raise unless ``out`` is a DNDarray of ``output_shape``."""
    if not isinstance(out, DNDarray):
        raise TypeError(f"expected out to be None or a DNDarray, but was {type(out)}")
    if tuple(out.shape) != tuple(output_shape):
        raise ValueError(f"Expecting output buffer of shape {tuple(output_shape)}, got {tuple(out.shape)}")


def store_out(res: DNDarray, out: DNDarray) -> DNDarray:
    """Check ``out`` and write ``res``'s values into it, cast to its type and
    laid out along its split."""
    sanitize_out(out, res.shape, res.split, res.device)
    if res.split != out.split:
        res = res.resplit(out.split)
    out._replace(types._cast(res.larray_padded, res.dtype, out.dtype))
    return out


def scalar_to_1d(x: DNDarray) -> DNDarray:
    """A 0-d DNDarray as a 1-d one of one element (others as they are)."""
    if x.ndim != 0:
        return x
    return x._like(x.larray_padded.reshape(1), (1,), None, x.dtype)
