"""Matrix product, norm and transpose (counterpart of heat_tpu/core/linalg/basics.py).

Float32 products stay in full float32: the JAX package asks for
``Precision.HIGHEST``, and TF32 (about three decimal digits) is in neither
of its precision classes.  :func:`full_f32_matmul` holds that for the
products the port computes, whatever the process has set.
"""

from __future__ import annotations

import contextlib

import torch

from .. import types
from ..dndarray import DNDarray
from ..sanitation import sanitize_in

__all__ = ["full_f32_matmul", "matmul", "norm", "transpose"]


@contextlib.contextmanager
def full_f32_matmul():
    """Run the enclosed float32 matrix products in IEEE float32 (no TF32)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def matmul(a: DNDarray, b: DNDarray) -> DNDarray:
    """Matrix product of two 2-D arrays.

    A row-split ``a`` times a whole ``b`` is local on every rank and keeps
    the split; any other layout is computed on the gathered operands, with
    the result split like ``a``'s rows or ``b``'s columns."""
    if not isinstance(a, DNDarray) or not isinstance(b, DNDarray):
        raise TypeError(f"matmul takes DNDarrays, got {type(a)} and {type(b)}")
    if a.ndim != 2 or b.ndim != 2:
        raise NotImplementedError(f"matmul of {a.ndim}-D by {b.ndim}-D arrays is not ported yet")
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul: shapes {a.shape} and {b.shape} are not aligned")
    dt = types.promote_types(a.dtype, b.dtype).torch_type()
    gshape = (a.shape[0], b.shape[1])
    with full_f32_matmul():
        if b.split is None and a.split in (None, 0):
            local = a.larray_padded.to(dt) @ b.larray_padded.to(dt)
            return a._like(local, gshape, a.split)
        out = a._dense().to(dt) @ b._dense().to(dt)
    split = 0 if a.split == 0 else (1 if b.split == 1 else None)
    return DNDarray.from_dense(out, split, a.device, a.comm)


def norm(x: DNDarray, axis=None, keepdims: bool = False) -> DNDarray:
    """2-norm over ``axis``: of vectors along one axis, or the Frobenius norm
    of the whole array when ``axis`` is None."""
    from .. import arithmetics

    if not types.heat_type_is_inexact(x.dtype):
        x = x.astype(types.float32)
    s = arithmetics.sum(x * x, axis=axis, keepdims=keepdims)
    return s._like(torch.sqrt(s.larray_padded))


def transpose(a: DNDarray) -> DNDarray:
    """The transpose of a 2-D array.

    Each rank transposes its padded chunk, and the split moves with its
    axis (split 0 becomes split 1 and back): nothing is gathered."""
    sanitize_in(a)
    if a.ndim != 2:
        raise NotImplementedError(f"transpose of a {a.ndim}-D array is not ported yet")
    split = None if a.split is None else 1 - a.split
    return a._like(a.larray_padded.T, (a.shape[1], a.shape[0]), split)
