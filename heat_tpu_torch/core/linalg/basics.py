"""Products, norms, transposes and triangles (counterpart of
heat_tpu/core/linalg/basics.py).

Float32 products stay in full float32: the JAX package asks for
``Precision.HIGHEST``, and TF32 (about three decimal digits) is in neither
of its precision classes.  :func:`full_f32_matmul` holds that for the
products the port computes, whatever the process has set.

A product contracts each rank's own slices of the inner axis where that
axis is split (the padding zeroed) and adds the ranks' partial products
with one all-reduce; an operand whole on every rank gives each rank its own
slice without communication.  Only a product whose output is split along
one operand's outer axis while the other operand is split too gathers that
other operand, as the reference's collective matmul does.  The result's
split is the reference's.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional, Sequence

import torch

from .. import types
from ..dndarray import DNDarray, _pad_along
from ..sanitation import sanitize_in, store_out
from ..stride_tricks import sanitize_axis

__all__ = [
    "cross",
    "det",
    "dot",
    "full_f32_matmul",
    "inv",
    "matmul",
    "matrix_norm",
    "norm",
    "outer",
    "projection",
    "trace",
    "transpose",
    "tril",
    "triu",
    "vdot",
    "vecdot",
    "vector_norm",
]


@contextlib.contextmanager
def full_f32_matmul():
    """Run the enclosed float32 matrix products in IEEE float32 (no TF32)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (numpy's ``matmul``) in full float32; integers and bools,
    which cuBLAS does not multiply, by :func:`_int_mm` on the card (exact,
    wrapping as the reference's integer products), a bool product as the
    truth of the integer one."""
    if a.is_floating_point() or a.is_complex():
        with full_f32_matmul():
            return torch.matmul(a, b)
    if a.dtype == torch.bool:
        return _mm(a.to(torch.int64), b.to(torch.int64)) != 0
    if not a.is_cuda:
        return torch.matmul(a, b)
    out = _int_mm(a[None] if a.ndim == 1 else a, b[:, None] if b.ndim == 1 else b)
    if b.ndim == 1:
        out = out.squeeze(-1)
    return out.squeeze(-2) if a.ndim == 1 else out


_INT_MM_BUDGET = 1 << 25  # elements of the largest temporary of an integer product


def _int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The (batched) product of integer matrices in their own dtype, wrapping:
    blocks of rows of ``a`` times blocks of the inner axis, each the sum of
    the products ``a[..., rows, ks, None] * b[..., None, ks, :]`` added into
    the output, the blocks sized so that no temporary holds more than
    ``_INT_MM_BUDGET`` elements."""
    batch = tuple(torch.broadcast_shapes(a.shape[:-2], b.shape[:-2]))
    m, k, n = a.shape[-2], a.shape[-1], b.shape[-1]
    out = torch.zeros(batch + (m, n), dtype=a.dtype, device=a.device)
    per = max(1, math.prod(batch) * n)  # temporary elements per row and inner index
    kb = max(1, min(k, _INT_MM_BUDGET // (per * max(1, m))))
    mb = max(1, min(m, _INT_MM_BUDGET // (per * kb)))
    for i in range(0, m, mb):
        rows = out[..., i:i + mb, :]
        for j in range(0, k, kb):
            rows += (a[..., i:i + mb, j:j + kb, None] * b[..., None, j:j + kb, :]).sum(-2, dtype=a.dtype)
    return out


def _inner(t: DNDarray, axis: int, zero_pad: bool) -> torch.Tensor:
    """``t``'s tensor for a contraction over its split ``axis``: this rank's
    padded slice, the padding zeroed where ``zero_pad``."""
    return t._masked(0) if zero_pad else t.larray_padded


def _slice_whole(t: DNDarray, axis: int, like: DNDarray, like_axis: int) -> torch.Tensor:
    """This rank's slice along ``axis`` of the whole ``t``, cut and padded
    as ``like``'s chunk along ``like_axis`` (no communication)."""
    comm = like.comm
    lo, lshape, _ = comm.chunk(like.shape, like_axis)
    per = comm.padded_extent(like.shape[like_axis]) // comm.size
    return _pad_along(t.larray.narrow(axis, lo, lshape[like_axis]), axis, per)


def matmul(a: DNDarray, b: DNDarray, allow_resplit: bool = False) -> DNDarray:
    """The matrix product, numpy's ``matmul`` (1-D operands and batches).

    The output split is the reference's: a row-split ``a`` keeps its rows
    split, a column-split ``b`` its columns, a batch split stays; an inner
    split reduces to a whole result.  Split 1 by split 0 is a local product
    of each rank's slices plus one all-reduce; a whole operand gives each
    rank its own slice."""
    sanitize_in(a)
    sanitize_in(b)
    if a.ndim == 0 or b.ndim == 0:
        raise ValueError("matmul requires at least 1-dimensional inputs")
    if a.shape[-1] != b.shape[-2 if b.ndim > 1 else 0]:
        raise ValueError(f"matmul: shapes {a.shape} and {b.shape} are not aligned")
    promoted = types.promote_types(a.dtype, b.dtype)
    if a.dtype != promoted:
        a = a.astype(promoted)
    if b.dtype != promoted:
        b = b.astype(promoted)
    comm = a.comm
    ka, kb = a.ndim - 1, (b.ndim - 2 if b.ndim > 1 else 0)  # the inner axes
    out_ndim = len(torch.broadcast_shapes(a.shape[:-2], b.shape[:-2] if b.ndim > 2 else ())) + \
        (a.ndim > 1) + (b.ndim > 1)
    if a.ndim == 1:
        gshape = tuple(b.shape[:-2]) + (tuple(b.shape[-1:]) if b.ndim > 1 else ())
    elif b.ndim == 1:
        gshape = tuple(a.shape[:-1])
    else:
        gshape = tuple(torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])) + (a.shape[-2], b.shape[-1])
    out_split = _matmul_split(a, b, out_ndim)
    a_inner, b_inner = a.split == ka, b.split == kb
    if a_inner or b_inner:
        if a_inner and b_inner:
            local = _mm(_inner(a, ka, True), _inner(b, kb, True))
        elif a_inner and b.split is None:
            local = _mm(_inner(a, ka, True), _slice_whole(b, kb, a, ka))
        elif b_inner and a.split is None:
            local = _mm(_slice_whole(a, ka, b, kb), _inner(b, kb, True))
        else:
            local = None
        if local is not None:
            local = comm.psum(local.contiguous()) if comm.size > 1 else local
            return DNDarray.from_dense(local, out_split, a.device, comm)
    if out_split is not None and a.split is not None and a.split != ka and b.split is None:
        # rows (or a batch) of a split, b whole: local
        return a._like(_mm(a.larray_padded, b.larray_padded), gshape, out_split)
    if out_split is not None and b.ndim > 1 and b.split == b.ndim - 1 and a.split is None:
        return a._like(_mm(a.larray_padded, b.larray_padded), gshape, out_split)
    # the output split along one operand's axis and the other operand split
    # too: that other operand gathered, then local
    if out_split is not None and a.split is not None and a.split != ka:
        return a._like(_mm(a.larray_padded, b._dense()), gshape, out_split)
    if out_split is not None and b.split is not None and b.split != kb:
        return a._like(_mm(a._dense(), b.larray_padded), gshape, out_split)
    return DNDarray.from_dense(_mm(a._dense(), b._dense()), out_split, a.device, comm)


def _matmul_split(a: DNDarray, b: DNDarray, out_ndim: int) -> Optional[int]:
    """The reference's output split of ``matmul``."""
    out_split = None
    if a.ndim >= 2 and b.ndim >= 2:
        batch = out_ndim - 2
        if a.split is not None:
            if a.split < a.ndim - 2:
                out_split = a.split + (batch - (a.ndim - 2))
            elif a.split == a.ndim - 2:
                out_split = out_ndim - 2
        if out_split is None and b.split is not None:
            if b.split < b.ndim - 2:
                out_split = b.split + (batch - (b.ndim - 2))
            elif b.split == b.ndim - 1:
                out_split = out_ndim - 1
    elif a.ndim == 1 and b.ndim >= 2:
        if b.split == b.ndim - 1 and out_ndim > 0:
            out_split = out_ndim - 1
    elif b.ndim == 1 and a.ndim >= 2:
        if a.split == a.ndim - 2 and out_ndim > 0:
            out_split = out_ndim - 1
    return None if out_ndim == 0 else out_split


def dot(a: DNDarray, b: DNDarray, out: Optional[DNDarray] = None):
    """numpy's ``dot``: the inner product of vectors (a local product of
    each rank's slices plus one all-reduce), or :func:`matmul` of 2-D
    operands."""
    sanitize_in(a)
    sanitize_in(b)
    if a.ndim <= 2 and b.ndim <= 2:
        res = matmul(a, b)
    else:
        raise NotImplementedError("ht.dot supports 1-D and 2-D operands")
    if out is not None:
        return store_out(res, out)
    return res


def vdot(x1: DNDarray, x2: DNDarray) -> DNDarray:
    """The dot product of the flattened arrays, the first conjugated."""
    sanitize_in(x1)
    sanitize_in(x2)
    from .. import arithmetics, complex_math

    if x1.shape != x2.shape:
        raise ValueError(f"vdot: shapes {x1.shape} and {x2.shape} differ")
    return arithmetics.sum(arithmetics.mul(complex_math.conjugate(x1), x2))


def vecdot(x1: DNDarray, x2: DNDarray, axis: Optional[int] = None, keepdims: bool = False) -> DNDarray:
    """The dot product of vectors along ``axis`` (the last by default), the
    first conjugated; the first operand's split stays where it survives."""
    sanitize_in(x1)
    sanitize_in(x2)
    from .. import arithmetics, complex_math

    prod = arithmetics.mul(complex_math.conjugate(x1), x2)
    ax = sanitize_axis(prod.shape, -1 if axis is None else axis)
    # the sum in the operands' promoted type, as the reference's: integers
    # wrap in their own width, a bool product is the truth of any term
    res = arithmetics.sum(prod, axis=ax, keepdims=keepdims).astype(prod.dtype, copy=False)
    # the reference keeps the first operand's split where the result has
    # that axis, the reduced one included
    return _with_split(res, x1.split if x1.split is not None and x1.split < res.ndim else None)


def _with_split(res: DNDarray, split: Optional[int]) -> DNDarray:
    """``res`` split along ``split``: a whole result is cut locally."""
    if res.split == split:
        return res
    if res.split is None:
        return DNDarray.from_dense(res.larray, split, res.device, res.comm, res.dtype)
    return res.resplit(split)


def _flattened(t: DNDarray) -> DNDarray:
    """A 1-D view of ``t`` (row-major), split where ``t`` was: a split N-D
    operand is gathered and cut again as a vector."""
    if t.ndim == 1:
        return t
    return DNDarray.from_dense(t._dense().reshape(-1), None if t.split is None else 0, t.device, t.comm, t.dtype)


def outer(a: DNDarray, b: DNDarray, out: Optional[DNDarray] = None, split: Optional[int] = None) -> DNDarray:
    """The outer product of two vectors (flattened), split along 0 where
    either is split, or along ``split``: each rank multiplies its own
    entries of the split side by the whole other vector."""
    sanitize_in(a)
    sanitize_in(b)
    if split is None:
        split = 0 if (a.split is not None or b.split is not None) else None
    # N-D operands are flattened, as numpy's outer does
    a, b = _flattened(a), _flattened(b)
    promoted = types.promote_types(a.dtype, b.dtype)
    a, b = a.astype(promoted), b.astype(promoted)
    gshape = (a.shape[0], b.shape[0])
    if split is None:
        local = torch.outer(a._dense(), b._dense())
    elif split == 0:
        local = torch.outer(a.larray_padded if a.split == 0 else _slice_whole(a, 0, a, 0), b._dense())
    else:
        local = torch.outer(a._dense(), b.larray_padded if b.split == 0 else _slice_whole(b, 0, b, 0))
    res = a._like(local, gshape, split)
    if out is not None:
        return store_out(res, out)
    return res


def cross(a: DNDarray, b: DNDarray, axisa: int = -1, axisb: int = -1, axisc: int = -1, axis: int = -1) -> DNDarray:
    """The cross product of 3-element (or 2-element) vectors along the
    given axes, element-wise across the others: local where the split lies
    on another axis."""
    sanitize_in(a)
    sanitize_in(b)
    if axis != -1:
        axisa = axisb = axisc = axis
    axisa, axisb = sanitize_axis(a.shape, axisa), sanitize_axis(b.shape, axisb)
    n = a.shape[axisa]
    if n not in (2, 3) or b.shape[axisb] not in (2, 3):
        raise ValueError("incompatible dimensions for cross product (dimension must be 2 or 3)")
    def op(x, y):
        x = torch.movedim(x, axisa, -1)
        y = torch.movedim(y, axisb, -1)
        if x.shape[-1] == 2:
            x = torch.nn.functional.pad(x, (0, 1))
        if y.shape[-1] == 2:
            y = torch.nn.functional.pad(y, (0, 1))
        x, y = torch.broadcast_tensors(x, y)
        c = torch.linalg.cross(x, y, dim=-1)
        if a.shape[axisa] == 2 and b.shape[axisb] == 2:
            return c[..., 2]
        return torch.movedim(c, -1, axisc % c.ndim)

    promoted = types.promote_types(a.dtype, b.dtype)
    a, b = a.astype(promoted), b.astype(promoted)
    if a.shape == b.shape and a.split == b.split and axisa == axisb and a.split != axisa:
        # each rank's vectors: element-wise across the other axes
        local = op(a.larray_padded, b.larray_padded)
        gshape = [d for i, d in enumerate(a.shape) if i != axisa]
        if local.ndim == a.ndim:
            gshape.insert(axisc % a.ndim, 3)
        split = a.split if a.split is not None and a.split < len(gshape) else None
        return a._like(local, tuple(gshape), split)
    res = op(a._dense(), b._dense())
    split = a.split if a.split is not None and a.split < res.ndim else None
    return DNDarray.from_dense(res, split, a.device, a.comm)


def projection(a: DNDarray, b: DNDarray) -> DNDarray:
    """The projection of the vector ``a`` onto ``b``: two inner products
    (one all-reduce each), then ``b`` scaled on every rank."""
    sanitize_in(a)
    sanitize_in(b)
    if a.ndim != 1 or b.ndim != 1:
        raise RuntimeError(f"projection requires 1-D vectors, got {a.ndim}-D and {b.ndim}-D")
    coeff = dot(a, b).larray_padded / dot(b, b).larray_padded
    res = b.astype(types.canonical_heat_type(coeff.dtype)) if types.canonical_heat_type(coeff.dtype) != b.dtype \
        else b
    return b._like(coeff * res.larray_padded)


def trace(a: DNDarray, offset: int = 0, axis1: int = 0, axis2: int = 1, dtype=None, out=None):
    """The sum along a diagonal: each rank adds the diagonal entries of its
    own rows (or columns), one all-reduce; a 0-d result comes back as a
    python scalar, as the reference's."""
    sanitize_in(a)
    if a.ndim < 2:
        raise ValueError("trace requires an array of at least two dimensions")
    axis1, axis2 = sanitize_axis(a.shape, axis1), sanitize_axis(a.shape, axis2)
    comm = a.comm
    data = a.larray_padded if a.split is None else a._masked(0)
    shift = 0
    if a.split in (axis1, axis2):
        lo = comm.chunk(a.shape, a.split)[0]
        shift = lo if a.split == axis1 else -lo
    local = torch.diagonal(data, offset=offset + shift, dim1=axis1, dim2=axis2)
    if local.dtype == torch.bool:
        local = local.to(torch.int64)
    s = local.sum(-1)
    if not (s.is_floating_point() or s.is_complex()):
        s = s.to(torch.int64)
    rest = [d for d in range(a.ndim) if d not in (axis1, axis2)]
    gshape = tuple(a.shape[d] for d in rest)
    if a.split in (axis1, axis2):
        s = comm.psum(s.contiguous())
        split = None
    else:
        split = None if a.split is None else rest.index(a.split)
    acc = {types.uint8: types.uint64}.get(a.dtype, types.int64 if types.heat_type_is_exact(a.dtype) else a.dtype)
    res = _with_split(a._like(s, gshape, split, acc), None)  # whole, as the reference's
    if dtype is not None:
        res = res.astype(dtype)
    if out is not None:
        return store_out(res, out)
    if res.ndim == 0:
        return res.item()
    return res


def transpose(a: DNDarray, axes: Optional[Sequence[int]] = None) -> DNDarray:
    """The axes permuted (reversed by default).  Each rank permutes its
    padded chunk and the split moves with its axis: nothing is gathered."""
    sanitize_in(a)
    if axes is None:
        perm = tuple(reversed(range(a.ndim)))
    else:
        perm = tuple(sanitize_axis(a.shape, ax) for ax in axes)
        if len(perm) != a.ndim or len(set(perm)) != a.ndim:
            raise ValueError(f"axes must be a permutation of dimensions, got {axes}")
    split = perm.index(a.split) if a.split is not None else None
    return a._like(a.larray_padded.permute(perm), tuple(a.shape[p] for p in perm), split, a.dtype)


def _tri(m: DNDarray, k: int, lower: bool) -> DNDarray:
    """tril/triu of the last two axes: each rank shifts ``k`` by its first
    row (or column) where those axes are split."""
    sanitize_in(m)
    op = torch.tril if lower else torch.triu
    if m.ndim == 1:
        row = m._dense()
        n = row.shape[0]
        whole = DNDarray.from_dense(row.expand(n, n), None, m.device, m.comm, m.dtype)
        full = whole if m.split is None else DNDarray.from_dense(row.expand(n, n).contiguous(), 0, m.device,
                                                                 m.comm, m.dtype)
        return _tri(full, k, lower)
    data = m.larray_padded
    shift = 0
    if m.split is not None and m.split >= m.ndim - 2:
        lo = m.comm.chunk(m.shape, m.split)[0]
        shift = lo if m.split == m.ndim - 2 else -lo
    if data.dtype == torch.bool:
        res = op(data.to(torch.uint8), k + shift).to(torch.bool)
    else:
        res = op(data, k + shift)
    return m._like(res, dtype=m.dtype)


def tril(m: DNDarray, k: int = 0) -> DNDarray:
    """The lower triangle (below the k-th diagonal zeroed above)."""
    return _tri(m, k, True)


def triu(m: DNDarray, k: int = 0) -> DNDarray:
    """The upper triangle (zero below the k-th diagonal)."""
    return _tri(m, k, False)


def _square_input(a: DNDarray) -> DNDarray:
    sanitize_in(a)
    if a.ndim < 2 or a.shape[-1] != a.shape[-2]:
        raise RuntimeError("Last two dimensions of the array must be square")
    return a if types.heat_type_is_inexact(a.dtype) else a.astype(types.float32)


def det(a: DNDarray) -> DNDarray:
    """The determinant: a split square matrix on more than one rank by the
    distributed LU with partial pivoting (the rows stay split); a batch or
    a whole matrix by ``torch.linalg.det``."""
    a = _square_input(a)
    from .factorizations import det_dist, supports_dist_factor

    if supports_dist_factor(a):
        return det_dist(a)
    split = a.split if a.split is not None and a.split < max(a.ndim - 2, 0) else None
    return DNDarray.from_dense(torch.linalg.det(a._dense()), split, a.device, a.comm)


def inv(a: DNDarray) -> DNDarray:
    """The inverse: a split square matrix on more than one rank by the
    distributed LU and blocked substitution against the split identity; a
    batch or a whole matrix by ``torch.linalg.inv``."""
    a = _square_input(a)
    from .factorizations import inv_dist, supports_dist_factor

    if supports_dist_factor(a):
        return inv_dist(a)
    return DNDarray.from_dense(torch.linalg.inv(a._dense()), a.split, a.device, a.comm)


# ----------------------------------------------------------------------
# norms: local partial sums or extremes, one all-reduce
# ----------------------------------------------------------------------
def _norm_input(x: DNDarray) -> DNDarray:
    return x if types.heat_type_is_inexact(x.dtype) else x.astype(types.float32)


def _abs_of(x: DNDarray) -> DNDarray:
    from .. import rounding

    return rounding.abs(x)


def _vector_norm(x: DNDarray, axis, keepdims: bool, ord) -> DNDarray:
    """JAX's vector norm over ``axis`` (an int, or all axes as one vector
    when None) for the ``ord`` values it takes."""
    from .. import arithmetics, exponential, statistics

    x = _norm_input(x)
    if ord is None or ord == 2:
        if types.heat_type_is_complexfloating(x.dtype):
            sq = x._like((x.larray_padded * x.larray_padded.conj()).real)
        else:
            sq = x * x
        return exponential.sqrt(arithmetics.sum(sq, axis=axis, keepdims=keepdims))
    mag = _abs_of(x)
    if ord == float("inf"):
        return statistics.max(mag, axis=axis, keepdims=keepdims)
    if ord == -float("inf"):
        return statistics.min(mag, axis=axis, keepdims=keepdims)
    if ord == 0:
        nz = mag._like((mag.larray_padded != 0).to(mag.larray_padded.dtype))
        return arithmetics.sum(nz, axis=axis, keepdims=keepdims)
    if ord == 1:
        return arithmetics.sum(mag, axis=axis, keepdims=keepdims)
    p = float(ord)
    powered = mag._like(mag.larray_padded ** p)
    s = arithmetics.sum(powered, axis=axis, keepdims=keepdims)
    return s._like(s.larray_padded ** (1.0 / p))


def vector_norm(x: DNDarray, axis=None, keepdims: bool = False, ord=None) -> DNDarray:
    """The vector norm over ``axis`` (the flattened array when None):
    local partial sums (or extremes) and one all-reduce across the split
    axis."""
    sanitize_in(x)
    if isinstance(axis, tuple):
        if len(axis) > 1:
            raise TypeError("axis must be an integer or 1-tuple for vector_norm")
        axis = axis[0]
    if axis is None:
        # the flattened array, one vector: keepdims keeps its one axis
        res = _vector_norm(x, None, False, 2 if ord is None else ord)
        if keepdims:
            res = res._like(res.larray_padded.reshape(1), (1,), None)
        return res
    return _vector_norm(x, sanitize_axis(x.shape, axis), keepdims, ord)


def _matrix_norm(x: DNDarray, axes, keepdims: bool, ord) -> DNDarray:
    """JAX's matrix norms over the pair ``axes``: Frobenius, the largest or
    smallest column (1) or row (inf) sum of magnitudes, each by local sums
    and all-reduces; 2, -2 and the nuclear norm from the singular values of
    the gathered matrices."""
    from .. import arithmetics, statistics

    x = _norm_input(x)
    r, c = axes
    if ord is None or ord == "fro":
        return _vector_norm_pair(x, axes, keepdims)
    if ord in (1, -1, float("inf"), -float("inf")):
        mag = _abs_of(x)
        inner, outer_ = (r, c) if ord in (1, -1) else (c, r)
        sums = arithmetics.sum(mag, axis=inner, keepdims=True)
        pick = statistics.max if ord in (1, float("inf")) else statistics.min
        res = pick(sums, axis=outer_, keepdims=True)
        if not keepdims:
            shape = tuple(s for d, s in enumerate(res.shape) if d not in axes)
            res = _squeeze(res, axes, shape)
        return res
    if ord in (2, -2, "nuc"):
        dense = x._dense()
        moved = torch.movedim(dense, (r, c), (-2, -1))
        sv = torch.linalg.svdvals(moved)
        val = sv.sum(-1) if ord == "nuc" else (sv.amax(-1) if ord == 2 else sv.amin(-1))
        if keepdims:
            val = val.unsqueeze(min(r, c)).unsqueeze(max(r, c))
        return DNDarray.from_dense(val, None, x.device, x.comm)
    raise ValueError(f"Invalid norm order {ord!r} for matrices")


def _squeeze(res: DNDarray, axes, shape) -> DNDarray:
    """``res`` with the kept axes of length 1 in ``axes`` dropped."""
    split = res.split
    if split is not None:
        split = None if split in axes else split - sum(1 for a in axes if a < split)
    return res._like(res.larray_padded.squeeze(max(axes)).squeeze(min(axes)), shape, split, res.dtype)


def _vector_norm_pair(x: DNDarray, axes, keepdims: bool) -> DNDarray:
    from .. import arithmetics, exponential

    if types.heat_type_is_complexfloating(x.dtype):
        sq = x._like((x.larray_padded * x.larray_padded.conj()).real)
    else:
        sq = x * x
    return exponential.sqrt(arithmetics.sum(sq, axis=axes, keepdims=keepdims))


def matrix_norm(x: DNDarray, axis=None, keepdims: bool = False, ord=None) -> DNDarray:
    """The matrix norm over a pair of axes (the two axes of a matrix when
    None): Frobenius by default."""
    sanitize_in(x)
    if axis is None:
        if x.ndim != 2:
            raise ValueError("input is not a matrix; specify axis")
        axis = (0, 1)
    if not (isinstance(axis, tuple) and len(axis) == 2):
        raise TypeError("axis must be a 2-tuple")
    axes = tuple(sanitize_axis(x.shape, a) for a in axis)
    res = _matrix_norm(x, axes, keepdims, ord)
    if res.split is not None:
        res = res.resplit(None)
    return res


def norm(x: DNDarray, axis=None, keepdims: bool = False, ord=None) -> DNDarray:
    """numpy's ``linalg.norm``: the 2-norm of the flattened array by
    default, a vector norm over one axis, a matrix norm over two (or of a
    2-D array with ``ord``)."""
    sanitize_in(x)
    if axis is None:
        if ord is None:
            res = _vector_norm(x, None, False, 2)
            if keepdims:
                res = res._like(res.larray_padded.reshape((1,) * x.ndim), (1,) * x.ndim, None)
            return res
        if x.ndim == 1:
            return _vector_norm(x, 0, keepdims, ord)
        if x.ndim == 2:
            return _matrix_norm(x, (0, 1), keepdims, ord)
        raise ValueError("Improper number of dimensions to norm.")
    if isinstance(axis, (tuple, list)) and len(axis) == 2:
        return _matrix_norm(x, tuple(sanitize_axis(x.shape, a) for a in axis), keepdims, ord)
    if isinstance(axis, (tuple, list)):
        axis = axis[0]
    return _vector_norm(x, sanitize_axis(x.shape, axis), keepdims, ord)
