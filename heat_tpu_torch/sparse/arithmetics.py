"""Sparse arithmetic over the planes (counterpart of
heat_tpu/sparse/arithmetics.py; heat's sparse add and mul).

Element-wise union and intersection merge two matrices' sorted entries on
each rank; the products sum sorted runs (plus a ppermute ring, a
reduce-scatter or an all-reduce across ranks); every op ends in the same
small nnz re-sync (:mod:`._planes`).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core import _env, types
from ..core.dndarray import DNDarray
from . import _planes as _pl
from .dcsx_matrix import DCSC_matrix, DCSR_matrix, DCSX_matrix

__all__ = ["add", "mul", "sum", "matmul"]

def _binary_op_csx(op_name: str, t1: DCSX_matrix, t2: DCSX_matrix) -> DCSX_matrix:
    """A sparse-sparse element-wise op: pattern union (add) or intersection
    (mul) of two matrices of one format and shape."""
    if not isinstance(t1, DCSX_matrix) or not isinstance(t2, DCSX_matrix):
        raise TypeError(f"both operands must be sparse matrices, got {type(t1)}, {type(t2)}")
    if type(t1) is not type(t2):
        raise TypeError(f"operands must share the sparse format, got {type(t1).__name__} and {type(t2).__name__}")
    if t1.shape != t2.shape:
        raise ValueError(f"shapes must match, got {t1.shape} and {t2.shape}")
    if t1.split != t2.split:
        t2 = _align_split(t2, t1.split)  # the second operand takes the first's split
    res = types.promote_types(t1.dtype, t2.dtype)
    a = t1 if t1.dtype is res else t1.astype(res)
    b = t2 if t2.dtype is res else t2.astype(res)
    comp, other, val, lnnz, capacity = _pl.merge_planes(
        op_name, a._planes, b._planes, a._n, b._n, a.shape[1 - a._compressed_axis], a._comp_pad, a._dist, a.comm)
    return a._with_planes((comp, other, val), lnnz, capacity, dtype=res)


def _align_split(t: DCSX_matrix, split) -> DCSX_matrix:
    """The matrix re-split between None and its compressed axis; only the
    count re-sync touches the host."""
    extent = t.shape[t._compressed_axis]
    built = _pl.rechunk_planes(t._comp, t._other, t._val, t._lnnz_host, extent, split is not None, t._comp_pad,
                               t.comm)
    return type(t)._from_built(built, t.shape, t.dtype, split, t.device, t.comm)


def _is_scalar(x) -> bool:
    return np.isscalar(x) and not isinstance(x, (str, bytes))


def add(t1, t2):
    """Element-wise sparse addition: the union of the patterns, pairs
    added; a scalar is added to the stored values only."""
    if isinstance(t1, DCSX_matrix) and _is_scalar(t2):
        return _scalar_op("add", t1, t2)
    if isinstance(t2, DCSX_matrix) and _is_scalar(t1):
        return _scalar_op("add", t2, t1)
    return _binary_op_csx("add", t1, t2)


def mul(t1, t2):
    """Element-wise sparse multiplication: the intersection of the
    patterns; a scalar scales the stored values."""
    if isinstance(t1, DCSX_matrix) and _is_scalar(t2):
        return _scalar_op("mul", t1, t2)
    if isinstance(t2, DCSX_matrix) and _is_scalar(t1):
        return _scalar_op("mul", t2, t1)
    return _binary_op_csx("mul", t1, t2)


def _scalar_op(op_name: str, t: DCSX_matrix, s) -> DCSX_matrix:
    """The scalar applied to the stored values (the padding stays 0), in the
    reference's result type (JAX's weak scalars)."""
    res = types.result_type(t.dtype, s)
    val = types._cast(t._val, t.dtype, res)
    sv = torch.tensor(s, dtype=res.torch_type(), device=val.device)
    if op_name == "mul":
        val = val * sv
    else:
        val = torch.where(t._comp < t._comp_pad, val + sv, torch.zeros((), dtype=val.dtype, device=val.device))
    return t._with_planes((t._comp, t._other, val), t._lnnz_host, t._capacity, dtype=res)


def sum(t: DCSX_matrix, axis=None) -> DNDarray:
    """The sum of the stored values: a 0-d total (axis None) or a dense
    vector split 0 (axis 0 or 1).  Along the uncompressed axis the ranks'
    partial sums meet in one reduce-scatter."""
    if not isinstance(t, DCSX_matrix):
        raise TypeError(f"expected a sparse matrix, got {type(t)}")
    if axis is None:
        res = t.dtype  # integers sum in 64 bits, as jnp.sum promotes them
        if types.heat_type_is_exact(res):
            res = types.uint64 if issubclass(res, types.unsignedinteger) else types.int64
        total = t._val[: t._n].to(res.torch_type()).sum()
        if t._dist:
            total = t.comm.psum(total)
        return DNDarray.from_dense(total, None, t.device, t.comm, dtype=res)
    axis = axis if axis >= 0 else axis + 2
    if axis not in (0, 1):
        raise ValueError(f"axis must be 0, 1 or None, got {axis}")
    out_axis = 1 - axis  # one value per index of the axis that is not reduced
    out_len = t.shape[out_axis]
    if out_axis == t._compressed_axis:
        res = _pl.sum_comp(t._comp, t._other, t._val, t._n, t._comp_pad, t.shape[1 - t._compressed_axis])
    else:
        other_extent = t.shape[1 - t._compressed_axis]
        other_pad = t.comm.padded_extent(other_extent) if t._dist else other_extent
        res = _pl.sum_other(t._other, t._val, t._n, other_pad, t._by_other(), t._dist, t.comm)
    if not t._dist:
        return DNDarray.from_dense(res[:out_len], None, t.device, t.comm, dtype=t.dtype)
    return DNDarray(res, (out_len,), t.dtype, 0, t.device, t.comm)


def matmul(a, b):
    """The matrix product: sparse @ sparse -> sparse (a's format), sparse @
    dense and dense @ sparse -> dense DNDarray.  A row-compressed operand
    keeps whole output rows on each rank (the dense operand's row chunks
    ride a ppermute ring); a column-compressed one contracts against the
    dense operand's co-chunked rows and the partial products meet in one
    reduce-scatter."""
    a_sp, b_sp = isinstance(a, DCSX_matrix), isinstance(b, DCSX_matrix)
    if not a_sp and not b_sp:
        raise TypeError("at least one operand must be a sparse matrix")
    if a_sp and b_sp:
        return _spgemm(a, b)
    if a_sp:
        return _sp_dense(a, b)
    return _dense_sp(a, b)


def _dense_operand(x, like: DCSX_matrix) -> DNDarray:
    if isinstance(x, DNDarray):
        return x
    from ..core import factories

    return factories.array(np.asarray(x), device=like.device, comm=like.comm)


def _sp_dense(a: DCSX_matrix, b) -> DNDarray:
    x = _dense_operand(b, a)
    if a.shape[1] != x.shape[0]:
        raise ValueError(f"shape mismatch for matmul: {a.shape} @ {x.shape}")
    m = a.shape[0]
    n = int(x.shape[1]) if x.ndim == 2 else 1
    xb = x if x.ndim == 2 else x.reshape((int(x.shape[0]), 1))
    res_type = types.promote_types(a.dtype, x.dtype)
    dt = res_type.torch_type()
    if a._compressed_axis == 0:
        if a._dist:
            xs = xb if xb.split == 0 else xb.resplit(0)
            out = _pl.spmm_rows_ring(a._comp, a._other, a._val, a._n, a._comp_pad, xs.larray_padded, dt, a.comm)
        else:
            out = _pl.spmm_rows(a._comp, a._other, a._val, a._n, a._comp_pad, xb._dense(), dt)[:m]
    else:
        xs = xb if (not a._dist or xb.split == 0) else xb.resplit(0)
        x_in = xs.larray_padded if a._dist else xs._dense()
        m_pad = a.comm.padded_extent(m) if a._dist else m
        out = _pl.spmm_inner(a._comp, a._other, a._val, a._n, a._by_other(), m_pad, x_in, dt, a._dist, a.comm)
    res = DNDarray(out, (m, n), res_type, 0 if a._dist else None, a.device, a.comm)
    return res.reshape((m,)) if x.ndim == 1 else res


def _dense_sp(a, b: DCSX_matrix) -> DNDarray:
    e = _dense_operand(a, b)
    if e.shape[-1] != b.shape[0]:
        raise ValueError(f"shape mismatch for matmul: {e.shape} @ {b.shape}")
    vec = e.ndim == 1
    eb = e.reshape((1, int(e.shape[0]))) if vec else e
    m, n = b.shape
    res_type = types.promote_types(e.dtype, b.dtype)
    dt = res_type.torch_type()
    if b._compressed_axis == 0:
        if b._dist and eb.split == 1:
            e_t, offset = eb.larray_padded.T, 0  # the rank's own columns of E are its rows of B
        else:
            e_t, offset = eb._dense().T, b._comp_pad * _pl.shard_index(b._dist, b.comm)
        out = _pl.dense_times_rows(b._comp, b._other, b._val, b._n, b._by_other(), e_t, offset, n, dt, b._dist,
                                   b.comm)
        res = DNDarray.from_dense(out, 0 if (isinstance(a, DNDarray) and a.split == 0) else None, b.device, b.comm,
                                  dtype=res_type)
    else:
        out = _pl.dense_times_cols(b._comp, b._other, b._val, b._n, b._comp_pad, eb._dense().T, dt)
        if not b._dist:
            res = DNDarray(out[:, :n], (int(eb.shape[0]), n), res_type, None, b.device, b.comm)
        else:
            res = DNDarray(out, (int(eb.shape[0]), n), res_type, 1, b.device, b.comm)
    return res.reshape((n,)) if vec else res


def _dense_density_threshold() -> float:
    return _env.env_float("HEAT_TPU_SPGEMM_DENSE_DENSITY")


def _spgemm(a: DCSX_matrix, b: DCSX_matrix):
    """sparse @ sparse -> sparse of a's format.  The output-sparse triplet
    ring is the default route; when the estimated output density
    ``1 - exp(-nnz_A nnz_B / (m k n))`` reaches
    ``HEAT_TPU_SPGEMM_DENSE_DENSITY`` (default 0.5) the dense route is
    taken.  A column-compressed product runs the row-compressed ring on the
    metadata transposes, ``A @ B = (B^T @ A^T)^T``; no operand is densified
    on the ring route."""
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"shape mismatch for matmul: {a.shape} @ {b.shape}")
    m, k = (int(s) for s in a.shape)
    n = int(b.shape[1])
    cells = float(m) * float(k) * float(n)
    lam = (float(a.gnnz) * float(b.gnnz) / cells) if cells else 0.0
    if 1.0 - math.exp(-lam) >= _dense_density_threshold():
        return _spgemm_dense(a, b)
    from .manipulations import to_sparse_csr

    if a._compressed_axis == 1:
        bt = b.T
        if bt._compressed_axis == 1:
            bt = to_sparse_csr(bt)
        return _spgemm_csr(bt, a.T).T
    return _spgemm_csr(a, b if b._compressed_axis == 0 else to_sparse_csr(b))


def _spgemm_csr(a: DCSR_matrix, b: DCSR_matrix) -> DCSR_matrix:
    """The row-compressed output-sparse ring product (both operands CSR)."""
    if b.split != a.split:
        b = _align_split(b, a.split)
    m, n = int(a.shape[0]), int(b.shape[1])
    res_type = types.promote_types(a.dtype, b.dtype)
    comp, other, val, lnnz, capacity = _pl.spgemm_planes(
        a._planes, a._n, b._planes, b._lnnz_host, b._comp_pad, a._comp_pad, n, res_type.torch_type(), a._dist,
        a.comm)
    return DCSR_matrix((comp, other, val), lnnz, capacity, a._comp_pad, (m, n), res_type, a.split, a.device, a.comm)


def _spgemm_dense(a: DCSX_matrix, b: DCSX_matrix):
    """The dense route for dense-regime outputs: B densified in its own
    chunks, the product by the sparse @ dense routes, the dense result
    packed again in a's format."""
    from .manipulations import to_sparse_csc, to_sparse_csr

    dense = _sp_dense(a, b.todense())
    if isinstance(a, DCSR_matrix):
        return to_sparse_csr(dense)
    return to_sparse_csc(dense.resplit(1) if a._dist else dense)
