"""Statistical operations (counterpart of heat_tpu/core/statistics.py).

Nothing here gathers split data.  Reductions over the split axis are a
local partial plus one all-reduce; ``var``, ``std``, ``skew`` and
``kurtosis`` take the reference's passes (the mean by one all-reduce, then
the central moment by another); an arg-reduction across the split axis has
each rank take its own (value, global index) and one all-gather of those
pairs pick the winner (the smallest index on ties, the first NaN first);
``cov`` is a local centred product plus one all-reduce; ``bincount`` and the
histograms count locally between one all-reduce of the range and one of
the counts.  Weighted counts add in a fixed order (a sort and an ordered
scan): the card's atomic float adds would round differently from run to
run.
"""

from __future__ import annotations

import builtins

import numpy as np
import torch

from ..parallel.comm import _as_bytes, _from_bytes
from . import _operations, arithmetics, types
from .arithmetics import _CUMSUM, _to_inexact
from .dndarray import DNDarray, _pad_along
from .linalg.basics import full_f32_matmul
from .stride_tricks import sanitize_axis

__all__ = [
    "argmax",
    "argmin",
    "average",
    "bincount",
    "bucketize",
    "cov",
    "digitize",
    "histc",
    "histogram",
    "kurtosis",
    "max",
    "maximum",
    "mean",
    "median",
    "min",
    "minimum",
    "percentile",
    "skew",
    "std",
    "var",
]


# ----------------------------------------------------------------------
# arg-reductions: local (value, global index), one all-gather of the pairs
# ----------------------------------------------------------------------
def _beats(v, i, nan, best_v, best_i, best_nan, largest: bool):
    """Where the candidate (v, i) beats the best so far: a NaN beats any
    number, the earlier of two NaNs wins, else the smaller (larger) value,
    and on ties the smaller index."""
    better = v > best_v if largest else v < best_v
    number = ~nan & ~best_nan & (better | ((v == best_v) & (i < best_i)))
    return (nan & ~best_nan) | (nan & best_nan & (i < best_i)) | number


def _pick(values, index, valid, comm, largest: bool):
    """The winning global index over the ranks' candidates (``values``,
    ``index``, ``valid`` of one shape on every rank): one all-gather of
    each rank's bytes, then the same pick on every rank."""
    if comm.size == 1:
        return index
    packed = torch.cat([_as_bytes(values), _as_bytes(index), _as_bytes(valid)], dim=-1).unsqueeze(0)
    got = comm.all_gather(packed.contiguous(), axis=0)
    nv, ni = values.element_size(), index.element_size()
    cand = [(_from_bytes(g[..., :nv].clone(), values.dtype), _from_bytes(g[..., nv:nv + ni].clone(), index.dtype),
             _from_bytes(g[..., nv + ni:].clone(), valid.dtype)) for g in got.unbind(0)]
    best_v, best_i, best_ok = cand[0]
    best_nan = torch.isnan(best_v) if best_v.is_floating_point() else torch.zeros_like(best_ok)
    for v, i, ok in cand[1:]:
        nan = torch.isnan(v) if v.is_floating_point() else torch.zeros_like(ok)
        take = ok & (~best_ok | _beats(v, i, nan, best_v, best_i, best_nan, largest))
        best_v, best_i = torch.where(take, v, best_v), torch.where(take, i, best_i)
        best_nan, best_ok = torch.where(take, nan, best_nan), best_ok | ok
    return best_i


def _arg(x: DNDarray, axis, keepdims: bool, largest: bool) -> DNDarray:
    """The index of the largest (smallest) value along ``axis``, or of the
    flattened array when None: the first on ties, the first NaN where
    there is one.  Int64, as the reference's."""
    if not isinstance(x, DNDarray):
        raise TypeError(f"expected x to be a DNDarray, but was {type(x)}")
    if x.dtype in types._WIDENED:
        x = _order_keys(x)
    _operations._refuse_complex("argmax" if largest else "argmin", TypeError, x)
    axis = sanitize_axis(x.shape, axis)
    if isinstance(axis, tuple):
        raise TypeError(f"{'argmax' if largest else 'argmin'} takes one axis or None")
    pick = torch.argmax if largest else torch.argmin
    split, comm = x.split, x.comm

    def counted(t):  # torch has no bool argmax: 0 and 1
        return t.to(torch.uint8) if t.dtype == torch.bool else t

    if axis is not None and axis != split:
        local = pick(counted(x.larray_padded), dim=axis, keepdim=keepdims)
        gshape = _operations._reduced_shape(x.gshape, (axis,), keepdims)
        return x._like(local, gshape, _operations._reduced_split(split, (axis,), keepdims))
    # the padding can never win: the neutral value, after every true row
    masked = counted(x.larray_padded if split is None else x._masked(_min_neutral(x) if largest else _max_neutral(x)))
    valid = torch.tensor(x.larray.numel() > 0, device=masked.device)
    if axis is None:
        flat = masked.reshape(-1)
        if flat.numel() == 0:
            raise ValueError("attempt to get argmax/argmin of an empty sequence")
        i = pick(flat)
        value = flat[i]
        if split is not None:
            coords = list(np.unravel_index(int(i), tuple(masked.shape)))
            coords[split] += comm.chunk(x.shape, split)[0]
            i = torch.tensor(int(np.ravel_multi_index(tuple(coords), x.gshape)), device=masked.device)
        best = _pick(value.reshape(1), i.reshape(1).to(torch.int64), valid.reshape(1), comm, largest)[0]
        shape = (1,) * x.ndim if keepdims else ()
        return x._like(best.reshape(shape), shape, None)
    # across the split axis
    local = pick(masked, dim=axis, keepdim=True)
    value = torch.gather(masked, axis, local)
    local = local + comm.chunk(x.shape, split)[0]
    best = _pick(value.contiguous(), local.contiguous(), valid.expand(local.shape).contiguous(), comm, largest)
    if not keepdims:
        best = best.squeeze(axis)
    return x._like(best, _operations._reduced_shape(x.gshape, (axis,), keepdims), None)


def _to_out(res: DNDarray, out):
    return res if out is None else _operations.store_out(res, out)


def argmax(x, axis=None, out=None, keepdims: bool = False, **kwargs) -> DNDarray:
    """The index of the maximum along ``axis`` (of the flattened array when
    None); the first on ties, the first NaN where there is one.  Across the
    split axis each rank offers its own winner and one all-gather of the
    (value, index) pairs decides."""
    return _to_out(_arg(x, axis, keepdims, True), out)


def argmin(x, axis=None, out=None, keepdims: bool = False, **kwargs) -> DNDarray:
    """The index of the minimum along ``axis``, as :func:`argmax` picks."""
    return _to_out(_arg(x, axis, keepdims, False), out)


# ----------------------------------------------------------------------
# min, max, mean and the element-wise extremes
# ----------------------------------------------------------------------
def _min_neutral(x: DNDarray):
    if types.heat_type_is_exact(x.dtype):
        return types.iinfo(x.dtype).min if x.dtype is not types.bool else False
    return -float("inf")


def _max_neutral(x: DNDarray):
    if types.heat_type_is_exact(x.dtype):
        return types.iinfo(x.dtype).max if x.dtype is not types.bool else True
    return float("inf")


def _lex_extreme(t: torch.Tensor, dims, keep: bool, largest: bool) -> torch.Tensor:
    """The largest (smallest) complex value over ``dims`` in lexicographic
    order: the extreme real part, then among its ties the extreme imaginary
    part."""
    pick = torch.amax if largest else torch.amin
    re = pick(t.real, dim=dims, keepdim=True)
    beyond = -float("inf") if largest else float("inf")
    im = pick(torch.where(t.real == re, t.imag, beyond), dim=dims, keepdim=True)
    out = torch.complex(re, im)
    return out if keep else out.squeeze(dims)


def _amin(t, dims, keep):
    if t.is_complex():
        return _lex_extreme(t, dims, keep, False)
    return torch.amin(t, dim=dims, keepdim=keep)


def _amax(t, dims, keep):
    if t.is_complex():
        return _lex_extreme(t, dims, keep, True)
    return torch.amax(t, dim=dims, keepdim=keep)


def _across_ranks(x: DNDarray, largest: bool):
    """The all-reduce of a max (min) over the ranks; complex partials, which
    no backend orders, are gathered and compared lexicographically."""
    comm = x.comm
    if not types.heat_type_is_complexfloating(x.dtype):
        return comm.pmax if largest else comm.pmin

    def reduce(local: torch.Tensor) -> torch.Tensor:
        parts = _from_bytes(comm.all_gather(_as_bytes(local[None]), axis=0), local.dtype)
        return _lex_extreme(parts, (0,), False, largest)

    return reduce


def _order_keys(x: DNDarray) -> DNDarray:
    """A uint16, uint32 or uint64 array as the signed array of its holding
    dtype whose values order as ``x``'s do (``types._order_key``)."""
    data = x.larray_padded
    return x._like(types._order_key(data, x.dtype), dtype=types.canonical_heat_type(data.dtype))


def _extreme(x, axis, keepdims: bool, out, largest: bool) -> DNDarray:
    if isinstance(x, DNDarray) and x.dtype in types._WIDENED:
        r = _extreme(_order_keys(x), axis, keepdims, None, largest)
        return _to_out(r._like(types._order_key(r.larray_padded, x.dtype), dtype=x.dtype), out)
    if largest:
        return _operations.__reduce_op(x, _amax, _across_ranks(x, True), _min_neutral(x), axis, keepdims, out)
    return _operations.__reduce_op(x, _amin, _across_ranks(x, False), _max_neutral(x), axis, keepdims, out)


def min(x, axis=None, out=None, keepdims: bool = False) -> DNDarray:
    """Minimum over ``axis`` (all axes when None); complex values in
    lexicographic order."""
    return _extreme(x, axis, keepdims, out, False)


def max(x, axis=None, out=None, keepdims: bool = False) -> DNDarray:
    """Maximum over ``axis`` (all axes when None); complex values in
    lexicographic order."""
    return _extreme(x, axis, keepdims, out, True)


def _ordered_pick(op):
    """The element-wise maximum (minimum) of holding tensors, in the order
    of their type's values."""
    return lambda a, b, t: types._order_key(op(types._order_key(a, t), types._order_key(b, t)), t)


def _maximum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if a.is_complex() or b.is_complex():
        return torch.where(_operations._lex_greater(a, b), a, b)
    return torch.maximum(a, b)


def _minimum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if a.is_complex() or b.is_complex():
        return torch.where(_operations._lex_greater(b, a), a, b)
    return torch.minimum(a, b)


def maximum(x1, x2, out=None) -> DNDarray:
    """The element-wise maximum (NaN where either is NaN; complex values in
    lexicographic order)."""
    return _operations.__binary_op(_maximum, x1, x2, out, widened=_ordered_pick(torch.maximum))


def minimum(x1, x2, out=None) -> DNDarray:
    """The element-wise minimum (NaN where either is NaN; complex values in
    lexicographic order)."""
    return _operations.__binary_op(_minimum, x1, x2, out, widened=_ordered_pick(torch.minimum))


def _axis_count(x: DNDarray, axis) -> float:
    """The number of elements each reduction over ``axis`` takes."""
    _, axes = _operations._axes(x, axis)
    n = 1.0
    for a in axes:
        n *= x.shape[a]
    return n


def mean(x, axis=None, keepdims: bool = False) -> DNDarray:
    """Arithmetic mean: the masked sum over the TRUE element count."""
    if not types.heat_type_is_inexact(x.dtype):
        x = x.astype(types.float32)
    return arithmetics.sum(x, axis=axis, keepdims=keepdims) / _axis_count(x, axis)


def average(x, axis=None, weights=None, returned: bool = False):
    """The (weighted) average over ``axis``; with ``returned`` also the sum
    of the weights (the element count without weights)."""
    from . import factories

    if weights is None:
        result = mean(x, axis)
        if returned:
            cnt = int(_axis_count(x, axis))
            return result, factories.full(result.shape, cnt, dtype=types.float32, split=result.split,
                                          device=x.device, comm=x.comm)
        return result
    if not isinstance(weights, DNDarray):
        weights = factories.array(weights, device=x.device, comm=x.comm)
    if axis is None:
        if weights.shape != x.shape:
            raise TypeError("Axis must be specified when shapes of x and weights differ.")
        wsum = arithmetics.sum(weights)
        result = arithmetics.sum(arithmetics.mul(x, weights)) / wsum
    else:
        axis = sanitize_axis(x.shape, axis)
        if weights.ndim == 1 and weights.shape[0] == x.shape[axis]:
            shape = [1] * x.ndim
            shape[axis] = weights.shape[0]
            weights = DNDarray.from_dense(weights._dense().reshape(shape), None, x.device, x.comm, weights.dtype)
        wsum = arithmetics.sum(weights, axis=axis)
        result = arithmetics.sum(arithmetics.mul(x, weights), axis=axis) / wsum
    if returned:
        if wsum.shape != result.shape:
            # broadcast as the reference's broadcast_to: a whole sum stays whole
            if wsum.split is None:
                local = torch.broadcast_to(wsum.larray_padded, result.shape).clone()
                wsum = result._like(local, result.shape, None, wsum.dtype)
            else:
                local = _operations._aligned(wsum, result.shape, result.split)
                wsum = result._like(torch.broadcast_to(local, result.larray_padded.shape).clone(), dtype=wsum.dtype)
        return result, wsum
    return result


# ----------------------------------------------------------------------
# moments: the reference's passes, each one all-reduce
# ----------------------------------------------------------------------
def _moment_input(x: DNDarray) -> DNDarray:
    if not isinstance(x, DNDarray):
        raise TypeError(f"expected x to be a DNDarray, but was {type(x)}")
    return x if types.heat_type_is_inexact(x.dtype) else x.astype(types.float32)


def _centred_sum(x: DNDarray, axis, keepdims: bool, power: int) -> DNDarray:
    """The sum over ``axis`` of ``|x - mean|**power`` (the mean by one
    all-reduce, this sum by another where the split axis is reduced)."""
    axis, axes = _operations._axes(x, axis)
    mu = arithmetics.sum(x, axis=axis, keepdims=True) / _axis_count(x, axis)
    centred = x.larray_padded - _operations._aligned(mu, x.shape, x.split)
    if centred.is_complex() and power == 2:
        dev = (centred * centred.conj()).real
    else:
        dev = centred * centred if power == 2 else centred ** power
    d = x._like(dev)
    return arithmetics.sum(d, axis=axis, keepdims=keepdims)


def var(x, axis=None, ddof: int = 0, keepdims: bool = False, **kwargs) -> DNDarray:
    """The variance over ``axis``: the mean, then the sum of the squared
    deviations over ``n - ddof`` (two passes, one all-reduce each where the
    split axis is reduced)."""
    if kwargs:
        raise TypeError(f"var() got unexpected keyword arguments {sorted(kwargs)}")
    if not isinstance(ddof, int):
        raise ValueError(f"ddof must be integer, is {type(ddof)}")
    if ddof < 0:
        raise ValueError(f"Expected ddof >= 0, got {ddof}")
    x = _moment_input(x)
    return _centred_sum(x, axis, keepdims, 2) / (_axis_count(x, axis) - ddof)


def std(x, axis=None, ddof: int = 0, keepdims: bool = False, **kwargs) -> DNDarray:
    """The standard deviation: the square root of :func:`var`."""
    from . import exponential

    return exponential.sqrt(var(x, axis, ddof=ddof, keepdims=keepdims, **kwargs))


def _central_moment(x: DNDarray, p: int, axis) -> DNDarray:
    return _centred_sum(x, axis, False, p) / _axis_count(x, axis)


def skew(x, axis=None, unbiased: bool = True) -> DNDarray:
    """The skewness: the third central moment over the variance ** 1.5,
    with the unbiased correction by default."""
    x = _moment_input(x)
    m3 = _central_moment(x, 3, axis)
    v = var(x, axis, ddof=0)
    g1 = m3._like(m3.larray_padded / v.larray_padded ** 1.5)
    if unbiased:
        # the reference's correction is a numpy float64: the result widens
        # to float64 (complex128)
        n = _axis_count(x, axis)
        wide = torch.complex128 if g1.larray_padded.is_complex() else torch.float64
        g1 = g1._like(g1.larray_padded.to(wide) * float(np.sqrt(n * (n - 1))) / (n - 2))
    return g1


def kurtosis(x, axis=None, unbiased: bool = True, Fisher: bool = True) -> DNDarray:
    """The kurtosis: the fourth central moment over the squared variance,
    with the unbiased correction and Fisher's -3 by default."""
    x = _moment_input(x)
    m4 = _central_moment(x, 4, axis)
    v = var(x, axis, ddof=0)
    g2 = m4 / (v * v)
    if unbiased:
        n = _axis_count(x, axis)
        k = ((n - 1) / ((n - 2) * (n - 3))) * ((n + 1) * g2.larray_padded - 3 * (n - 1)) + 3
        g2 = g2._like(k)
    if Fisher:
        g2 = g2 - 3.0
    return g2


_METHODS = ("linear", "lower", "higher", "midpoint", "nearest")


def _percentile_sorted_1d(x: DNDarray, q, interpolation: str):
    """The reference's sorted route for a large 1-D split array: the sample
    sort, then the 2 len(q) order statistics by one small all-gather
    (:func:`sample_sort.select_global_ranks`), integers in float64, numpy's
    interpolation and NaN propagation.  None where the gate declines."""
    from .sample_sort import sample_sort_1d, select_global_ranks, supports_sample_sort

    xf = x if types.heat_type_is_inexact(x.dtype) else x.astype(types.float64)
    if not supports_sample_sort(xf, 0, False):
        return None
    v, _ = sample_sort_1d(xf)
    n = x.shape[0]
    q_np = np.atleast_1d(np.asarray(q, np.float64))
    pos = q_np / 100.0 * (n - 1)
    lo = np.floor(pos).astype(np.int64)
    hi = np.ceil(pos).astype(np.int64)
    sel = select_global_ranks(v, np.concatenate([lo, hi]))
    has_nan = x.comm.psum(torch.isnan(xf._masked(0.0)).any().to(torch.int64).reshape(1)) > 0
    lo_v = torch.where(has_nan, torch.nan, sel[: len(q_np)])
    hi_v = torch.where(has_nan, torch.nan, sel[len(q_np):])
    frac = torch.as_tensor(pos - lo, dtype=sel.dtype, device=sel.device)
    if interpolation == "linear":
        res = lo_v + frac * (hi_v - lo_v)
    elif interpolation == "lower":
        res = lo_v
    elif interpolation == "higher":
        res = hi_v
    elif interpolation == "midpoint":
        res = 0.5 * (lo_v + hi_v)
    elif interpolation == "nearest":
        near = np.rint(pos).astype(np.int64)
        res = torch.where(torch.as_tensor(near == lo, device=sel.device), lo_v, hi_v)
    else:
        raise ValueError(f"unknown interpolation {interpolation!r}")
    if np.ndim(q) == 0:
        res = res[0]
    return DNDarray(res, tuple(res.shape), xf.dtype, None, x.device, x.comm)


def _interpolate(low: torch.Tensor, high: torch.Tensor, hw: torch.Tensor, method: str) -> torch.Tensor:
    """``jnp.quantile``'s result from the low and high order statistics (q
    along dim 0) and the high weights ``hw`` (float64, one per q): "linear"
    in float64, "nearest" low where ``hw <= 0.5``, all in the values'
    type."""
    w = hw.reshape((-1,) + (1,) * (low.ndim - 1))
    if method == "linear":
        res = low.to(torch.float64) * (1.0 - w) + high.to(torch.float64) * w
    elif method == "lower":
        res = low
    elif method == "higher":
        res = high
    elif method == "nearest":
        res = torch.where(w <= 0.5, low, high)
    else:
        res = (low + high) * 0.5
    return res.to(low.dtype)


def _ranks(q: torch.Tensor, n: int):
    """``(low, high, high weight)`` positions of the quantiles ``q`` (float64
    fractions) among n sorted values, jnp.quantile's."""
    qq = q * (n - 1)
    low, high = torch.floor(qq), torch.ceil(qq)
    hw = qq - low
    return low.clamp(0, n - 1).to(torch.int64), high.clamp(0, n - 1).to(torch.int64), hw


_QUANTILE_BLOCK = 1 << 27  # elements a local quantile sorts at a time


def _quantile_local(t: torch.Tensor, q: torch.Tensor, axes, method: str) -> torch.Tensor:
    """``jnp.quantile`` of a whole tensor over ``axes`` (a tuple; None: all),
    q along the result's first dim: a reduction with a NaN gives NaN.  The
    reduced values of each kept position are a column, sorted a block of
    columns at a time (at most ``_QUANTILE_BLOCK`` elements)."""
    if axes is None:
        t = t.reshape(-1, 1)
    else:
        keep = [d for d in range(t.ndim) if d not in axes]
        t = t.permute(list(axes) + keep).reshape((-1,) + tuple(t.shape[d] for d in keep))
    n = t.shape[0]
    flat = t.reshape(n, -1)
    low, high, hw = _ranks(q, n)
    step = builtins.max(1, _QUANTILE_BLOCK // builtins.max(n, 1))
    lows, highs = [], []
    for c0 in range(0, flat.shape[1], step):
        block = flat[:, c0:c0 + step]
        s = torch.sort(block, dim=0).values  # NaN last
        lo, hi = s[low], s[high]
        if block.is_floating_point():
            nan = torch.isnan(block).any(0)
            lo, hi = torch.where(nan, torch.nan, lo), torch.where(nan, torch.nan, hi)
        lows.append(lo)
        highs.append(hi)
    if not lows:
        empty = flat.new_zeros((q.numel(), 0))
        lows, highs = [empty], [empty]
    res = _interpolate(torch.cat(lows, 1), torch.cat(highs, 1), hw, method)
    return res.reshape((q.numel(),) + tuple(t.shape[1:]))


def _quantile_split_axis(x: DNDarray, q: torch.Tensor, axis: int, method: str) -> torch.Tensor:
    """``jnp.quantile`` over the split axis without a gather: the columns
    sorted by the sample sort (a stable argsort's order), then each rank
    offers the order statistics it owns and one all-gather of 2 len(q)
    values a column lets every rank pick them."""
    from .sample_sort import _select_rows, _sorted_along

    s, _ = _sorted_along(x, axis, False, merge_zeros=True)
    low, high, hw = _ranks(q, x.shape[axis])
    chunk = s.larray_padded.movedim(axis, 0)
    sel = _select_rows(x.comm, chunk, torch.cat([low, high]))
    nan = x.comm.psum(torch.isnan(x._masked(0)).any(axis).to(torch.int64)) > 0
    sel = torch.where(nan, torch.nan, sel)
    return _interpolate(sel[: q.numel()], sel[q.numel():], hw, method)


def _quantile(x: DNDarray, q, axis, method: str, keepdims: bool) -> DNDarray:
    """The dense route (``jnp.percentile``'s values), without a gather: an
    array split along a reduced axis is sorted by the sample sort (one
    reduced axis) or flattened first (all axes), or resplit along an axis it
    keeps; a reduction that keeps the split axis runs on each rank's rows,
    and its result is put together on every rank."""
    if method not in _METHODS:
        raise ValueError("method can only be 'linear', 'lower', 'higher', 'midpoint', or 'nearest'")
    if types.heat_type_is_complexfloating(x.dtype):
        raise ValueError("quantile does not support complex input, as the operation is poorly defined.")
    if not types.heat_type_is_inexact(x.dtype):
        x = x.astype(types.float32)
    q_np = np.asarray(q, np.float64)
    qt = torch.as_tensor(q_np.reshape(-1) / 100.0, dtype=torch.float64, device=x.larray_padded.device)
    axes = None if axis is None else (axis if isinstance(axis, tuple) else (axis,))
    shape = list(x.shape)
    kept = [d for d in range(x.ndim) if axes is not None and d not in axes]
    out_shape = [1 if (axes is None or d in axes) else shape[d] for d in range(x.ndim)] if keepdims else \
        [shape[d] for d in kept]
    split, comm = x.split, x.comm
    if split is None or comm.size == 1 or (axes is not None and split not in axes):
        res = _quantile_local(x.larray, qt, axes, method)
        if split is not None and comm.size > 1:
            at = 1 + kept.index(split)  # the split axis's place in (q, kept...)
            res = _pad_along(res, at, comm.padded_extent(shape[split]) // comm.size)
            res = DNDarray(res.contiguous(), (qt.numel(),) + tuple(shape[d] for d in kept), x.dtype, at, x.device,
                           comm)._dense()
    elif axes is None or len(axes) == x.ndim:
        from .manipulations import flatten

        res = _quantile_split_axis(flatten(x), qt, 0, method)
    elif len(axes) == 1:
        res = _quantile_split_axis(x, qt, split, method)
    else:
        return _quantile(x.resplit(kept[0]), q, axis, method, keepdims)
    res = res.reshape(tuple(q_np.shape) + tuple(out_shape))
    return DNDarray(res.contiguous(), tuple(res.shape), x.dtype, None, x.device, comm)


def percentile(x, q, axis=None, out=None, interpolation: str = "linear", keepdims: bool = False,
               sketched: bool = False, sketch_size=None) -> DNDarray:
    """The q-th percentiles along ``axis``, on every rank.

    A large 1-D split array takes the reference's sorted route (the sample
    sort and a selection of ranks, numpy's values); every other call gives
    ``jnp.percentile``'s values, with no gather of the array
    (:func:`_quantile`).  ``sketched=True`` first draws ``sketch_size``
    samples along the axis (the reference's draw, ``random.randint``)."""
    q_chk = np.asarray(q, dtype=np.float64)
    if not np.all((q_chk >= 0.0) & (q_chk <= 100.0)):
        raise ValueError("Percentiles must be in the range [0, 100]")
    axis_s = sanitize_axis(x.shape, axis)
    if not sketched and out is None and x.ndim == 1 and axis_s in (None, 0):
        res = _percentile_sorted_1d(x, q, interpolation)
        if res is not None:
            if keepdims:
                t = res.larray_padded
                res = res._like(t.reshape(tuple(t.shape) + (1,) if t.ndim else (1,)), split=None,
                                gshape=tuple(t.shape) + (1,) if t.ndim else (1,))
            return res
    if sketched:
        from . import random as ht_random
        from .manipulations import flatten

        n = x.size if axis_s is None else x.shape[axis_s]
        size = builtins.min(sketch_size or builtins.max(int(np.sqrt(n)) * 32, 1024), n)
        if size < n:
            xf = x if types.heat_type_is_inexact(x.dtype) else x.astype(types.float32)
            idx = ht_random.randint(0, n, size=(size,), comm=x.comm, device=x.device)._dense()
            x = flatten(xf)[idx] if axis_s is None else xf[(slice(None),) * axis_s + (idx,)]
    return _to_out(_quantile(x, q, axis_s, interpolation, keepdims), out)


def median(x, axis=None, keepdims: bool = False) -> DNDarray:
    """The median: the 50th percentile (a large 1-D split array rides the
    sample sort, as the reference's does)."""
    return percentile(x, 50.0, axis=axis, keepdims=keepdims)


# ----------------------------------------------------------------------
# covariance
# ----------------------------------------------------------------------
def _observations(a: DNDarray, rowvar: bool):
    """``(local, n, split)``: this rank's observations of ``a`` as an
    observations by variables tensor (a 1-D ``a`` is one variable), its
    padding zeroed, the number of observations, and whether they are split
    over the ranks (an array split along its variables is resplit along
    its observations: one all-to-all)."""
    if a.ndim == 1:
        local = a._masked(0) if a.split is not None else a.larray_padded
        return local.reshape(-1, 1), a.shape[0], a.split is not None
    obs = 1 if rowvar or a.shape[0] == 1 else 0
    if a.split is not None and a.split != obs:
        a = a.resplit(obs)
    local = a._masked(0) if a.split is not None else a.larray_padded
    return (local if obs == 0 else local.T), a.shape[obs], a.split is not None


def _own_rows(obs: torch.Tensor, comm) -> torch.Tensor:
    """This rank's rows of whole observations, cut and zero-padded as a
    chunk of the canonical layout."""
    lo, lshape, _ = comm.chunk(tuple(obs.shape), 0)
    return _pad_along(obs.narrow(0, lo, lshape[0]), 0, comm.padded_extent(obs.shape[0]) // comm.size)


_GRAM_BLOCK = 1 << 16  # observations a partial product of cov takes


def _gram(c: torch.Tensor) -> torch.Tensor:
    """``c^T conj(c)`` of observations by variables ``c`` (contiguous), in
    full float32: over many observations one product of each block of 2^16
    rows, then the blocks' products added by one reduction, so that no
    accumulation runs over all of them (one product over 2^27 observations
    of 16 variables lost 7e-5 of the largest entry on an NVIDIA H100 80GB
    HBM3 at 700 W)."""
    n, p = c.shape
    with full_f32_matmul():
        if n <= _GRAM_BLOCK:
            return c.T @ c.conj()
        nb = -(-n // _GRAM_BLOCK)
        if nb * _GRAM_BLOCK != n:
            c = torch.nn.functional.pad(c, (0, 0, 0, nb * _GRAM_BLOCK - n))
        blocks = c.view(nb, _GRAM_BLOCK, p)
        return torch.bmm(blocks.transpose(1, 2), blocks.conj()).sum(0)


def cov(m, y=None, rowvar: bool = True, bias: bool = False, ddof=None) -> DNDarray:
    """The covariance matrix of the variables (rows where ``rowvar``):
    each rank centres its own observations by the means (one all-reduce)
    and multiplies them; one all-reduce adds the products."""
    if not isinstance(m, DNDarray):
        raise TypeError(f"m must be a DNDarray, got {type(m)}")
    if m.ndim > 2:
        raise ValueError("m has more than 2 dimensions")
    if ddof is not None and not isinstance(ddof, int):
        raise TypeError("ddof must be integer")
    comm = m.comm
    xs, n, split = _observations(m, rowvar)
    parts, kinds = [xs], [m.dtype]
    common = m.dtype
    if y is not None:
        if not isinstance(y, DNDarray):
            from . import factories

            y = factories.array(y, device=m.device, comm=comm)
        ys, ny, ysplit = _observations(y, rowvar)
        if ny != n:
            raise ValueError(f"m and y have {n} and {ny} observations")
        if ysplit != split:
            # the one whose observations are whole gives each rank its own
            # rows of them (no communication)
            if split:
                ys = _own_rows(ys, comm)
            else:
                xs = parts[0] = _own_rows(xs, comm)
                split = True
        parts.append(ys)
        kinds.append(y.dtype)
        common = types.promote_types(m.dtype, y.dtype)
    dt = common if types.heat_type_is_inexact(common) else (
        types.float64 if common in (types.int64, types.uint64) else types.float32)
    parts = [types._cast(p, k, dt) for p, k in zip(parts, kinds)]
    x = torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]
    if ddof is None:
        ddof = 1 if not bias else 0
    sums = x.sum(0, keepdim=True)
    if split:
        sums = comm.psum(sums.contiguous())
    centred = (x - sums / n).contiguous()
    if split:
        lo, lshape, _ = comm.chunk((n,), 0)
        centred[lshape[0]:] = 0  # the padding's deviations add nothing
    prod = _gram(centred)
    if split:
        prod = comm.psum(prod.contiguous())
    res = (prod / (n - ddof)).squeeze()
    out_split = 0 if m.split is not None and res.ndim > 0 else None
    return DNDarray.from_dense(res, out_split, m.device, comm)


# ----------------------------------------------------------------------
# counting: local counts, one all-reduce
# ----------------------------------------------------------------------
def _weighted_counts(idx: torch.Tensor, w: torch.Tensor, length: int) -> torch.Tensor:
    """The sum of ``w`` per index in [0, length), in a fixed order: the
    weights sorted by index (stably), one prefix sum (float64 for floats,
    int64 for integers; on the card the fixed-order blocked scan of
    :func:`arithmetics._blocked_scan`), and differences at the index
    boundaries.  No atomic adds."""
    acc = torch.float64 if (w.is_floating_point() or w.is_complex()) else torch.int64
    if w.is_complex():
        acc = torch.complex128
    order = torch.argsort(idx, stable=True)
    pre = _CUMSUM(w[order].to(acc), 0) if w.numel() else w.new_zeros(0, dtype=acc)
    counts = torch.bincount(idx, minlength=length)[:length]
    ends = torch.cumsum(counts, 0)
    total = torch.cat([pre.new_zeros(1), pre])
    return total[ends] - total[ends - counts]


def bincount(x, weights=None, minlength: int = 0) -> DNDarray:
    """The number of occurrences of each value in [0, max(x)] (negative
    values counted as 0, as JAX's ``bincount`` clips them), or the sum of
    their ``weights``; at least ``minlength`` bins.  One all-reduce of the
    local maximum, local counts, one all-reduce of the counts."""
    if not isinstance(x, DNDarray):
        raise TypeError(f"expected x to be a DNDarray, but was {type(x)}")
    if x.ndim != 1:
        raise ValueError("bincount requires a 1-D input")
    comm = x.comm
    local = x.larray.to(torch.int64).clamp(min=0)
    top = local.max().reshape(1) if local.numel() else torch.full((1,), -1, dtype=torch.int64, device=local.device)
    if x.split is not None:
        top = comm.pmax(top.contiguous())
    length = builtins.max(int(top[0]) + 1, minlength) if x.size else minlength
    if weights is None:
        counts = torch.bincount(local, minlength=length)
    else:
        if not isinstance(weights, DNDarray):
            from . import factories

            weights = factories.array(weights, device=x.device, comm=comm)
        w = _operations._aligned(weights, x.shape, x.split)
        w = w.narrow(0, 0, local.shape[0]) if x.split is not None else w
        counts = types._cast(_weighted_counts(local, w, length), types.canonical_heat_type(
            torch.complex128 if w.is_complex() else torch.float64 if w.is_floating_point() else torch.int64),
            weights.dtype)
    if x.split is not None:
        counts = comm.psum(counts.contiguous())
    return DNDarray.from_dense(counts, x.split, x.device, comm)


def _global_range(a: DNDarray):
    """``(min, max)`` of the whole array as host floats: one all-reduce
    each (padding masked)."""
    lo = _operations.__reduce_op(a, _amin, a.comm.pmin, _max_neutral(a), None)
    hi = _operations.__reduce_op(a, _amax, a.comm.pmax, _min_neutral(a), None)
    return lo.larray_padded, hi.larray_padded


def _edges(lo: torch.Tensor, hi: torch.Tensor, bins: int, dt, device: torch.device) -> torch.Tensor:
    """JAX's bin edges: ``linspace(lo, hi, bins + 1)`` computed in ``dt``
    as XLA compiles it (``lo (1 - i r) + i (hi r)``, ``r = 1 / bins``, the
    last sum one fused multiply-add), the range widened by 0.5 on each
    side where it is empty.  On the reference's CPU build XLA evaluates
    edge 1 otherwise for 3 to 33 bins (up to two roundings apart), and
    longer runs of edges at 255 (float64) and 1000 bins; every other edge
    of 2 to 128 bins is bitwise the reference's (ROADMAP caveats)."""
    from .random import _fma32, _fma64

    lo, hi = lo.to(dt).cpu(), hi.to(dt).cpu()
    if bool(hi - lo == 0):
        lo, hi = lo - 0.5, hi + 0.5
    i = torch.arange(bins + 1, dtype=dt)
    r = torch.tensor(1.0, dtype=dt) / torch.tensor(float(bins), dtype=dt)
    fma = _fma32 if dt == torch.float32 else _fma64
    edges = fma(i, (hi * r).expand_as(i).contiguous(), lo * (1 - i * r))
    edges[-1] = hi
    return edges.to(device)


def _hist_counts(values: torch.Tensor, w, edges: torch.Tensor, a: DNDarray, split: bool) -> torch.Tensor:
    """Counts (or weight sums) of ``values`` in the bins between ``edges``,
    as JAX bins them: right-open bins, the last closed, values outside
    dropped; one all-reduce where the data are split."""
    nb = edges.numel() - 1
    v = values.reshape(-1).contiguous().to(edges.dtype)
    idx = torch.searchsorted(edges, v, right=True)
    idx = torch.where(v == edges[-1], torch.full_like(idx, nb), idx)
    if w is None:
        counts = torch.bincount(idx, minlength=nb + 2)[1:nb + 1].to(edges.dtype)
    else:
        counts = _weighted_counts(idx, w.reshape(-1), nb + 2)[1:nb + 1]
    if split:
        counts = a.comm.psum(counts.contiguous())
    return counts


def _inexact_widened(a: DNDarray) -> DNDarray:
    """uint16 and uint32 in float32, uint64 in float64 (each value rounded
    once), the types jnp bins them in; other types as they are."""
    if a.dtype not in types._WIDENED:
        return a
    return a.astype(types.float64 if a.dtype is types.uint64 else types.float32)


def histogram(a, bins=10, range=None, weights=None, density=None):
    """``(hist, bin_edges)`` as JAX's ``histogram``: ``bins`` equal bins
    over ``range`` (by default the data's, one all-reduce each for its ends)
    or the given edges; local counts, one all-reduce."""
    if not isinstance(a, DNDarray):
        raise TypeError(f"expected a to be a DNDarray, but was {type(a)}")
    a = _inexact_widened(a)
    dt = _to_inexact(torch.zeros((), dtype=a.larray_padded.dtype)).dtype
    if isinstance(bins, DNDarray) or np.ndim(bins) == 1:
        edges = bins._dense() if isinstance(bins, DNDarray) else torch.as_tensor(np.ascontiguousarray(bins))
        edges = edges.to(dt).to(a.larray_padded.device)  # in the data's inexact type, as JAX casts them
    else:
        if range is not None:
            lo, hi = torch.tensor(range[0], dtype=dt), torch.tensor(range[1], dtype=dt)
        elif a.size == 0:
            lo, hi = torch.tensor(0.0, dtype=dt), torch.tensor(1.0, dtype=dt)
        else:
            lo, hi = _global_range(a)
        edges = _edges(lo, hi, int(bins), dt, a.larray_padded.device)
    w = None
    if weights is not None:
        if not isinstance(weights, DNDarray):
            from . import factories

            weights = factories.array(weights, device=a.device, comm=a.comm)
        w = _operations._aligned(weights, a.shape, a.split)
        w = w.narrow(a.split, 0, a.lshape[a.split]) if a.split is not None else w
    counts = _hist_counts(a.larray, w, edges, a, a.split is not None)
    if w is not None:
        counts = types._cast(counts, types.canonical_heat_type(counts.dtype),
                             types.canonical_heat_type(torch.promote_types(w.dtype, edges.dtype)))
    if density:
        width = torch.diff(edges)
        counts = counts / (counts.sum() * width)
    return (DNDarray.from_dense(counts, None, a.device, a.comm),
            DNDarray.from_dense(edges, None, a.device, a.comm))


def histc(input, bins: int = 100, min: float = 0.0, max: float = 0.0, out=None) -> DNDarray:
    """Counts in ``bins`` equal bins over [min, max] (the data's range where
    both are 0), values outside ignored, in the input's type."""
    if not isinstance(input, DNDarray):
        raise TypeError(f"expected input to be a DNDarray, but was {type(input)}")
    kind, input = input.dtype, _inexact_widened(input)
    dt = _to_inexact(torch.zeros((), dtype=input.larray_padded.dtype)).dtype
    values = input.larray
    if min == 0.0 and max == 0.0:
        lo, hi = _global_range(input)
        lo, hi = torch.tensor(float(lo), dtype=dt), torch.tensor(float(hi), dtype=dt)
    else:
        lo, hi = torch.tensor(float(min), dtype=dt), torch.tensor(float(max), dtype=dt)
        keep = (values >= min) & (values <= max)
        values = values[keep]
    edges = _edges(lo, hi, int(bins), dt, input.larray_padded.device)
    counts = _hist_counts(values, None, edges, input, input.split is not None)
    res = DNDarray.from_dense(types._cast(counts, types.canonical_heat_type(counts.dtype), kind), None,
                              input.device, input.comm, kind)
    return _to_out(res, out)


def _sorted_search(bins: torch.Tensor, x: torch.Tensor, right: bool) -> torch.Tensor:
    return torch.searchsorted(bins.contiguous(), x.contiguous(), right=right)


def digitize(x, bins, right: bool = False) -> DNDarray:
    """The bin of each value, numpy's rule (increasing or decreasing
    ``bins``), int32 as the reference's; the bins whole on every rank."""
    if not isinstance(x, DNDarray):
        raise TypeError(f"expected x to be a DNDarray, but was {type(x)}")
    b = bins._dense() if isinstance(bins, DNDarray) else torch.as_tensor(np.ascontiguousarray(bins))
    data = x.larray_padded
    rt = torch.promote_types(data.dtype, b.dtype)
    b, data = b.to(rt).to(data.device), data.to(rt)
    if b.numel() == 0:
        return x._like(torch.zeros_like(data, dtype=torch.int32))._propagate_layout_from(x)
    side = not right
    inc = _sorted_search(b, data, side)
    dec = b.numel() - _sorted_search(b.flip(0), data, side)
    res = torch.where(b[-1] >= b[0], inc, dec).to(torch.int32)
    return x._like(res)._propagate_layout_from(x)


def bucketize(input, boundaries, out_int32: bool = False, right: bool = False, out=None) -> DNDarray:
    """The bucket of each value in the sorted ``boundaries`` (whole on every
    rank), as the reference's: ``right=False`` places a value equal to a
    boundary after it."""
    if not isinstance(input, DNDarray):
        raise TypeError(f"expected input to be a DNDarray, but was {type(input)}")
    b = boundaries._dense() if isinstance(boundaries, DNDarray) else torch.as_tensor(np.ascontiguousarray(boundaries))
    data = input.larray_padded
    rt = torch.promote_types(data.dtype, b.dtype)
    res = _sorted_search(b.to(rt).to(data.device), data.to(rt), not right)
    res = input._like(res.to(torch.int32 if out_int32 else torch.int64))._propagate_layout_from(input)
    return _to_out(res, out)
