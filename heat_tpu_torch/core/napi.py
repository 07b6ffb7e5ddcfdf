"""NumPy functions beyond heat's own surface (counterpart of
heat_tpu/core/napi.py).

The JAX package computes each of these with ``jnp`` on the dense global
view and wraps the result with a distribution-preserving split
(:func:`_auto_split`).  The port computes the same values, jnp's (not
numpy's, not torch's: ``nanargmax`` gives -1 on an all-NaN slice, the
quantiles interpolate in the input's type, ``partition`` is the array
``lax.top_k`` gives, the sorts are stable with NaN last), and keeps the
same split rule, whose answer depends on the world's size.

``amax``, ``amin``, ``ptp`` and ``count_nonzero`` reduce each rank's rows
and combine them with one collective (the ports of ``max``, ``min`` and
``sum``).  The predicates and the string functions read no data but the
scalar they print.  Every other function gathers the dense view, as the
reference's ``_dense()`` reads it; ``insert`` and ``trim_zeros`` also go
through numpy on the host.
"""

from __future__ import annotations

import builtins
import math
from typing import Optional

import numpy as np
import torch

from . import types
from .dndarray import DNDarray

__all__ = [
    "amax",
    "amin",
    "array2string",
    "array_repr",
    "array_str",
    "asanyarray",
    "asarray_chkfinite",
    "ascontiguousarray",
    "asfarray",
    "asfortranarray",
    "base_repr",
    "binary_repr",
    "block",
    "correlate",
    "diagflat",
    "einsum_path",
    "format_float_positional",
    "format_float_scientific",
    "packbits",
    "unpackbits",
    "append",
    "argpartition",
    "argsort",
    "argwhere",
    "array_equal",
    "array_equiv",
    "array_split",
    "atleast_1d",
    "atleast_2d",
    "atleast_3d",
    "copyto",
    "corrcoef",
    "count_nonzero",
    "delete",
    "dstack",
    "einsum",
    "extract",
    "flatnonzero",
    "fmax",
    "fmin",
    "histogram2d",
    "histogram_bin_edges",
    "histogramdd",
    "inner",
    "insert",
    "iscomplexobj",
    "isrealobj",
    "isscalar",
    "kron",
    "lexsort",
    "mgrid",
    "nanargmax",
    "nanargmin",
    "nanmax",
    "nanmean",
    "nanmedian",
    "nanmin",
    "nanpercentile",
    "nanquantile",
    "nanstd",
    "nanvar",
    "ogrid",
    "partition",
    "ptp",
    "quantile",
    "resize",
    "rollaxis",
    "searchsorted",
    "sort_complex",
    "tensordot",
    "tri",
    "trim_zeros",
    "vander",
    "asmatrix",
    "bmat",
    "broadcast",
    "from_dlpack",
    "isfortran",
    "isnat",
    "mat",
    "require",
]

_PYTHON_SCALARS = (builtins.bool, builtins.int, builtins.float, builtins.complex)


def _ref(*xs) -> Optional[DNDarray]:
    for x in xs:
        if isinstance(x, DNDarray):
            return x
    return None


def _pick(*xs):
    """First DNDarray among xs, else the first operand."""
    r = _ref(*xs)
    return r if r is not None else xs[0]


def _torch_device(*xs) -> torch.device:
    r = _ref(*xs)
    if r is not None:
        return r.larray_padded.device
    from .devices import sanitize_device

    return sanitize_device(None).torch_device


def _d(x, device: Optional[torch.device] = None):
    """Dense global view of a DNDarray (gathered where split) or a tensor
    of an array-like (numpy's types, as jnp.asarray takes them with x64
    on); python scalars stay python scalars (jnp's weak types)."""
    if isinstance(x, DNDarray):
        return _native(x._dense(), x.dtype)
    if isinstance(x, _PYTHON_SCALARS):
        return x
    if isinstance(x, torch.Tensor):
        return x if device is None else x.to(device)
    a = np.asarray(x)
    t = torch.from_numpy(np.array(a, copy=True).reshape(a.shape))
    return t if device is None else t.to(device)


_NATIVE = {types.uint16: torch.uint16, types.uint32: torch.uint32, types.uint64: torch.uint64}


def _native(t: torch.Tensor, kind) -> torch.Tensor:
    """A holding tensor of uint16, uint32 or uint64 in torch's own unsigned
    dtype, so that a function computes on the type's values (torch's
    kernels for these dtypes answer as numpy's).  Orderings, ``nonzero``
    and products, which torch's CPU kernels lack for these dtypes, go
    through :func:`_held` and :func:`_exact_keys`; other types as they are."""
    if kind is types.uint64:
        return t.view(torch.uint64)
    return t.to(_NATIVE[kind]) if kind in _NATIVE else t


def _held(t: torch.Tensor) -> torch.Tensor:
    """A tensor of torch's uint16, uint32 or uint64 as its type's holding
    tensor (the same values; uint64's bits in int64), where torch's kernels
    cover every type; other tensors as they are."""
    if t.dtype == torch.uint64:
        return t.view(torch.int64)
    return t.to(_HOLDING[t.dtype]) if t.dtype in _HOLDING else t


_HOLDING = {torch.uint16: torch.int32, torch.uint32: torch.int64}


def _unheld(t: torch.Tensor, like: torch.dtype) -> torch.Tensor:
    """The inverse of :func:`_held` for a result of dtype ``like``."""
    if like == torch.uint64:
        return t.view(torch.uint64)
    return t.to(like) if like in _HOLDING else t


def _exact_keys(t: torch.Tensor) -> torch.Tensor:
    """Bool and integer values (torch's unsigned types included) as int64
    keys in the order of the values."""
    from ._keys import sort_keys

    return sort_keys(t)[0]


def _as_tensor(x, dtype: Optional[torch.dtype] = None, device: Optional[torch.device] = None) -> torch.Tensor:
    """``x`` as a tensor: python scalars in ``dtype`` (their weak type's
    meeting with the other operands)."""
    if isinstance(x, _PYTHON_SCALARS):
        return torch.tensor(x, dtype=dtype, device=device) if dtype is not None else \
            torch.from_numpy(np.asarray(x)).to(device)
    x = _d(x, device)
    return x if dtype is None else x.to(dtype)


def _result_dtype(*xs) -> torch.dtype:
    """jnp's result type of the operands: arrays by the reference's lattice
    (``types.promote_types``), python scalars weakly (an int meets an array
    in its type, a float a non-float array in float64, a complex a real one
    in complex128, as under x64)."""
    strong = None
    for x in xs:
        if isinstance(x, _PYTHON_SCALARS):
            continue
        t = x.dtype if isinstance(x, DNDarray) else types.canonical_heat_type(_d(x).dtype)
        strong = t if strong is None else types.promote_types(strong, t)
    for x in xs:
        if isinstance(x, builtins.bool):
            strong = strong or types.bool
        elif isinstance(x, builtins.int):
            if strong is None or strong is types.bool:
                strong = types.int64
        elif isinstance(x, builtins.float):
            if strong is None or not types.heat_type_is_inexact(strong):
                strong = types.float64
        elif isinstance(x, builtins.complex):
            if strong is None or not types.heat_type_is_inexact(strong):
                strong = types.complex128
            elif not types.heat_type_is_complexfloating(strong):
                strong = types.complex64 if strong in (types.float32, types.float16, types.bfloat16) else \
                    types.complex128
    return _NATIVE.get(strong) or strong.torch_type()


def _promoted(*xs):
    """The operands as tensors of their jnp result type, on one device."""
    dt, dev = _result_dtype(*xs), _torch_device(*xs)
    return [_as_tensor(x, dt, dev) for x in xs]


def _inexact(t: torch.Tensor) -> torch.Tensor:
    """float32 for exact types, as the reference casts them."""
    return t if t.is_floating_point() or t.is_complex() else t.to(torch.float32)


def _auto_split(shape, ref: DNDarray) -> Optional[int]:
    """The reference's output split of a dense result derived from a split
    operand: the same shape (or the split axis's extent kept in place) keeps
    the split; a larger result of any other shape is split along its
    largest axis where that has a row for every rank; else replicated."""
    if ref.split is None:
        return None
    if tuple(shape) == tuple(ref.shape):
        return ref.split
    if ref.split < len(shape) and shape[ref.split] == ref.shape[ref.split]:
        return ref.split
    if len(shape):
        axis = int(np.argmax(shape))
        if shape[axis] >= ref.comm.size:
            return axis
    return None


def _wrap(result: torch.Tensor, *operands, split="auto") -> DNDarray:
    ref = _ref(*operands)
    if ref is None:
        return DNDarray.from_dense(result, None, None, None)
    if split == "auto":
        split = _auto_split(result.shape, ref)
    return DNDarray.from_dense(result, split, ref.device, ref.comm)


def _rewrap(res: DNDarray, ref) -> DNDarray:
    """A result computed row-local plus one collective, moved to the split
    the reference's rule gives it (no gather: an unsplit result keeps its
    own chunk of the new split)."""
    if not isinstance(ref, DNDarray):
        return res
    split = _auto_split(res.shape, ref)
    if res.split == split:
        return res
    if res.split is None:
        return DNDarray.from_dense(res.larray, split, res.device, res.comm, res.dtype)
    return res.resplit(split)


def _dim(axis: int, ndim: int) -> int:
    if not -builtins.max(ndim, 1) <= axis < builtins.max(ndim, 1):
        raise ValueError(f"axis {axis} is out of bounds for array of dimension {ndim}")
    return axis % builtins.max(ndim, 1)


def _dims(axis, ndim: int):
    """A reduction's dims: all for None, else a tuple of non-negative dims."""
    if axis is None:
        return tuple(range(ndim))
    if isinstance(axis, (tuple, list)):
        return tuple(_dim(a, ndim) for a in axis)
    return (_dim(axis, ndim),)


# ---------------------------------------------------------------- sorting


def _stable_argsort(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``lax.sort``'s ascending order, stably: -0.0 equal to +0.0, NaN last
    (on order keys: the card's radix sort puts a negative NaN first)."""
    from ._keys import lex_sort, sort_keys

    return lex_sort(sort_keys(t, merge_zeros=True), dim)


def argsort(a, axis: int = -1, descending: bool = False):
    """Indices that would sort ``a`` along ``axis`` (stable, int64)."""
    t = _d(a)
    t = torch.as_tensor(t)
    if axis is None:
        t, axis = t.reshape(-1), 0
    dim = _dim(axis, t.ndim)
    if descending:  # jnp reverses the array and its indices, sorts, reverses back
        idx = _stable_argsort(t.flip(dim), dim)
        idx = (t.shape[dim] - 1 - idx).flip(dim)
    else:
        idx = _stable_argsort(t, dim)
    return _wrap(idx, a)


def _top_k_indices(key: torch.Tensor, k: int) -> torch.Tensor:
    """``lax.top_k``'s indices along the last dim of order keys."""
    from .manipulations import _topk_select

    return _topk_select(key, k, key.ndim - 1)


def _partition_keys(arr: torch.Tensor):
    """Order keys of ``-arr`` and of ``arr`` in ``lax.top_k``'s order (the
    IEEE total order for floats; uint8 by jnp's ``-(arr + 1)`` trick)."""
    from ._keys import total_keys

    if arr.is_complex():
        raise NotImplementedError("jnp.partition for complex dtype is not implemented.")
    if arr.dtype == torch.bool:
        raise TypeError("partition of a bool array: jnp negates it, which bool does not support")
    if arr.is_floating_point():
        return total_keys(-arr), total_keys(arr)
    if arr.dtype == torch.uint8:
        return (-(arr + 1)).to(torch.int64), arr.to(torch.int64)
    return -arr, arr


def _kth(kth: int, n: int) -> int:
    if not -n <= kth < n:
        raise ValueError(f"kth {kth} is out of bounds for an axis of {n}")
    return kth % n


def partition(a, kth: int, axis: int = -1):
    """Partial sort as ``jnp.partition`` gives it: the kth + 1 smallest
    ascending, then the rest descending (``lax.top_k``'s picks)."""
    t = _d(a)
    dim = _dim(axis, t.ndim)
    arr = t.movedim(dim, -1)
    kth = _kth(kth, arr.shape[-1])
    neg, pos = _partition_keys(arr)
    bottom = arr.gather(-1, _top_k_indices(neg, kth + 1))
    top = arr.gather(-1, _top_k_indices(pos, arr.shape[-1] - kth - 1))
    return _wrap(torch.cat([bottom, top], -1).movedim(-1, dim), a)


def argpartition(a, kth: int, axis: int = -1):
    """``jnp.argpartition``: the indices of the kth + 1 smallest, then the
    other indices in increasing order (int32)."""
    t = _d(a)
    dim = _dim(axis, t.ndim)
    arr = t.movedim(dim, -1)
    n = arr.shape[-1]
    kth = _kth(kth, n)
    neg, _ = _partition_keys(arr)
    bottom = _top_k_indices(neg, kth + 1)
    proxy = torch.ones(arr.shape, dtype=torch.float32, device=arr.device).scatter_(-1, bottom, 0.0)
    top = _top_k_indices(proxy, n - kth - 1)
    return _wrap(torch.cat([bottom, top], -1).to(torch.int32).movedim(-1, dim), a)


def lexsort(keys, axis: int = -1):
    """Indirect stable sort by several keys, the last the primary (int64)."""
    from ._keys import lex_sort, sort_keys

    dense = [torch.as_tensor(_d(k)) for k in keys]
    if not dense:
        raise TypeError("need sequence of keys with len > 0 in lexsort")
    if len({tuple(k.shape) for k in dense}) > 1:
        raise ValueError("all keys need to be the same shape")
    if dense[0].ndim == 0:
        return _wrap(torch.zeros((), dtype=torch.int64, device=dense[0].device), *list(keys))
    dim = _dim(axis, dense[0].ndim)
    order = [key for k in reversed(dense) for key in sort_keys(k, merge_zeros=True)]
    return _wrap(lex_sort(order, dim), *list(keys))


def searchsorted(a, v, side: str = "left", sorter=None):
    """Insertion indices keeping ``a`` sorted (int32 below 2^31 entries)."""
    if side not in ("left", "right"):
        raise ValueError(f"{side!r} is an invalid value for keyword 'side'. Expected one of ['left', 'right'].")
    ad, vd = _promoted(a, v)
    if ad.ndim != 1:
        raise ValueError("a should be 1-dimensional")
    if sorter is not None:
        ad = ad[_as_tensor(sorter, device=ad.device).to(torch.int64)]
    idx = torch.searchsorted(ad.contiguous(), vd.contiguous() if vd.ndim else vd.reshape(1),
                             right=side == "right").reshape(vd.shape)
    return _wrap(idx.to(torch.int32 if ad.shape[0] < (1 << 31) else torch.int64), _pick(v, a))


def sort_complex(a):
    """Sort by real part, ties by imaginary part; complex output (the
    flattened array taken at ``lexsort``'s order, as jnp.take does)."""
    ad = torch.as_tensor(_d(a))
    if not ad.is_complex():
        ad = ad.to(torch.complex64)
    order = _stable_argsort(ad, ad.ndim - 1) if ad.ndim else torch.zeros((), dtype=torch.int64)
    return _wrap(ad.reshape(-1)[order], a)


# ------------------------------------------------------------- nan family


def _nan_input(a) -> torch.Tensor:
    t = torch.as_tensor(_d(a))
    return _inexact(t)


def _nan_extreme(a, axis, keepdims: bool, largest: bool):
    from .statistics import _lex_extreme

    t = _nan_input(a)
    dims = _dims(axis, t.ndim)
    nan = torch.isnan(t)
    fill = -math.inf if largest else math.inf
    filled = torch.where(nan, torch.tensor(fill, dtype=t.dtype, device=t.device), t)
    if t.is_complex():  # jnp orders complex values lexicographically
        res = _lex_extreme(filled, dims, keepdims, largest) if dims else filled
    else:
        red = torch.amax if largest else torch.amin
        res = red(filled, dim=dims, keepdim=keepdims) if dims else filled
    every = nan.all(dim=dims, keepdim=keepdims) if dims else nan
    return _wrap(torch.where(every, torch.nan, res), a)


def nanmax(a, axis=None, keepdims=False):
    return _nan_extreme(a, axis, keepdims, True)


def nanmin(a, axis=None, keepdims=False):
    return _nan_extreme(a, axis, keepdims, False)


def _nansum_count(t: torch.Tensor, dims, keepdims: bool):
    valid = ~torch.isnan(t)
    total = torch.where(valid, t, torch.zeros((), dtype=t.dtype, device=t.device))
    if dims:
        return total.sum(dim=dims, keepdim=keepdims), valid.sum(dim=dims, keepdim=keepdims)
    return total, valid.to(torch.int64)


def _upcast(t: torch.Tensor) -> torch.Tensor:
    """float16 and bfloat16 in float32, as jnp computes their statistics
    (rounded once to the input's type at the end)."""
    return t.float() if t.dtype in (torch.float16, torch.bfloat16) else t


def nanmean(a, axis=None, keepdims=False):
    """The NaN-free sum over the count.  For float16 jnp sums in float16
    (XLA's reduce in the input's type); torch sums in float32 and rounds
    once: about one float16 rounding apart (ROADMAP caveats)."""
    t = _nan_input(a)
    total, count = _nansum_count(t, _dims(axis, t.ndim), keepdims)
    return _wrap(total / count.to(t.dtype), a)


def _nanvar(t: torch.Tensor, axis, ddof: int, keepdims: bool) -> torch.Tensor:
    """``jnp.nanvar``: the NaN-free mean, the centred squares with NaNs as
    0, their sum over the count less ddof (NaN where that is not positive)."""
    dims = _dims(axis, t.ndim)
    total, count = _nansum_count(t, dims, True)
    mean = total / count.to(t.dtype)
    c = torch.where(torch.isnan(t), torch.zeros((), dtype=t.dtype, device=t.device), t - mean)
    sq = (c * c.conj()).real if t.is_complex() else c * c
    s = sq.sum(dim=dims, keepdim=keepdims) if dims else sq
    n = (count if keepdims or not dims else count.reshape(s.shape)) - ddof
    return torch.where(n > 0, s / n.to(s.dtype), torch.nan)


def nanvar(a, axis=None, ddof: int = 0, keepdims=False):
    t = _nan_input(a)
    return _wrap(_nanvar(_upcast(t), axis, ddof, keepdims).to(t.real.dtype), a)


def nanstd(a, axis=None, ddof: int = 0, keepdims=False):
    t = _nan_input(a)
    return _wrap(torch.sqrt(_nanvar(_upcast(t), axis, ddof, keepdims).to(t.real.dtype)), a)


def _nanarg(a, axis, largest: bool):
    """``jnp.nanargmax``/``nanargmin``: NaNs as -inf (+inf), the first
    extreme, -1 where the slice is all NaN (integers: the plain arg)."""
    t = torch.as_tensor(_d(a))
    if axis is None:
        t, axis = t.reshape(-1), 0
    dim = _dim(axis, t.ndim)
    if t.is_complex():  # jnp's comparisons take no complex operands
        raise TypeError(f"gt does not accept dtype {types.canonical_heat_type(t.dtype).__name__} at position 0. "
                        "Accepted dtypes at position 0 are subtypes of integer, floating, bool.")
    if not t.is_floating_point():
        keys = _exact_keys(t)  # bool and the unsigned types by their values' order
        return _wrap((keys.argmax if largest else keys.argmin)(dim=dim), a)
    nan = torch.isnan(t)
    fill = -math.inf if largest else math.inf
    filled = torch.where(nan, torch.tensor(fill, dtype=t.dtype, device=t.device), t)
    res = filled.argmax(dim=dim) if largest else filled.argmin(dim=dim)
    return _wrap(torch.where(nan.all(dim=dim), -1, res), a)


def nanargmax(a, axis=None):
    return _nanarg(a, axis, True)


def nanargmin(a, axis=None):
    return _nanarg(a, axis, False)


_METHODS = ("linear", "lower", "higher", "midpoint", "nearest")
_QUANTILE_BLOCK = 1 << 27  # elements a quantile sorts at a time (a sort's indices take twice the values)


def _jnp_quantile(a: torch.Tensor, q: torch.Tensor, axis, method: str, keepdims: bool, squash_nans: bool):
    """``jnp.quantile`` (``squash_nans``: ``jnp.nanquantile``) with q in the
    values' type: positions ``q (n - 1)`` (n the count of non-NaN values
    when squashing), floor and ceil, interpolated in that type."""
    if method not in _METHODS:
        raise ValueError("method can only be 'linear', 'lower', 'higher', 'midpoint', or 'nearest'")
    if a.is_complex():
        raise ValueError("quantile does not support complex input, as the operation is poorly defined.")
    if q.ndim > 1:
        raise ValueError(f"q must be have rank <= 1, got shape {tuple(q.shape)}")
    keep_shape = None
    if axis is None:
        if keepdims:
            keep_shape = [1] * a.ndim
        a, dim = a.reshape(-1), 0
    elif isinstance(axis, (tuple, list)):
        dims = _dims(axis, a.ndim)
        keep_shape = [1 if d in dims else s for d, s in enumerate(a.shape)]
        kept = [d for d in range(a.ndim) if d not in dims]
        a = a.permute(kept + list(dims)).reshape([a.shape[d] for d in kept] + [-1])
        dim = a.ndim - 1
    else:
        dim = _dim(axis, a.ndim)
    a = a.movedim(dim, -1)
    n = a.shape[-1]
    rows = a.reshape(-1, n)  # each reduced slice a row
    nan = torch.isnan(rows)
    qv = q.reshape(-1, 1)
    if squash_nans:
        counts = (~nan).sum(-1).to(q.dtype)
        pos = qv * (counts - 1)
        top = counts - 1
    else:
        pos = (qv * (n - 1)).expand(-1, rows.shape[0])
        top = torch.tensor(n - 1, dtype=q.dtype, device=a.device)
    low, high = torch.floor(pos), torch.ceil(pos)
    hw = pos - low
    lw = 1 - hw
    zero = torch.zeros((), dtype=q.dtype, device=a.device)
    low = torch.maximum(zero, torch.minimum(low, top)).to(torch.int64)
    high = torch.maximum(zero, torch.minimum(high, top)).to(torch.int64)
    # the rows sorted a block at a time (at most _QUANTILE_BLOCK elements), NaN
    # (as inf) last, as lax.sort puts it; each block gives its order statistics
    lo_v = torch.empty(low.shape, dtype=a.dtype, device=a.device)
    hi_v = torch.empty(high.shape, dtype=a.dtype, device=a.device)
    step = builtins.max(1, _QUANTILE_BLOCK // builtins.max(n, 1))
    inf = torch.tensor(math.inf, dtype=a.dtype, device=a.device)
    for r0 in range(0, rows.shape[0], step):
        blk = rows[r0:r0 + step]
        s = torch.sort(torch.where(torch.isnan(blk), inf, blk), dim=-1).values
        lo_v[:, r0:r0 + step] = s.gather(1, low[:, r0:r0 + step].T).T
        hi_v[:, r0:r0 + step] = s.gather(1, high[:, r0:r0 + step].T).T
        del s
    undefined = counts == 0 if squash_nans else nan.any(-1)
    lo_v, hi_v = torch.where(undefined, torch.nan, lo_v), torch.where(undefined, torch.nan, hi_v)
    if method == "linear":
        res = lo_v * lw + hi_v * hw
    elif method == "lower":
        res = lo_v
    elif method == "higher":
        res = hi_v
    elif method == "nearest":
        res = torch.where(hw <= 0.5, lo_v, hi_v)
    else:
        res = (lo_v + hi_v) * 0.5
    if keepdims:
        if keep_shape is None:
            keep_shape = list(a.movedim(-1, dim).shape)
            keep_shape[dim] = 1
        return res.reshape(list(q.shape) + keep_shape).to(a.dtype)
    return res.reshape(tuple(q.shape) + tuple(a.shape[:-1])).to(a.dtype)


def _quantile_call(a, q, axis, interpolation, keepdims, squash_nans, percent: bool):
    d = _nan_input(a)
    qt = _as_tensor(q, d.dtype, d.device).to(d.dtype)
    if percent:
        qt = qt / 100.0
    return _wrap(_jnp_quantile(d, qt, axis, interpolation, keepdims, squash_nans), a)


def nanmedian(a, axis=None, keepdims=False):
    return _quantile_call(a, 0.5, axis, "midpoint", keepdims, True, False)


def quantile(a, q, axis=None, interpolation: str = "linear", keepdims=False):
    return _quantile_call(a, q, axis, interpolation, keepdims, False, False)


def nanquantile(a, q, axis=None, interpolation: str = "linear", keepdims=False):
    return _quantile_call(a, q, axis, interpolation, keepdims, True, False)


def nanpercentile(a, q, axis=None, interpolation: str = "linear", keepdims=False):
    return _quantile_call(a, q, axis, interpolation, keepdims, True, True)


# ------------------------------------------------------------- statistics


def ptp(a, axis=None, keepdims=False):
    """Peak-to-peak (max - min): each rank's rows, one collective each."""
    from . import arithmetics, statistics

    if not isinstance(a, DNDarray):
        from . import factories

        a = factories.asarray(_d(a))
    return _rewrap(arithmetics.sub(statistics.max(a, axis=axis, keepdims=keepdims),
                                   statistics.min(a, axis=axis, keepdims=keepdims)), a)


def _cov(m: torch.Tensor, y: Optional[torch.Tensor], rowvar: bool) -> torch.Tensor:
    """``jnp.cov`` with ddof 1, in full float32 on the card."""
    from .linalg.basics import full_f32_matmul

    if m.ndim > 2:
        raise ValueError("m has more than 2 dimensions")
    X = torch.atleast_2d(m)
    if not rowvar and m.ndim != 1:
        X = X.T
    if y is not None:
        Y = torch.atleast_2d(y)
        if not rowvar and Y.shape[0] != 1:
            Y = Y.T
        X = torch.cat([X, Y.to(X.dtype)], 0)
    X = X - X.mean(1, keepdim=True)
    with full_f32_matmul():
        return ((X @ X.T.conj()) / (X.shape[1] - 1)).squeeze()


def corrcoef(x, y=None, rowvar: bool = True):
    xd = _inexact(torch.as_tensor(_d(x)))
    yd = None if y is None else _inexact(_as_tensor(y, device=xd.device))
    if yd is not None:
        dt = torch.promote_types(xd.dtype, yd.dtype)
        xd, yd = xd.to(dt), yd.to(dt)
    c = _cov(xd, yd, rowvar)
    if c.ndim == 0:
        return _wrap(c / c, x)
    std = torch.sqrt(torch.diagonal(c).real).to(c.dtype)
    c = c / std[:, None] / std[None, :]
    if c.is_complex():
        c = torch.complex(c.real.clamp(-1, 1), c.imag.clamp(-1, 1))
    else:
        c = c.clamp(-1, 1)
    return _wrap(c, x)


def _to_inexact_dtype(dt: torch.dtype) -> torch.dtype:
    """jax's ``to_inexact_dtype``: floats stay, bool and the integers of
    up to 32 bits become float32, the 64-bit ones float64 (as under x64)."""
    if dt.is_floating_point or dt.is_complex:
        return dt
    return torch.float64 if dt in (torch.int64, torch.uint64) else torch.float32


def _as_inexact(t: torch.Tensor) -> torch.Tensor:
    """``t`` in :func:`_to_inexact_dtype` of its type, each value rounded
    once (uint64 through its int64 bits)."""
    dt = _to_inexact_dtype(t.dtype)
    if t.dtype == torch.uint64:
        return types._u64_as_float(t.view(torch.int64), dt)
    return t.to(dt)


def _bin_edges(t: torch.Tensor, bins, range_) -> torch.Tensor:
    """``jnp.histogram_bin_edges`` of the values ``t`` (any shape)."""
    from .statistics import _edges

    t = _as_inexact(t)
    dt = t.dtype
    if isinstance(bins, str):
        raise NotImplementedError("string values for `bins` not implemented.")
    if np.ndim(bins) == 1:
        return _as_tensor(bins, device=t.device).to(dt)
    if range_ is None and t.is_complex():  # jnp orders complex values lexicographically
        from .statistics import _lex_extreme

        dims = tuple(builtins.range(t.ndim))
        lo, hi = _lex_extreme(t, dims, False, False), _lex_extreme(t, dims, False, True)
    elif range_ is None:
        lo, hi = t.min(), t.max()
    else:
        if np.shape(range_) != (2,):
            raise ValueError(f"`range` must be either None or a sequence of scalars, got {range_}")
        lo, hi = (torch.as_tensor(r, dtype=dt, device=t.device) for r in range_)
    return _edges(lo, hi, int(bins), dt, t.device)


def histogram_bin_edges(a, bins=10, range=None, weights=None):
    return _wrap(_bin_edges(torch.as_tensor(_d(a)), bins, range), a)


def _histogramdd(sample: torch.Tensor, bins, range_, weights, density):
    """``jnp.histogramdd``: each dimension's edges, each sample's bin by a
    right-sided search (the last edge closed), a count (or weight sum) over
    the flattened bins with the outliers' bins cut off."""
    from .statistics import _search_right

    sample = _as_inexact(sample)
    if weights is not None:
        dt = torch.promote_types(sample.dtype, _to_inexact_dtype(weights.dtype))
        sample, weights = sample.to(dt), weights.to(dt)
    n, d = sample.shape
    if range_ is not None and (len(range_) != d or builtins.any(r is not None and np.shape(r)[0] != 2
                                                                 for r in range_)):
        raise ValueError(f"For sample.shape={(n, d)}, range must be a sequence of {d} pairs or Nones; got {range_}")
    try:
        per_dim = list(bins)
        if len(per_dim) != d:
            raise ValueError("should be a bin for each dimension.")
    except TypeError:
        per_dim = [bins] * d
    edges, idx = [], []
    for i in builtins.range(d):
        e = _bin_edges(sample[:, i], per_dim[i], None if range_ is None else range_[i])
        col = sample[:, i].contiguous()
        b = _search_right(e.contiguous(), col)
        idx.append(torch.where(col == e[-1], b - 1, b))
        edges.append(e)
    nbins = [e.numel() + 1 for e in edges]
    flat = torch.zeros(n, dtype=torch.int64, device=sample.device)
    for b, nb in zip(idx, nbins):
        flat = flat * nb + b.clamp(0, nb - 1)
    size = math.prod(nbins)
    if weights is None:
        hist = torch.bincount(flat, minlength=size)
    else:
        hist = torch.zeros(size, dtype=weights.dtype, device=sample.device).index_add_(0, flat, weights)
    hist = hist.reshape(nbins)[(slice(1, -1),) * d]
    if density:
        hist = hist.to(sample.dtype)
        hist = hist / hist.sum()
        for i, e in enumerate(edges):
            shape = [1] * d
            shape[i] = -1
            hist = hist / torch.diff(e).reshape(shape)
    return hist, edges


def histogram2d(x, y, bins=10, range=None, density=None, weights=None):
    xd, yd = _promoted(x, y)
    w = None if weights is None else _as_tensor(weights, device=xd.device)
    try:
        n_bins = len(bins)
    except TypeError:
        n_bins = 1
    if n_bins != 1 and n_bins != 2:
        bins = [bins, bins]
    h, (xe, ye) = _histogramdd(torch.stack([xd, yd], 1), bins, range, w, density)
    return _wrap(h, x), _wrap(xe, x), _wrap(ye, x)


def histogramdd(sample, bins=10, range=None, density=None, weights=None):
    s = torch.as_tensor(_d(sample))
    w = None if weights is None else _as_tensor(weights, device=s.device)
    h, edges = _histogramdd(s, bins, range, w, density)
    return _wrap(h, sample), [_wrap(e, sample) for e in edges]


def count_nonzero(a, axis=None, keepdims=False):
    """The count of non-zero entries (int64): each rank's rows, one sum."""
    from . import arithmetics, factories, relational

    if not isinstance(a, DNDarray):
        a = factories.asarray(_d(a))
    res = arithmetics.sum(relational.ne(a, 0), axis=axis, keepdims=keepdims)
    if res.dtype is not types.int64:
        res = res.astype(types.int64)
    return _rewrap(res, a)


# ------------------------------------------------------------ manipulations


def append(arr, values, axis=None):
    ad, vd = _promoted(arr, values)
    if axis is None:
        out = torch.cat([ad.reshape(-1), vd.reshape(-1)])
    else:
        out = torch.cat([ad, vd], _dim(axis, ad.ndim))
    return _wrap(out, _pick(arr, values))


def _index_obj(obj, n: int, device):
    """A numpy-style index (int, slice, sequence, bool mask) along an axis
    of n entries, as the int64 positions it selects."""
    if isinstance(obj, slice):
        return torch.arange(n, device=device)[obj]
    if isinstance(obj, DNDarray):
        obj = obj._dense()
    t = torch.as_tensor(np.asarray(obj) if not isinstance(obj, torch.Tensor) else obj, device=device)
    if t.dtype == torch.bool:
        return torch.nonzero(t.reshape(-1)).reshape(-1)
    if t.numel() == 0:
        return t.to(torch.int64).reshape(-1)
    t = t.to(torch.int64).reshape(-1)
    if bool(((t < -n) | (t >= n)).any()):
        raise IndexError(f"index out of bounds for axis with size {n}")
    return t % n


def _integral_index(obj) -> bool:
    """Whether an index array is empty or of an integer or bool type, read
    from its type alone (no copy of its values)."""
    if isinstance(obj, DNDarray):
        return obj.size == 0 or types.heat_type_is_exact(obj.dtype)
    if isinstance(obj, torch.Tensor):
        return obj.numel() == 0 or not (obj.is_floating_point() or obj.is_complex())
    obj = np.asarray(obj)
    return obj.size == 0 or obj.dtype.kind in "biu"


def delete(arr, obj, axis=None):
    t = torch.as_tensor(_d(arr))
    if axis is None:
        t, axis = t.reshape(-1), 0
    dim = _dim(axis, t.ndim)
    if not isinstance(obj, slice) and not _integral_index(obj):
        raise ValueError("np.delete(arr, obj): obj must be of an integer or bool type.")
    keep = torch.ones(t.shape[dim], dtype=torch.bool, device=t.device)
    keep[_index_obj(obj, t.shape[dim], t.device)] = False
    return _wrap(t.index_select(dim, torch.nonzero(keep).reshape(-1)), arr)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def insert(arr, obj, values, axis=None):
    """numpy's insert (jnp's values, cast to the array's type), computed
    on the host."""
    t = torch.as_tensor(_d(arr))
    if isinstance(obj, DNDarray):
        obj = _host(obj._dense())
    vals = _host(_as_tensor(values)) if not isinstance(values, _PYTHON_SCALARS) else values
    if t.dtype == torch.bfloat16:
        raise TypeError("insert of bfloat16 arrays: numpy has no bfloat16")
    out = np.insert(_host(t), obj, np.asarray(vals).astype(_host(t).dtype), axis=axis)
    return _wrap(torch.from_numpy(np.ascontiguousarray(out)).to(t.device), arr)


def resize(a, new_shape):
    t = torch.as_tensor(_d(a)).reshape(-1)
    shape = (int(new_shape),) if isinstance(new_shape, (builtins.int, np.integer)) else tuple(int(s) for s in new_shape)
    if builtins.any(s < 0 for s in shape):
        raise ValueError("all elements of `new_shape` must be non-negative")
    size = math.prod(shape)
    if t.numel() == 0 or size == 0:
        return _wrap(torch.zeros(shape, dtype=t.dtype, device=t.device), a)
    reps = -(-size // t.numel())
    return _wrap(t.repeat(reps)[:size].reshape(shape), a)


def rollaxis(a, axis: int, start: int = 0):
    t = torch.as_tensor(_d(a))
    n = t.ndim
    axis = _dim(axis, n)
    if not -n <= start <= n:
        raise ValueError(f"start {start} is out of bounds for array of dimension {n}")
    start = start + n if start < 0 else start
    if axis < start:
        start -= 1
    order = [d for d in range(n) if d != axis]
    order.insert(start, axis)
    return _wrap(t.permute(order), a)


def trim_zeros(filt, trim: str = "fb"):
    # data-dependent output shape: trimmed on the host, as the reference does
    arr = np.asarray(filt.numpy() if isinstance(filt, DNDarray) else filt)
    return _wrap(torch.from_numpy(np.ascontiguousarray(np.trim_zeros(arr, trim))), filt)


def array_split(ary, indices_or_sections, axis: int = 0):
    t = torch.as_tensor(_d(ary))
    sections = indices_or_sections if isinstance(indices_or_sections, (builtins.int, np.integer)) else \
        [int(i) for i in indices_or_sections]
    return [_wrap(p, ary) for p in torch.tensor_split(t, sections, _dim(axis, t.ndim))]


def dstack(tup):
    parts = _promoted(*tup)
    return _wrap(torch.dstack(parts), *list(tup))


def _atleast(fn, arys):
    out = [_wrap(fn(torch.as_tensor(_d(a))), a) for a in arys]
    return out[0] if len(out) == 1 else out


def atleast_1d(*arys):
    return _atleast(torch.atleast_1d, arys)


def atleast_2d(*arys):
    return _atleast(torch.atleast_2d, arys)


def atleast_3d(*arys):
    return _atleast(torch.atleast_3d, arys)


def copyto(dst, src, where=True):
    """Copy ``src`` into ``dst`` in place (broadcasting, optional mask)."""
    if not isinstance(dst, DNDarray):
        raise TypeError("copyto destination must be a DNDarray")
    dense = dst._dense()
    sd = _as_tensor(src, device=dense.device)
    sd = types._cast(sd, types.canonical_heat_type(sd.dtype), dst.dtype).broadcast_to(dst.shape)
    if isinstance(where, builtins.bool):
        new = sd.clone() if where else dense
    else:
        new = torch.where(_as_tensor(where, device=dense.device).to(torch.bool).broadcast_to(dst.shape), sd, dense)
    dst._replace_local(new.contiguous())


# ---------------------------------------------------------------- indexing


def argwhere(a):
    return _wrap(torch.argwhere(_held(torch.as_tensor(_d(a)))), a)


def flatnonzero(a):
    return _wrap(torch.nonzero(_held(torch.as_tensor(_d(a))).reshape(-1)).reshape(-1), a)


def extract(condition, arr):
    c = torch.as_tensor(_d(condition)).reshape(-1)
    v = _as_tensor(arr, device=c.device).reshape(-1)
    return _wrap(v[c != 0], _pick(arr, condition))


# --------------------------------------------------------------- predicates


def isscalar(element) -> builtins.bool:
    if isinstance(element, DNDarray):
        return False
    return builtins.bool(np.isscalar(element))


def iscomplexobj(x) -> builtins.bool:
    if isinstance(x, DNDarray):
        return types.heat_type_is_complexfloating(x.dtype)
    return builtins.bool(np.iscomplexobj(x))


def isrealobj(x) -> builtins.bool:
    return not iscomplexobj(x)


# --------------------------------------------------------- elementwise pair


def _fpick(x1, x2, largest: bool):
    """``where(x1 > x2 | isnan(x2), x1, x2)`` (``<`` for the minimum):
    complex values in lexicographic order, the unsigned types by their
    values."""
    from ._operations import _lex_greater

    a, b = _promoted(x1, x2)
    if a.is_complex():
        first = _lex_greater(a, b) if largest else _lex_greater(b, a)
    elif a.is_floating_point():
        first = a > b if largest else a < b
    else:
        ka, kb = _exact_keys(a), _exact_keys(b)
        first = ka > kb if largest else ka < kb
    if a.is_floating_point() or a.is_complex():
        first = first | torch.isnan(b)
    return _wrap(_unheld(torch.where(first, _held(a), _held(b)), a.dtype), _pick(x1, x2))


def fmax(x1, x2):
    """Elementwise maximum ignoring NaNs: ``where(x1 > x2 | isnan(x2), x1, x2)``."""
    return _fpick(x1, x2, True)


def fmin(x1, x2):
    return _fpick(x1, x2, False)


# ------------------------------------------------------------------ linalg


def _contract(a: torch.Tensor, b: torch.Tensor, a_axes, b_axes) -> torch.Tensor:
    """``tensordot`` over the paired axes as one matrix product (IEEE
    float32; integers exactly on the card too, where cuBLAS multiplies
    none)."""
    from .linalg.basics import _mm

    a_axes = [d % a.ndim for d in a_axes]
    b_axes = [d % b.ndim for d in b_axes]
    if [a.shape[i] for i in a_axes] != [b.shape[j] for j in b_axes]:
        raise ValueError(f"contracted extents differ: {tuple(a.shape)} and {tuple(b.shape)} over {a_axes}, {b_axes}")
    a_free = [d for d in range(a.ndim) if d not in a_axes]
    b_free = [d for d in range(b.ndim) if d not in b_axes]
    k = math.prod(a.shape[i] for i in a_axes)
    a2 = _held(a.permute(a_free + a_axes).reshape(-1, k))
    b2 = _held(b.permute(b_axes + b_free).reshape(k, -1))
    out = _mm(a2, b2).reshape([a.shape[d] for d in a_free] + [b.shape[d] for d in b_free])
    if a.dtype in _NATIVE.values():  # the holding integers' product, wrapped to the width
        kind = types.canonical_heat_type(a.dtype)
        return _unheld(types._wrap(out, kind), a.dtype)
    return out


def inner(a, b):
    ad, bd = _promoted(a, b)
    out = ad * bd if ad.ndim == 0 or bd.ndim == 0 else _contract(ad, bd, [-1], [-1])
    return _wrap(out, _pick(a, b))


def tensordot(a, b, axes=2):
    ad, bd = _promoted(a, b)
    if isinstance(axes, (builtins.int, np.integer)):
        a_axes, b_axes = list(range(ad.ndim - axes, ad.ndim)), list(range(axes))
    else:
        a_axes, b_axes = ([int(i)] if np.ndim(i) == 0 else [int(j) for j in i] for i in axes)
    return _wrap(_contract(ad, bd, a_axes, b_axes), _pick(a, b))


def kron(a, b):
    ad, bd = _promoted(a, b)
    if ad.dtype == torch.bool:  # jnp multiplies no bools
        raise TypeError("mul does not accept dtype bool at position 0. Accepted dtypes at position 0 are subtypes "
                        "of integer, floating, complexfloating.")
    return _wrap(torch.kron(ad, bd), _pick(a, b))


# ---------------------------------------------------------------- factories


def tri(N: int, M: Optional[int] = None, k: int = 0, dtype=None, split=None, device=None, comm=None):
    from .devices import sanitize_device

    M = N if M is None else M
    dev = sanitize_device(device).torch_device
    dt = types.canonical_heat_type(dtype or "float32")
    ones = torch.arange(M, device=dev)[None, :] <= torch.arange(N, device=dev)[:, None] + k
    return DNDarray.from_dense(types._cast(ones, types.bool, dt), split, device, comm, dtype=dt)


def vander(x, N: Optional[int] = None, increasing: bool = False):
    t = torch.as_tensor(_d(x))
    if t.ndim != 1:
        raise ValueError("x must be a one-dimensional array")
    N = t.shape[0] if N is None else int(N)
    if N < 0:
        raise ValueError("N must be nonnegative")
    powers = torch.arange(N, device=t.device).to(t.dtype)
    if not increasing:
        powers = (N - 1) - powers
    return _wrap(t[:, None] ** powers[None, :], x)


def einsum(subscripts: str, *operands, precision=None):
    """Einstein summation, in IEEE float32 on the card (``precision`` has no
    other meaning here); integers on the host, where torch multiplies them
    exactly (cuBLAS multiplies none)."""
    from .linalg.basics import full_f32_matmul

    dense = _promoted(*operands)
    exact = not (dense[0].is_floating_point() or dense[0].is_complex())
    with full_f32_matmul():
        out = torch.einsum(subscripts, *[d.cpu() if exact else d for d in dense])
    return _wrap(out.to(dense[0].device, dense[0].dtype), *list(operands))


def array_equal(a1, a2) -> builtins.bool:
    """True when shapes and all elements match."""
    d1, d2 = _promoted(a1, a2)
    if d1.shape != d2.shape:
        return False
    return builtins.bool(torch.equal(d1, d2)) if not d1.is_floating_point() else builtins.bool((d1 == d2).all())


def array_equiv(a1, a2) -> builtins.bool:
    """True when broadcast-compatible and all elements match."""
    d1, d2 = _promoted(a1, a2)
    try:
        shape = torch.broadcast_shapes(d1.shape, d2.shape)
    except RuntimeError:
        return False
    return builtins.bool((d1.broadcast_to(shape) == d2.broadcast_to(shape)).all())


# -------------------------------------------------- second extension batch


def amax(a, axis=None, keepdims=False):
    """Alias of max (NumPy parity)."""
    from . import statistics

    return statistics.max(a, axis=axis, keepdims=keepdims)


def amin(a, axis=None, keepdims=False):
    from . import statistics

    return statistics.min(a, axis=axis, keepdims=keepdims)


def diagflat(v, k: int = 0):
    """2-D array with the flattened input on the k-th diagonal."""
    return _wrap(torch.diagflat(torch.as_tensor(_d(v)), k), v)


def correlate(a, v, mode: str = "valid"):
    """1-D cross-correlation, ``jnp.correlate``'s: the conjugated second
    operand, swapped (and the result reversed) where it is the longer."""
    from .signal import _conv1d_valid

    x, y = _promoted(a, v)
    # 64-bit integers in float64, the others in float32, as jnp promotes them
    wide = x.dtype in (torch.int64, torch.uint64)
    x, y = (t.to(torch.float64) if wide else _inexact(t) for t in (x, y))
    if x.ndim != 1 or y.ndim != 1:
        raise ValueError("correlate() only support 1-dimensional inputs.")
    if x.numel() == 0 or y.numel() == 0:
        raise ValueError(f"correlate: inputs cannot be empty, got shapes {tuple(x.shape)} and {tuple(y.shape)}.")
    y = y.conj()
    reverse = x.shape[0] < y.shape[0]
    if reverse:
        x, y = y, x
    m = y.shape[0]
    if mode == "valid":
        pad = (0, 0)
    elif mode == "same":
        pad = (m // 2, m - m // 2 - 1)
    elif mode == "full":
        pad = (m - 1, m - 1)
    else:
        raise ValueError("mode must be one of ['full', 'same', 'valid']")
    if bool(torch.isfinite(x).all() & torch.isfinite(y).all()):
        out = _conv1d_valid(torch.nn.functional.pad(x, pad), y.flip(0))
    else:
        # XLA's padding adds no products: a NaN or inf meets only the taps in range
        n_out = x.shape[0] + pad[0] + pad[1] - m + 1
        pos = torch.arange(n_out, device=x.device)[:, None] + torch.arange(m, device=x.device)[None, :] - pad[0]
        inside = (pos >= 0) & (pos < x.shape[0])
        prods = x[pos.clamp(0, x.shape[0] - 1)] * y[None, :]
        out = torch.where(inside, prods, torch.zeros((), dtype=prods.dtype, device=x.device)).sum(1)
    return _wrap(out.flip(0) if reverse else out, _pick(a, v))


def block(arrays):
    """Assemble an array from nested lists of blocks (numpy's rule: the
    innermost lists join along the last axis)."""
    leaves = []

    def depth(obj):
        if isinstance(obj, list):
            if not obj:
                raise ValueError("block: lists cannot be empty")
            ds = {depth(o) for o in obj}
            if len(ds) != 1:
                raise ValueError("block: list depths are mismatched")
            return 1 + ds.pop()
        leaves.append(obj)
        return 0

    list_ndim = depth(arrays)
    dt, dev = _result_dtype(*leaves), _torch_device(*leaves)
    dense = {id(o): _as_tensor(o, dt, dev) for o in leaves}
    ndim = builtins.max([list_ndim] + [t.ndim for t in dense.values()])

    def assemble(obj, level):
        if isinstance(obj, list):
            return torch.cat([assemble(o, level + 1) for o in obj], dim=-(list_ndim - level))
        t = dense[id(obj)]
        return t.reshape((1,) * (ndim - t.ndim) + tuple(t.shape))

    ref = _ref(*leaves)
    return _wrap(assemble(arrays, 0), *([ref] if ref is not None else []))


def _bit_weights(bitorder: str, device) -> torch.Tensor:
    if bitorder not in ("big", "little"):
        raise ValueError("'order' must be either 'little' or 'big'")
    w = 1 << torch.arange(8, device=device)
    return w.flip(0) if bitorder == "big" else w


def packbits(a, axis=None, bitorder: str = "big"):
    t = torch.as_tensor(_d(a))
    if t.is_floating_point() or t.is_complex():
        raise TypeError(f"Expected an input array of integer or boolean data type, got {t.dtype}")
    bits = (t != 0).to(torch.int64)
    if axis is None:
        bits, axis = bits.reshape(-1), 0
    dim = _dim(axis, bits.ndim)
    bits = bits.movedim(dim, -1)
    n = bits.shape[-1]
    bits = torch.nn.functional.pad(bits, (0, -n % 8))
    packed = (bits.reshape(bits.shape[:-1] + (-1, 8)) * _bit_weights(bitorder, t.device)).sum(-1)
    return _wrap(packed.to(torch.uint8).movedim(-1, dim), a)


def unpackbits(a, axis=None, count=None, bitorder: str = "big"):
    t = torch.as_tensor(_d(a))
    if t.dtype != torch.uint8:
        raise TypeError("Expected an input array of unsigned byte data type")
    if axis is None:
        t, axis = t.reshape(-1), 0
    dim = _dim(axis, t.ndim)
    t = t.movedim(dim, -1).to(torch.int64)
    bits = ((t[..., None] & _bit_weights(bitorder, t.device)) > 0).reshape(t.shape[:-1] + (-1,))
    if count is not None:
        n = bits.shape[-1]
        stop = count if count >= 0 else builtins.max(0, n + count)
        bits = torch.nn.functional.pad(bits, (0, stop - n)) if stop > n else bits[..., :stop]
    return _wrap(bits.to(torch.uint8).movedim(-1, dim), a)


def base_repr(number: int, base: int = 2, padding: int = 0) -> str:
    return np.base_repr(int(number), base=base, padding=padding)


def binary_repr(num: int, width=None) -> str:
    return np.binary_repr(int(num), width=width)


def format_float_positional(x, *args, **kwargs) -> str:
    if isinstance(x, DNDarray):
        x = x.item()
    return np.format_float_positional(x, *args, **kwargs)


def format_float_scientific(x, *args, **kwargs) -> str:
    if isinstance(x, DNDarray):
        x = x.item()
    return np.format_float_scientific(x, *args, **kwargs)


def _numpy_dtype(o) -> np.dtype:
    if isinstance(o, DNDarray):
        return np.dtype(types._np_proxy(o.dtype))
    return np.asarray(o).dtype


def einsum_path(subscripts, *operands, optimize="greedy"):
    """Contraction-order plan (numpy's, over shape dummies: no data moves)."""
    dummies = [np.empty(tuple(o.shape) if isinstance(o, DNDarray) else np.shape(o), dtype=_numpy_dtype(o))
               for o in operands]
    return np.einsum_path(subscripts, *dummies, optimize=optimize)


def array2string(a, *args, **kwargs) -> str:
    return np.array2string(a.numpy() if isinstance(a, DNDarray) else np.asarray(a), *args, **kwargs)


def array_repr(arr, *args, **kwargs) -> str:
    return np.array_repr(arr.numpy() if isinstance(arr, DNDarray) else np.asarray(arr), *args, **kwargs)


def array_str(a, *args, **kwargs) -> str:
    return np.array_str(a.numpy() if isinstance(a, DNDarray) else np.asarray(a), *args, **kwargs)


def asfarray(a, dtype=None):
    """Convert to a floating-point DNDarray."""
    from . import factories

    out = factories.asarray(a, dtype=dtype)
    if not types.heat_type_is_inexact(out.dtype):
        out = out.astype(types.float32)
    return out


def ascontiguousarray(a, dtype=None):
    """Tensors here are C-contiguous; an asarray alias."""
    from . import factories

    return factories.asarray(a, dtype=dtype)


def asfortranarray(a, dtype=None):
    """Fortran order is a logical layout tag; a dtype-honoring asarray."""
    from . import factories

    if isinstance(a, DNDarray):
        return a if dtype is None else a.astype(dtype)
    return factories.asarray(a, dtype=dtype, order="F")


def asanyarray(a, dtype=None):
    from . import factories

    return factories.asarray(a, dtype=dtype)


def asarray_chkfinite(a, dtype=None):
    from . import factories

    out = factories.asarray(a, dtype=dtype)
    t = out._dense()
    if (t.is_floating_point() or t.is_complex()) and not builtins.bool(torch.isfinite(t).all()):
        raise ValueError("array must not contain infs or NaNs")
    return out


class _GridProxy:
    """np.mgrid / np.ogrid analogs: index with slices, get DNDarrays."""

    def __init__(self, dense: builtins.bool):
        self._dense_grid = dense

    def __getitem__(self, key):
        out = (np.mgrid if self._dense_grid else np.ogrid)[key]
        if isinstance(out, (list, tuple)):
            return [DNDarray.from_dense(torch.from_numpy(np.ascontiguousarray(o)), None, None, None) for o in out]
        return DNDarray.from_dense(torch.from_numpy(np.ascontiguousarray(out)), None, None, None)


mgrid = _GridProxy(True)
ogrid = _GridProxy(False)


# ----------------------------------------------- final parity stragglers


def from_dlpack(x):
    """Import an array through the DLPack protocol."""
    from torch.utils import dlpack

    return DNDarray.from_dense(dlpack.from_dlpack(x), None, None, None)


def isfortran(a) -> builtins.bool:
    """Tensors here are row-major; Fortran order is only a logical layout
    tag, so this is always False."""
    return False


def isnat(x):
    """NaT detection needs datetime dtypes, which the framework (like the
    reference) does not provide."""
    raise TypeError("isnat: datetime64/timedelta64 dtypes are not supported")


def require(a, dtype=None, requirements=None):
    """np.require analog: dtype conversion; the layout flags need nothing
    (tensors here are C-contiguous, aligned and writeable)."""
    from . import factories

    return factories.asarray(a, dtype=dtype)


class broadcast:
    """np.broadcast analog: the broadcast shape/metadata of the operands."""

    def __init__(self, *arrays):
        shapes = [tuple(a.shape) if isinstance(a, DNDarray) else np.shape(a) for a in arrays]
        self.shape = tuple(np.broadcast_shapes(*shapes))
        self.ndim = len(self.shape)
        self.nd = self.ndim
        self.size = int(np.prod(self.shape)) if self.shape else 1
        self.numiter = len(arrays)


def asmatrix(data, dtype=None):
    """Legacy matrix API: returns a 2-D DNDarray (no matrix subclass)."""
    from . import factories

    out = factories.asarray(data, dtype=dtype)
    if out.ndim < 2:
        return DNDarray.from_dense(torch.atleast_2d(out._dense()), None, out.device, out.comm, dtype=out.dtype)
    if out.ndim > 2:
        raise ValueError("matrix must be 2-dimensional")
    return out


mat = asmatrix


def bmat(obj):
    """Legacy block-matrix constructor: 2-D `block` (string form unsupported)."""
    if isinstance(obj, str):
        raise NotImplementedError("string-form bmat is not supported; pass nested lists")
    return asmatrix(block(obj))
