"""Generic wrappers behind the element-wise, reducing and scanning
operations (counterpart of heat_tpu/core/_operations.py).

Element-wise work runs on each rank's padded chunk; the padding carries
arbitrary values through it.  Operands of different layouts are brought
to the result's layout first: an unsplit operand gives each rank its own
rows, an operand split along another axis is resplit (one all-to-all);
split data is never gathered, except an operand split along an axis it
broadcasts.  A reduction sets the padding to the operation's neutral
element first and, when it reduces the split axis, combines the ranks'
partial results with one all-reduce.  A scan along the split axis is a
local scan of the masked chunk, an exclusive scan of each rank's last
slice over the ranks, and a local combine.

Shape-preserving results (element-wise, scans) adopt the ragged layout of
their first operand of the same shape and split
(:meth:`DNDarray._propagate_layout_from`); reductions come back balanced;
``out=`` keeps ``out``'s own layout.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from . import types
from .dndarray import DNDarray, _pad_along
from .sanitation import store_out
from .stride_tricks import broadcast_shape, sanitize_axis

__all__ = []

_SCALARS = (bool, int, float, complex)


def _as_dndarray(v, like: DNDarray) -> DNDarray:
    """A numpy scalar or array, or a list or tuple, as an unsplit DNDarray
    of its own dtype on ``like``'s device and communicator, as the
    reference's ``_as_dndarray`` makes it; anything else is returned as it
    is."""
    if isinstance(v, (np.generic, np.ndarray, list, tuple)):
        from . import factories

        return factories.array(v, device=like.device, comm=like.comm)
    return v


def _holding(x: DNDarray) -> DNDarray:
    """A uint16, uint32 or uint64 array as the signed array of its holding
    dtype (the same bits); other arrays as they are."""
    if x.dtype not in types._WIDENED:
        return x
    return x._like(x.larray_padded, dtype=types.canonical_heat_type(x.larray_padded.dtype))


def _unsigned(res: DNDarray, kind) -> DNDarray:
    """A result computed on holding integers (:func:`_holding`) as ``kind``,
    wrapped to its width; other results as they are."""
    if kind not in types._WIDENED:
        return res
    return res._like(types._wrap(res.larray_padded, kind), dtype=kind)


def _as_float(operation: Callable) -> Callable:
    """``operation`` on holding tensors of uint16, uint32 or uint64 taken to
    the float type the reference meets them in (float32, float64 for uint64),
    each value rounded once: the widened form of every binary operation
    whose result is inexact."""
    def op(a: torch.Tensor, b: torch.Tensor, t) -> torch.Tensor:
        to = types.float64 if t is types.uint64 else types.float32
        return operation(types._cast(a, t, to), types._cast(b, t, to))

    return op


def _refuse_complex(name: str, exc, *operands) -> None:
    """Raise ``exc`` (the reference's exception type for ``name``) where an
    operand is complex: the reference refuses complex operands there."""
    for t in operands:
        try:
            t_type = types.heat_type_of(t)
        except TypeError:  # not an operand (a bound left as None)
            continue
        if types.heat_type_is_complexfloating(t_type):
            raise exc(f"{name} does not accept complex operands, got {t_type.__name__}")


def _lex_greater(a: torch.Tensor, b: torch.Tensor, strict: bool = True) -> torch.Tensor:
    """Complex ``a > b`` (``>=`` unless ``strict``) in lexicographic order,
    the real parts first, as XLA orders complex numbers."""
    tie = a.imag > b.imag if strict else a.imag >= b.imag
    return (a.real > b.real) | ((a.real == b.real) & tie)


def _out_split_binary(t1: DNDarray, t2: DNDarray, gshape) -> Optional[int]:
    """The result's split where the layouts differ: the first operand whose
    split lands on an axis of the result it does not broadcast along."""
    nd = len(gshape)
    for t in (t1, t2):
        if t.split is not None:
            cand = t.split + nd - t.ndim
            if t.shape[t.split] == gshape[cand] and gshape[cand] != 1:
                return cand
    return None


def _aligned(t: DNDarray, gshape, split: Optional[int]) -> torch.Tensor:
    """``t``'s tensor on this rank that broadcasts against this rank's
    padded chunk of a result of ``gshape`` split along ``split``: its own
    padded chunk where it is split so; its rows of that chunk where it is
    whole (no communication); resplit (one all-to-all) where it is split
    along another axis; whole where it broadcasts along ``split``."""
    if split is None:
        return t._dense()
    a = split - (len(gshape) - t.ndim)
    if a < 0 or t.shape[a] == 1:
        return t._dense()
    if t.split == a:
        return t.larray_padded
    if t.split is None:
        comm = t.comm
        lo, lshape, _ = comm.chunk(t.shape, a)
        return _pad_along(t.larray.narrow(a, lo, lshape[a]), a, comm.padded_extent(t.shape[a]) // comm.size)
    return t.resplit(a).larray_padded


def __binary_op(operation: Callable, t1, t2, out: Optional[DNDarray] = None, where=True,
                widened: Optional[Callable] = None) -> DNDarray:
    """``operation`` element-wise on two operands with numpy broadcasting;
    at least one is a DNDarray, the other may be a python scalar or a numpy
    scalar or array.  Two DNDarrays of different types meet in their
    promoted type (``types.promote_types``), as the reference's do: a 0-d
    operand widens the result like any other.

    Where the operands meet in uint16, uint32 or uint64, ``widened(a, b,
    t)`` computes on the holding tensors: its result is of type t where its
    tensor is t's holding dtype, else of its tensor's own type.  Without it
    the operands are taken to float (:func:`_as_float`).  ``where`` (broadcast to the result) keeps the result where it
    is true and ``out``'s value (0 without ``out``) elsewhere; ``out``
    receives the result."""
    res = _binary(operation, t1, t2, widened)
    if where is not True and where is not None:
        cond = _as_dndarray(where, res)
        if not isinstance(cond, DNDarray):
            from . import factories

            cond = factories.array(where, device=res.device, comm=res.comm)
        keep = _aligned(cond, res.shape, res.split).to(torch.bool)
        data = res.larray_padded
        if out is not None:
            base = types._cast(_aligned(out, res.shape, res.split), out.dtype, res.dtype)
        else:
            base = torch.zeros((), dtype=data.dtype, device=data.device)
        res = res._like(torch.where(keep, data, base.to(data.device)), dtype=res.dtype)
    if out is not None:
        return store_out(res, out)
    return res._propagate_layout_from(t1, t2)


def _binary(operation: Callable, t1, t2, widened: Optional[Callable]) -> DNDarray:
    if not isinstance(t1, DNDarray) and not isinstance(t2, DNDarray):
        raise TypeError(f"at least one operand must be a DNDarray, got {type(t1)} and {type(t2)}")
    like = t1 if isinstance(t1, DNDarray) else t2
    t1, t2 = _as_dndarray(t1, like), _as_dndarray(t2, like)
    if isinstance(t1, _SCALARS) or isinstance(t2, _SCALARS):
        # a python scalar meets the array as the reference's 0-d array of
        # its own type (bool, int32, float32, complex64): both in the
        # promoted type
        arr, v = (t1, t2) if isinstance(t1, DNDarray) else (t2, t1)
        common = types.promote_types(arr.dtype, types.heat_type_of(v))
        data = types._cast(arr.larray_padded, arr.dtype, common)
        if common in types._WIDENED:
            widened = widened or _as_float(operation)
            s = torch.tensor(int(v), dtype=common.torch_type())  # only a bool meets them in their own type
            out = widened(data, s, common) if t1 is arr else widened(s, data, common)
            return arr._like(out, dtype=common if out.dtype == common.torch_type() else None)
        # a 0-d host tensor: CUDA kernels take it as a scalar argument
        s = torch.tensor(v, dtype=common.torch_type())
        return arr._like(operation(data, s) if t1 is arr else operation(s, data))
    if not isinstance(t1, DNDarray) or not isinstance(t2, DNDarray):
        raise TypeError(f"operands must be DNDarrays, numpy or python scalars, got {type(t1)} and {type(t2)}")
    if t1.dtype != t2.dtype:
        common = types.promote_types(t1.dtype, t2.dtype)
        t1, t2 = t1.astype(common), t2.astype(common)
    wide = t1.dtype if t1.dtype in types._WIDENED else None
    if wide is not None:
        widened = widened or _as_float(operation)
        operation = lambda a, b: widened(a, b, wide)  # noqa: E731

    def wrap(out, gshape, split):
        dtype = wide if wide is not None and out.dtype == wide.torch_type() else None
        return t1._like(out, gshape, split, dtype)

    gshape = broadcast_shape(t1.gshape, t2.gshape)
    if t1.shape == t2.shape == gshape and t1.split == t2.split:
        return wrap(operation(t1.larray_padded, t2.larray_padded), gshape, t1.split)
    for carrier, other in ((t1, t2), (t2, t1)):
        # a 0-d operand broadcasts against the other's padded chunk
        if other.ndim == 0 and carrier.shape == gshape and (carrier.split is None
                                                            or carrier.shape[carrier.split] != 1):
            return wrap(operation(t1.larray_padded, t2.larray_padded), gshape, carrier.split)
    split = _out_split_binary(t1, t2, gshape)
    return wrap(operation(_aligned(t1, gshape, split), _aligned(t2, gshape, split)), gshape, split)


def __local_op(operation: Callable, x: DNDarray, out: Optional[DNDarray] = None, no_cast: bool = False,
               widened: Optional[Callable] = None, **kwargs) -> DNDarray:
    """``operation`` on each rank's chunk; integer input is cast to float32
    first unless ``no_cast``.  On uint16, uint32 and uint64 (held wider)
    the cast rounds each value once; without it ``widened(data, t)``, or
    else ``operation`` itself, runs on the holding tensor, and a result in
    the holding dtype wraps to t's width (``neg``, ``square``)."""
    if not isinstance(x, DNDarray):
        raise TypeError(f"expected x to be a DNDarray, but was {type(x)}")
    data = x.larray_padded
    if x.dtype in types._WIDENED:
        if not no_cast:
            res = x._like(operation(types._cast(data, x.dtype, types.float32), **kwargs))
        else:
            r = widened(data, x.dtype) if widened is not None else operation(data, **kwargs)
            held = r.dtype == data.dtype
            res = x._like(types._wrap(r, x.dtype) if held else r, dtype=x.dtype if held else None)
    else:
        if not no_cast and not types.heat_type_is_inexact(x.dtype):
            data = data.to(torch.float32)
        res = x._like(operation(data, **kwargs))
    if out is not None:
        return store_out(res, out)
    return res._propagate_layout_from(x)


def _axes(x: DNDarray, axis):
    """``(axis, axes)``: the sanitized axis and the tuple of reduced axes."""
    axis = sanitize_axis(x.shape, axis)
    axes = tuple(range(x.ndim)) if axis is None else (axis if isinstance(axis, tuple) else (axis,))
    return axis, axes


def _reduced_shape(gshape, axes, keepdims: bool):
    return tuple(1 if d in axes else s for d, s in enumerate(gshape) if keepdims or d not in axes)


def _reduced_split(split: Optional[int], axes, keepdims: bool) -> Optional[int]:
    """The split of a reduction's result: None where the split axis is
    reduced, else the split axis's place in the result."""
    if split is None or split in axes:
        return None
    return split if keepdims else split - sum(1 for a in axes if a < split)


def __reduce_op(
    x: DNDarray,
    partial_op: Callable,
    reduction: Optional[Callable],
    neutral,
    axis=None,
    keepdims: bool = False,
    out: Optional[DNDarray] = None,
) -> DNDarray:
    """Reduce ``x`` over ``axis`` (all axes when None): ``partial_op(tensor,
    dims, keepdim)`` on the masked chunk, then ``reduction`` (an in-place
    all-reduce such as ``comm.psum``) when the split axis is reduced.  On
    uint16, uint32 and uint64 both work on the holding tensors: the
    callers pass operations that give the type's own answer there."""
    if not isinstance(x, DNDarray):
        raise TypeError(f"expected x to be a DNDarray, but was {type(x)}")
    axis, axes = _axes(x, axis)
    split = x.split
    data = x._masked(neutral) if split in axes else x.larray_padded
    local = partial_op(data, axes, keepdims) if axes else data
    gshape = _reduced_shape(x.gshape, axes, keepdims)
    if split is not None and split in axes:
        local = reduction(local.contiguous())
    res = x._like(local, gshape, _reduced_split(split, axes, keepdims))
    return res if out is None else store_out(res, out)


def __cum_op(x: DNDarray, axis, scan: Callable, combine: Callable, neutral, out: Optional[DNDarray] = None,
             dtype=None, natural=None) -> DNDarray:
    """A scan along ``axis``: ``scan(tensor, axis)`` on each rank's chunk;
    along the split axis the padding is set to ``neutral`` first, then each
    rank combines (``combine(prefix, scanned)``) its scan with
    ``comm.exscan`` of the ranks' last slices before it.  The result is
    cast to the scan's ``natural`` type (an integer scan wraps in its own
    type), then to ``dtype``, as the reference casts after the scan.  On
    uint16, uint32 and uint64 the holding integers wrap in the holding
    dtype and the cast to ``natural`` reduces them to the type's width."""
    if not isinstance(x, DNDarray):
        raise TypeError(f"expected x to be a DNDarray, but was {type(x)}")
    axis = sanitize_axis(x.shape, axis)
    if axis is None:
        raise NotImplementedError("cumulative ops over flattened arrays: pass an int axis")
    if x.split == axis and x.larray_padded.shape[axis] and x.comm.size > 1:
        local = scan(x._masked(neutral), axis)
        last = local.narrow(axis, local.shape[axis] - 1, 1).contiguous()
        local = combine(x.comm.exscan(last, combine, neutral), local)
    else:
        local = scan(x.larray_padded, axis)
    res = x._like(local)
    if natural is not None:
        res = res.astype(natural, copy=False)
    if dtype is not None:
        res = res.astype(dtype, copy=False)
    if out is not None:
        return store_out(res, out)
    return res._propagate_layout_from(x)
