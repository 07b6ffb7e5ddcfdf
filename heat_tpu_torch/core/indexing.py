"""Indexing helpers (counterpart of heat_tpu/core/indexing.py)."""

from __future__ import annotations

import numpy as np
import torch

from . import types
from .dndarray import DNDarray, _runs_to_canonical

__all__ = ["nonzero", "where"]


def nonzero(x: DNDarray) -> DNDarray:
    """The indices of the non-zero elements, as an (nnz, ndim) int64 array
    (nnz for a 1-D input), split along rows when ``x`` is split.  Each rank
    finds its own elements and offsets them by its chunk's start; the rows
    move to the canonical layout in one exchange (a split other than 0 is
    first moved to rows as a bool mask, one byte an element)."""
    if not isinstance(x, DNDarray):
        raise TypeError(f"expected x to be a DNDarray, but was {type(x)}")
    from .logical import _truth

    mask = _truth(x)
    if mask.split not in (None, 0):
        mask = mask.resplit(0)
    local = torch.nonzero(mask.larray)
    if mask.split == 0:
        comm = mask.comm
        local[:, 0] += comm.chunk(mask.shape, 0)[0]
        counts = comm.all_gather(torch.tensor([local.shape[0]], dtype=torch.int64, device=local.device)).tolist()
        offsets = [sum(counts[:r]) for r in range(comm.size)]
        total = sum(counts)
        runs = list(zip(offsets, counts))
        local = _runs_to_canonical(comm, local, 0, runs, total)
        gshape = (total, x.ndim)
    else:
        gshape = tuple(local.shape)
    split = 0 if x.split is not None else None
    if x.ndim == 1:
        return x._like(local[:, 0].contiguous(), gshape[:1], split, types.int64)
    return x._like(local, gshape, split, types.int64)


def where(cond: DNDarray, x=None, y=None) -> DNDarray:
    """``x`` where ``cond`` holds, else ``y`` (their promoted type); with
    neither given, :func:`nonzero`.  Operands of ``cond``'s shape and split
    (or scalars) select on each rank's chunk; others meet on the dense
    arrays, as in the reference."""
    if x is None and y is None:
        return nonzero(cond)
    if x is None or y is None:
        raise TypeError("either both or neither of x and y must be given")
    if not isinstance(cond, DNDarray):
        raise TypeError(f"expected cond to be a DNDarray, but was {type(cond)}")
    rt = types.result_type(x, y)
    dev = cond.larray_padded.device

    def local(v, dense: bool):
        if isinstance(v, DNDarray):
            return types._cast(v._dense() if dense else v.larray_padded, v.dtype, rt)
        if rt in types._WIDENED:  # a python int as its unsigned type's holding value
            return torch.as_tensor(types._to_holding(np.asarray(v).astype(types.numpy_type(rt)), rt), device=dev)
        return torch.as_tensor(v, device=dev).to(rt.torch_type())

    aligned = all(not isinstance(v, DNDarray) or (v.shape == cond.shape and v.split == cond.split) for v in (x, y))
    truth = cond.larray_padded if cond.dtype is types.bool else cond.larray_padded != 0
    if aligned:
        out = torch.where(truth, local(x, False), local(y, False))
        return cond._like(torch.broadcast_to(out, truth.shape).contiguous(), cond.shape, cond.split, rt)
    cd = cond._dense()
    cd = cd if cd.dtype == torch.bool else cd != 0
    result = torch.where(cd, local(x, True), local(y, True))
    out_split = cond.split
    if out_split is not None and (result.ndim != cond.ndim or out_split >= result.ndim):
        out_split = 0 if result.ndim > 0 else None
    return DNDarray.from_dense(result, out_split, cond.device, cond.comm, rt)
