"""The distributed sample sort (PSRS) on ``torch.distributed`` (counterpart
of heat_tpu/core/sample_sort.py).

Parallel sorting by regular sampling, as the reference's ``_psrs_fn``:

1. each rank sorts its own rows of every column by (key, global index),
   stably (the keys of :mod:`._keys`: signed integers in the sort's order);
2. p regular samples of each rank go out in one all-gather of p^2 (key,
   index) pairs a column, and every rank picks the same p - 1 pivots;
3. the pivots cut each rank's sorted rows into p buckets, and one
   ``all_to_all_varying`` sends bucket d to rank d, keys and global indices
   with each element;
4. each rank sorts what it received by (column, key, global index);
5. an exclusive scan of the columns' counts over the ranks gives each
   element its exact global rank, and a second ``all_to_all_varying``
   sends it to the rank that owns that rank in the canonical pad-and-mask
   layout;
6. the keys unpack to values.

The (key, global index) pairs are distinct, so the result is the stable
sort's, whatever the pivots: values and int64 indices split along the sort
axis, trailing dimensions sorted as independent columns.  Nothing is
gathered but the samples.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..parallel.comm import _as_bytes, _from_bytes
from . import _keys, types
from .dndarray import DNDarray

__all__ = [
    "sample_sort_1d",
    "sample_sort_along",
    "select_global_ranks",
    "supports_sample_sort",
    "SAMPLE_SORT_THRESHOLD",
]

#: Global extent along the sort axis from which ``sort`` takes the sample
#: sort (the reference's gate; tests lower it).
SAMPLE_SORT_THRESHOLD = 1 << 17

_KEY32 = ("float32", "int32", "uint32", "float16", "bfloat16")
_KEY64 = ("float64", "int64", "uint64")
_TOP = torch.iinfo(torch.int64).max


def supports_sample_sort(a, axis: int, descending: bool) -> bool:
    """Whether ``sort`` takes the sample sort for this call (the reference's
    gate): the sort axis is the split axis of more than one rank, its extent
    at least ``SAMPLE_SORT_THRESHOLD`` (read at call time) and below the
    key's index range, and the type one of 32 or 64 bits."""
    name = a.dtype.__name__
    if a.split is None or a.split != axis or a.comm.size <= 1:
        return False
    n = a.shape[axis]
    if n < SAMPLE_SORT_THRESHOLD:
        return False
    if name in _KEY32:
        return n < (1 << 31)
    if name in _KEY64:
        return n < (1 << 62)
    return False


def _lex_less(a: List[torch.Tensor], b: List[torch.Tensor]) -> torch.Tensor:
    """Where the tuple ``a`` is below ``b`` lexicographically (broadcasting)."""
    less, equal = None, None
    for x, y in zip(a, b):
        lt = x < y if equal is None else equal & (x < y)
        less = lt if less is None else less | lt
        equal = x == y if equal is None else equal & (x == y)
    return less


def _exchange(comm, rows: torch.Tensor, dest: torch.Tensor) -> torch.Tensor:
    """Send each row of ``rows`` (n, w) to the rank ``dest`` names, by one
    exchange of the counts and one of the rows; the rows received, in rank
    order (a rank's in the order it holds them)."""
    p = comm.size
    order = torch.sort(dest, stable=True).indices
    rows, dest = rows[order], dest[order]
    counts = torch.bincount(dest, minlength=p)
    recv = comm.all_to_all(counts.reshape(p, 1), 0, 0).reshape(p).tolist() if p > 1 else counts.tolist()
    blocks = list(torch.split(rows, counts.tolist(), dim=0))
    return torch.cat(comm.all_to_all_varying(blocks, recv, 0), dim=0)


def _psrs(comm, keys: List[torch.Tensor], payload: Optional[List[torch.Tensor]], m: int, b: int):
    """The sample sort of this rank's rows: ``keys`` and ``payload`` are
    int64 (b, C) tensors of its padded chunk (rows of global index r * b + i,
    those at or past ``m`` padding).  Returns this rank's (b, C) chunk of
    the sorted payload columns (the keys where ``payload`` is None) and of
    the global indices (0 in padding)."""
    p, r = comm.size, comm.rank
    dev = keys[0].device
    cols = keys[0].shape[1]
    nv = max(0, min(b, m - r * b))
    keys = [k[:nv] for k in keys]
    payload = [q[:nv] for q in payload] if payload is not None else []
    gid = torch.arange(r * b, r * b + nv, dtype=torch.int64, device=dev)[:, None].expand(nv, cols)

    # 1. local stable sort of every column (the indices ascend already)
    perm = _keys.lex_sort(keys)
    keys = [k.gather(0, perm) for k in keys]
    payload = [q.gather(0, perm) for q in payload]
    gid = gid.gather(0, perm)

    # 2. p regular samples of each rank, gathered; the same pivots everywhere
    nk = len(keys)
    samples = torch.full((p, cols, nk + 1), _TOP, dtype=torch.int64, device=dev)
    if nv:
        pos = ((torch.arange(p, device=dev) + 1) * nv) // (p + 1)
        samples = torch.stack([k[pos] for k in keys] + [gid[pos]], dim=-1)
    every = comm.all_gather(samples.contiguous(), axis=0)  # (p * p, cols, nk + 1)
    order = _keys.lex_sort([every[..., j] for j in range(nk + 1)])
    every = every.gather(0, order[..., None].expand_as(every))
    pivots = every[(torch.arange(p - 1, device=dev) + 1) * p]  # (p - 1, cols, nk + 1)

    # 3. buckets: the number of pivots below each element; one exchange
    bucket = torch.zeros((nv, cols), dtype=torch.int64, device=dev)
    mine = keys + [gid]
    for j in range(p - 1):
        bucket += _lex_less([pivots[j, :, i] for i in range(nk + 1)], mine).to(torch.int64)
    col = torch.arange(cols, dtype=torch.int64, device=dev)[None, :].expand(nv, cols)
    packed = torch.stack([col, gid] + keys + payload, dim=-1).reshape(nv * cols, -1)
    got = _exchange(comm, packed, bucket.reshape(-1))

    # 4. sort what arrived by (column, key, global index)
    got = got[_keys.lex_sort([got[:, 0]] + [got[:, 2 + i] for i in range(nk)] + [got[:, 1]])]

    # 5. exact global ranks from the columns' counts, one exchange to the owners
    counts = torch.bincount(got[:, 0], minlength=cols)
    offset = comm.exscan(counts)
    start = torch.cumsum(counts, 0) - counts
    n = got.shape[0]
    rank = offset[got[:, 0]] + torch.arange(n, dtype=torch.int64, device=dev) - start[got[:, 0]]
    flat = (rank % b) * cols + got[:, 0]
    carried = got[:, 2 + nk:] if payload else got[:, 2:2 + nk]
    final = _exchange(comm, torch.cat([flat[:, None], got[:, 1:2], carried], dim=1), rank // b)

    # 6. this rank's chunk, padding rows left at 0
    out = torch.zeros((final.shape[1] - 1, b * cols), dtype=torch.int64, device=dev)
    out[:, final[:, 0]] = final[:, 1:].T
    return [q.reshape(b, cols) for q in out[1:]], out[0].reshape(b, cols)


def _sort_chunk(a: DNDarray, chunk: torch.Tensor, descending: bool, merge_zeros: bool):
    """This rank's chunk (b, ...) of ``a`` (split along the chunk's first
    axis) sorted along that axis across the ranks: ``(values, global
    indices)`` of the chunk's shape.  ``merge_zeros`` sorts as a stable
    argsort does (-0.0 equal to +0.0, float values carried as bits beside
    the keys); otherwise -0.0 sorts first and the values unpack from the
    keys, as the reference's sample sort's do."""
    b = chunk.shape[0]
    flat = chunk.reshape(b, -1)
    keys = _keys.sort_keys(flat, descending, merge_zeros, a.dtype is types.uint64)
    parts = [flat.real, flat.imag] if flat.is_complex() else [flat]
    carried = merge_zeros and parts[0].is_floating_point()
    payload = [t.view(_keys._KEY_TYPES[t.dtype]).to(torch.int64) for t in parts] if carried else None
    got, gids = _psrs(a.comm, keys, payload, a.shape[a.split], b)
    if carried:
        back = [q.to(_keys._KEY_TYPES[t.dtype]).view(t.dtype) for q, t in zip(got, parts)]
    else:
        back = [torch.bitwise_not(q) if descending else q for q in got]
        if parts[0].is_floating_point():
            back = [_keys._from_ordered(q, t.dtype) for q, t in zip(back, parts)]
        elif a.dtype is types.uint64:
            back = [_keys.unsigned_keys(back[0])]
        else:
            back = [back[0].to(flat.dtype)]
    values = torch.complex(*back) if flat.is_complex() else back[0]
    return values.reshape(chunk.shape), gids.reshape(chunk.shape)


def _sorted_along(a: DNDarray, axis: int, descending: bool, merge_zeros: bool) -> Tuple[DNDarray, DNDarray]:
    """``(values, indices)`` of ``a`` sorted along its split axis ``axis``
    across the ranks, split along ``axis`` in the canonical layout."""
    v, g = _sort_chunk(a, a.larray_padded.movedim(axis, 0), descending, merge_zeros)
    values = a._like(v.movedim(0, axis).contiguous(), dtype=a.dtype)
    indices = a._like(g.movedim(0, axis).contiguous(), dtype=types.int64)
    return values, indices


def sample_sort_1d(a: DNDarray, descending: bool = False) -> Tuple[DNDarray, DNDarray]:
    """Sort a split-0 DNDarray along axis 0 by the sample sort; trailing
    dimensions are independent columns.  ``(values, int64 indices)``, both
    split along axis 0: nothing is gathered."""
    return _sorted_along(a, 0, descending, merge_zeros=False)


def sample_sort_along(a: DNDarray, axis: int, descending: bool = False) -> Tuple[DNDarray, DNDarray]:
    """The sample sort along the split axis ``axis``: each rank moves the
    axis to the front of its chunk (no communication), sorts, and moves it
    back.  The indices are positions along ``axis``, argsort's."""
    return _sorted_along(a, axis, descending, merge_zeros=False)


def _select_rows(comm, chunk: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """The rows at global ``positions`` of an array split along the first
    axis of this rank's padded ``chunk`` (b, ...), on every rank: each rank
    offers the rows it owns, and one all-gather of len(positions) rows a
    rank lets every rank pick each from its owner."""
    b = chunk.shape[0]
    local = positions - comm.rank * b
    owned = (local >= 0) & (local < b)
    if b:
        mine = chunk[local.clamp(0, b - 1)]
    else:
        mine = chunk.new_zeros((positions.numel(),) + tuple(chunk.shape[1:]))
    mine = torch.where(owned.reshape((-1,) + (1,) * (chunk.ndim - 1)), mine, torch.zeros_like(mine))
    every = _from_bytes(comm.all_gather(_as_bytes(mine)[None].contiguous(), axis=0), chunk.dtype)
    owner = torch.div(positions, max(b, 1), rounding_mode="floor")
    return every[owner, torch.arange(positions.numel(), device=chunk.device)]


def select_global_ranks(values: DNDarray, positions) -> torch.Tensor:
    """The values at global ``positions`` of a 1-D split-0 DNDarray, on
    every rank (:func:`_select_rows`): traffic O(len(positions)), never the
    array."""
    blk = values.larray_padded
    pos = torch.as_tensor(np.asarray(positions, dtype=np.int64), device=blk.device)
    return _select_rows(values.comm, blk, pos)
