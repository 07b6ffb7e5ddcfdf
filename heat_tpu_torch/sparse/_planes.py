"""Padded COO planes of a distributed sparse matrix, one shard per rank
(counterpart of heat_tpu/sparse/_planes.py).

A matrix split along its compressed axis keeps, on each rank, its shard as
three planes:

    comp  : int32 (C,)  LOCAL compressed index within the rank's chunk
    other : int32 (C,)  GLOBAL uncompressed index
    val   : dtype (C,)  stored values

``C``, the capacity, is the largest per-rank nnz, so that every rank's
planes have one shape.  Padding entries carry ``comp == comp_pad`` (one past
the last row of a chunk) and ``val == 0``; the real entries come first,
sorted by ``(comp, other)``.  The per-rank counts ``lnnz`` are kept on the
host as a tuple of P ints, brought up to date after an op by one all-gather
of one int a rank (the reference's nnz re-sync).  A matrix with
``split=None`` holds the whole planes on every rank, as one shard.

Every op works on this rank's real entries.  Sorted runs are reduced by
:func:`segment_sum`, in one fixed order (``torch.segment_reduce`` for floats;
integers add exactly in any order), never by float atomics, so that every
result is bitwise repeatable on the card.  Products against a dense operand
go through the CSR SpMM kernel (csrc/csr_spmm.cu, :func:`csr_spmm`), whose
plain version runs in blocks of at most :data:`BLOCK_ELEMENTS` products, so
that no ``(nnz, n)`` intermediate is ever built.  Where the reference sorts by two
keys, the port sorts once, stably, by ``comp * extent + other`` in int64.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..parallel.comm import _as_bytes, _from_bytes

__all__ = []

#: products a block of an SpMM or a dense-times-sparse product may hold
BLOCK_ELEMENTS = 1 << 28


# ----------------------------------------------------------------------
# small helpers
# ----------------------------------------------------------------------
def nshards(dist: bool, comm) -> int:
    return comm.size if dist else 1


def comp_pad_of(extent: int, dist: bool, comm) -> int:
    """Rows (CSR) or columns (CSC) of a rank's chunk, padding included."""
    return comm.padded_extent(extent) // comm.size if dist else max(extent, 1)


def shard_index(dist: bool, comm) -> int:
    return comm.rank if dist else 0


def resync(n_local: int, dist: bool, comm, device) -> Tuple[int, ...]:
    """Every rank's count of real entries: one all-gather of one int a rank
    (the reference's nnz re-sync)."""
    if not dist or comm.size == 1:
        return (int(n_local),)
    got = comm.all_gather(torch.tensor([int(n_local)], dtype=torch.int64, device=device))
    return tuple(int(v) for v in got.tolist())


def pad_planes(comp, other, val, capacity: int, comp_pad: int):
    """This rank's real entries padded to ``capacity``: ``comp == comp_pad``,
    ``other == 0``, ``val == 0``."""
    n = comp.numel()
    if n == capacity:
        return comp.to(torch.int32).contiguous(), other.to(torch.int32).contiguous(), val.contiguous()
    pad = capacity - n
    dev = comp.device
    return (torch.cat([comp.to(torch.int32), torch.full((pad,), comp_pad, dtype=torch.int32, device=dev)]),
            torch.cat([other.to(torch.int32), torch.zeros(pad, dtype=torch.int32, device=dev)]),
            torch.cat([val, torch.zeros(pad, dtype=val.dtype, device=dev)]))


def finish(comp, other, val, dist: bool, comm, comp_pad: int):
    """This rank's real entries as padded planes after the count re-sync:
    ``(comp, other, val, lnnz, capacity)``."""
    lnnz = resync(comp.numel(), dist, comm, comp.device)
    capacity = max(max(lnnz), 1)
    return (*pad_planes(comp, other, val, capacity, comp_pad), lnnz, capacity)


def pair_key(comp: torch.Tensor, other: torch.Tensor, other_extent: int) -> torch.Tensor:
    """The int64 key ``comp * other_extent + other`` of (comp, other) order."""
    return comp.to(torch.int64) * max(int(other_extent), 1) + other.to(torch.int64)


def segment_sum(data: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Sums of consecutive runs of ``data`` along axis 0, run i of
    ``lengths[i]`` entries (0 for an empty run), each added in one fixed
    order: ``torch.segment_reduce`` for floats (a complex tensor as its real
    view), an index_add for integers and bool, whose sums are exact."""
    lengths = lengths.to(torch.int64)
    if data.is_complex():
        return torch.view_as_complex(segment_sum(torch.view_as_real(data), lengths).contiguous())
    if data.is_floating_point():
        if data.shape[0] == 0:
            return data.new_zeros((lengths.numel(),) + tuple(data.shape[1:]))
        return torch.segment_reduce(data, "sum", lengths=lengths, axis=0, unsafe=True)
    ids = torch.repeat_interleave(torch.arange(lengths.numel(), device=data.device), lengths)
    acc = torch.int64 if data.dtype == torch.bool else data.dtype
    out = torch.zeros((lengths.numel(),) + tuple(data.shape[1:]), dtype=acc, device=data.device)
    return out.index_add_(0, ids, data.to(acc)).to(data.dtype)


#: value types the CSR SpMM kernel (csrc/csr_spmm.cu) takes, by its entry points' suffixes: every
#: type the port stores
CSR_SPMM_TYPES = {torch.float16: "f16", torch.bfloat16: "bf16", torch.float32: "f32", torch.float64: "f64",
                  torch.complex64: "c64", torch.complex128: "c128", torch.int8: "i8", torch.uint8: "u8",
                  torch.int16: "i16", torch.int32: "i32", torch.int64: "i64", torch.bool: "b8"}
#: launches of the CSR SpMM kernel
CSR_SPMM_LAUNCHES = 0
_CSR_LIB = None


def segment_rows(seg, weight, index, rows, n_seg: int, dtype, out=None) -> torch.Tensor:
    """``out[s] += sum over entries e with seg[e] == s of weight[e] *
    rows[index[e]]`` (a new ``out`` of zeros if none is given), for segment
    ids ``seg`` sorted ascending: the entries are a CSR matrix over the
    planes and the product is :func:`csr_spmm`'s."""
    ptr = torch.searchsorted(seg, torch.arange(n_seg + 1, dtype=seg.dtype, device=seg.device))
    return csr_spmm(ptr, index.to(torch.int32), weight.to(dtype), rows.to(dtype).contiguous(), out)


def csr_spmm(ptr: torch.Tensor, col: torch.Tensor, w: torch.Tensor, x: torch.Tensor, out=None) -> torch.Tensor:
    """``out += A @ x`` (``A @ x`` when ``out`` is None) for the CSR matrix
    ``A`` of row pointers ``ptr`` (int64, rows + 1, from 0), column indices
    ``col`` (int32) and values ``w`` (x's type); ``x`` (k, width) and
    ``out`` (rows, width) with unit column stride.  Each row's products are
    added in one fixed order.  A CPU tensor runs the plain version; a CUDA
    tensor runs the kernel (csrc/csr_spmm.cu, every type of
    :data:`CSR_SPMM_TYPES`) or raises."""
    global CSR_SPMM_LAUNCHES
    n_rows = ptr.numel() - 1
    if x.ndim != 2 or ptr.ndim != 1 or n_rows < 0 or col.shape != w.shape or col.ndim != 1:
        raise ValueError(f"csr_spmm: ptr {tuple(ptr.shape)}, col {tuple(col.shape)}, w {tuple(w.shape)}, "
                         f"x {tuple(x.shape)}")
    if ptr.dtype != torch.int64 or col.dtype != torch.int32 or w.dtype != x.dtype:
        raise TypeError(f"csr_spmm takes int64 pointers, int32 columns and values of x's type, got {ptr.dtype}, "
                        f"{col.dtype}, {w.dtype} and {x.dtype}")
    if out is not None and (tuple(out.shape) != (n_rows, x.shape[1]) or out.dtype != x.dtype):
        raise ValueError(f"csr_spmm: out {tuple(out.shape)} {out.dtype} for {n_rows} rows of {x.shape[1]} {x.dtype}")
    if x.device.type == "cpu":
        if out is None:
            out = torch.zeros((n_rows, x.shape[1]), dtype=x.dtype)
        return _csr_spmm_plain(ptr, col, w, x, out)
    if x.device.type != "cuda":
        raise ValueError(f"no CSR SpMM kernel for device {x.device}")
    if x.dtype not in CSR_SPMM_TYPES:
        raise TypeError(f"the CSR SpMM kernel takes {sorted(str(t) for t in CSR_SPMM_TYPES)}, got {x.dtype}")
    if x.stride(1) != 1 or (out is not None and out.stride(1) != 1):
        raise ValueError("the CSR SpMM kernel needs x and out with unit column stride")
    if not (ptr.is_contiguous() and col.is_contiguous() and w.is_contiguous()):
        raise ValueError("the CSR SpMM kernel needs contiguous ptr, col and w")
    if any(t.device != x.device for t in (ptr, col, w)) or (out is not None and out.device != x.device):
        raise ValueError("csr_spmm: every operand on one card")
    accumulate = out is not None
    if out is None:
        out = torch.empty((n_rows, x.shape[1]), dtype=x.dtype, device=x.device)
    fn = getattr(_csr_lib(), "heat_csr_spmm_" + CSR_SPMM_TYPES[x.dtype])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(ptr.data_ptr(), col.data_ptr(), w.data_ptr(), x.data_ptr(), x.stride(0), out.data_ptr(),
                 out.stride(0), n_rows, x.shape[1], int(accumulate), stream)
    if err != 0:
        raise RuntimeError(f"CSR SpMM kernel launch failed: CUDA error {err}")
    CSR_SPMM_LAUNCHES += 1
    return out


def _csr_lib():
    global _CSR_LIB
    if _CSR_LIB is None:
        import ctypes

        from ..core import _build

        lib = _build.load("csr_spmm")
        for suffix in CSR_SPMM_TYPES.values():
            fn = getattr(lib, "heat_csr_spmm_" + suffix)
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64, ctypes.c_void_p] + [ctypes.c_int64] * 3 + \
                [ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        _CSR_LIB = lib
    return _CSR_LIB


def _csr_spmm_plain(ptr, col, w, x, out) -> torch.Tensor:
    """The plain version of :func:`csr_spmm`, into ``out``: the product rows
    of each block of at most :data:`BLOCK_ELEMENTS` values are made and each
    row's run summed (:func:`segment_sum`), block after block."""
    n = int(ptr[-1])
    step = max(1, BLOCK_ELEMENTS // max(x.shape[1], 1))
    for lo in range(0, n, step):
        hi = min(n, lo + step)
        first, last = (torch.searchsorted(ptr, torch.tensor([lo, hi - 1], device=ptr.device), right=True) - 1).tolist()
        lengths = torch.diff(ptr[first:last + 2].clamp(lo, hi))
        prod = w[lo:hi, None] * x[col[lo:hi].to(torch.int64)]
        out[first:last + 1] += segment_sum(prod, lengths)
    return out


def order_by(keys: torch.Tensor) -> torch.Tensor:
    """The stable permutation sorting ``keys`` ascending."""
    return torch.sort(keys, stable=True).indices


# ----------------------------------------------------------------------
# construction
# ----------------------------------------------------------------------
def build_from_coo(rows, cols, vals, gshape, comp_axis: int, split, comm, device, drop_zeros: bool = False):
    """Padded planes of this rank from global COO triplets (torch tensors
    on any device; the work runs where they lie): sorted by (comp, other),
    duplicates summed in their order, cut at the canonical chunks.  With
    ``drop_zeros``, entries that sum to zero are dropped, as a dense
    round trip would drop them.  Returns
    ``(comp, other, val, lnnz, capacity, comp_pad)`` on ``device``."""
    comp_g, other = (rows, cols) if comp_axis == 0 else (cols, rows)
    comp_g, other = comp_g.to(torch.int64), other.to(torch.int64)
    other_extent = gshape[1 - comp_axis]
    key = comp_g * max(other_extent, 1) + other
    perm = order_by(key)
    key, vals = key[perm], vals[perm]
    if key.numel():
        head = torch.ones(key.numel(), dtype=torch.bool, device=key.device)
        head[1:] = key[1:] != key[:-1]
        if not bool(head.all()):
            lengths = torch.diff(torch.nonzero(head)[:, 0], append=torch.tensor([key.numel()], device=key.device))
            vals = segment_sum(vals, lengths)
            key = key[head]
    if drop_zeros:
        nz = vals != 0
        key, vals = key[nz], vals[nz]
    comp_g, other = key // max(other_extent, 1), key % max(other_extent, 1)

    extent = gshape[comp_axis]
    dist = split is not None
    P = nshards(dist, comm)
    comp_pad = comp_pad_of(extent, dist, comm)
    starts = torch.tensor([min(s * comp_pad, extent) for s in range(P)] + [extent], dtype=torch.int64,
                          device=comp_g.device)
    bounds = torch.searchsorted(comp_g, starts).tolist()
    lnnz = tuple(int(bounds[s + 1] - bounds[s]) for s in range(P))
    capacity = max(max(lnnz), 1)
    s = shard_index(dist, comm)
    lo, hi = bounds[s], bounds[s + 1]
    comp, other, val = pad_planes(comp_g[lo:hi] - min(s * comp_pad, extent), other[lo:hi], vals[lo:hi], capacity,
                                  comp_pad)
    dev = device.torch_device
    return comp.to(dev), other.to(dev), val.to(dev), lnnz, capacity, comp_pad


def pack_from_dense(block: torch.Tensor, gshape, comp_axis: int, split, comm):
    """This rank's planes from its dense block (``to_sparse``): the block's
    padded rows (CSR, split 0) or columns (CSC, split 1) must be zero, or the
    whole matrix when unsplit.  Returns
    ``(comp, other, val, lnnz, capacity, comp_pad)``."""
    dist = split is not None
    comp_pad = comp_pad_of(gshape[comp_axis], dist, comm)
    if comp_axis == 1:
        flat, div = block.T.reshape(-1), block.shape[0]  # comp = f // m, other = f % m
    else:
        flat, div = block.reshape(-1), block.shape[1]  # comp = f // n, other = f % n
    pos = torch.nonzero(flat != 0)[:, 0]
    comp, other, val = pos // max(div, 1), pos % max(div, 1), flat[pos]
    comp, other, val, lnnz, capacity = finish(comp, other, val, dist, comm, comp_pad)
    return comp, other, val, lnnz, capacity, comp_pad


# ----------------------------------------------------------------------
# accessors
# ----------------------------------------------------------------------
def lindptr(comp: torch.Tensor, comp_pad: int) -> torch.Tensor:
    """This rank's local indptr, ``comp_pad + 1`` int64 pointers."""
    return torch.searchsorted(comp, torch.arange(comp_pad + 1, dtype=comp.dtype, device=comp.device)).to(torch.int64)


def global_indptr(comp, lnnz, comp_pad: int, extent: int, dist: bool, comm) -> torch.Tensor:
    """The global indptr on every rank: each rank's local pointers shifted
    by the nnz of the ranks before it, gathered (``extent + 1`` int64)."""
    s = shard_index(dist, comm)
    local = lindptr(comp, comp_pad)[:comp_pad] + sum(lnnz[:s])
    if dist:
        local = comm.all_gather(local)
    total = torch.tensor([sum(lnnz)], dtype=torch.int64, device=comp.device)
    return torch.cat([local[:extent], total])


def gather_real(x: torch.Tensor, lnnz, dist: bool, comm) -> torch.Tensor:
    """Every rank's real entries of the plane ``x``, in rank order (the
    whole real prefix where unsplit)."""
    s = shard_index(dist, comm)
    mine = x[:lnnz[s]]
    if not dist or comm.size == 1:
        return mine
    parts = comm.all_gather_varying(_as_bytes(mine), lnnz, 0)
    return _from_bytes(torch.cat(parts), x.dtype)


# ----------------------------------------------------------------------
# re-split (None <-> compressed axis)
# ----------------------------------------------------------------------
def rechunk_planes(comp, other, val, lnnz, extent: int, to_dist: bool, comp_pad: int, comm):
    """Planes re-split between whole on every rank (split None) and cut at
    the canonical chunks (split = compressed axis).  None -> split keeps
    this rank's part of the whole planes (no collective); split -> None
    gathers every rank's real entries.  Returns
    ``(comp, other, val, lnnz, capacity, comp_pad)``."""
    if to_dist:
        chunk = comp_pad_of(extent, True, comm)
        n = lnnz[0]
        starts = torch.tensor([min(s * chunk, extent) for s in range(comm.size + 1)], dtype=comp.dtype,
                              device=comp.device)
        bounds = torch.searchsorted(comp[:n], starts).tolist()
        counts = tuple(int(bounds[s + 1] - bounds[s]) for s in range(comm.size))
        capacity = max(max(counts), 1)
        lo, hi = bounds[comm.rank], bounds[comm.rank + 1]
        c, o, v = pad_planes(comp[lo:hi] - comm.rank * chunk, other[lo:hi], val[lo:hi], capacity, chunk)
        return c, o, v, counts, capacity, chunk
    s = comm.rank
    comp_g = gather_real((comp[:lnnz[s]].to(torch.int64) + s * comp_pad).to(torch.int32), lnnz, True, comm)
    gnnz = sum(lnnz)
    new_pad = max(extent, 1)
    c, o, v = pad_planes(comp_g, gather_real(other, lnnz, True, comm), gather_real(val, lnnz, True, comm),
                         max(gnnz, 1), new_pad)
    return c, o, v, (gnnz,), max(gnnz, 1), new_pad


# ----------------------------------------------------------------------
# element-wise union / intersection
# ----------------------------------------------------------------------
def merge_planes(kind: str, a, b, n_a: int, n_b: int, other_extent: int, comp_pad: int, dist: bool, comm):
    """Union-add (``kind == "add"``) or intersect-mul (``"mul"``) of two
    matrices of one layout, on each rank's real entries: the two sorted key
    runs are merged by position (searchsorted, no sort), equal neighbours
    combined, and the result compacted; then the count re-sync.  A pair
    present in both is kept, whatever its value (``a + (-a)`` stays a
    stored 0).  Returns ``(comp, other, val, lnnz, capacity)``."""
    ca, oa, va = (p[:n_a] for p in a)
    cb, ob, vb = (p[:n_b] for p in b)
    ka, kb = pair_key(ca, oa, other_extent), pair_key(cb, ob, other_extent)
    dev = ka.device
    pos_a = torch.arange(n_a, device=dev) + torch.searchsorted(kb, ka)
    pos_b = torch.arange(n_b, device=dev) + torch.searchsorted(ka, kb, right=True)
    n = n_a + n_b
    key = torch.empty(n, dtype=torch.int64, device=dev)
    val = torch.empty(n, dtype=va.dtype, device=dev)
    key[pos_a], key[pos_b] = ka, kb
    val[pos_a], val[pos_b] = va, vb
    same = key[1:] == key[:-1]
    no = torch.zeros(1, dtype=torch.bool, device=dev)
    first, second = torch.cat([same, no]), torch.cat([no, same])
    nxt = torch.cat([val[1:], val.new_zeros(1)])
    if kind == "add":
        val = torch.where(first, val + nxt, val)
        keep = ~second
    else:
        val = val * nxt
        keep = first
    idx = torch.nonzero(keep)[:, 0]
    key, val = key[idx], val[idx]
    ext = max(int(other_extent), 1)
    return finish(key // ext, key % ext, val, dist, comm, comp_pad)


# ----------------------------------------------------------------------
# dense conversion
# ----------------------------------------------------------------------
def todense_padded(comp, other, val, n: int, comp_axis: int, comp_pad: int, other_extent: int) -> torch.Tensor:
    """This rank's padded dense chunk: (comp_pad, other_extent) rows of a
    CSR matrix, (other_extent, comp_pad) columns of a CSC one.  Each stored
    value is written once (keys are unique), as ``0 + v``."""
    shape = (comp_pad, other_extent) if comp_axis == 0 else (other_extent, comp_pad)
    out = torch.zeros(shape, dtype=val.dtype, device=val.device)
    c, o = comp[:n].to(torch.int64), other[:n].to(torch.int64)
    idx = (c, o) if comp_axis == 0 else (o, c)
    out[idx] = val[:n] + torch.zeros((), dtype=val.dtype, device=val.device)
    return out


# ----------------------------------------------------------------------
# reductions
# ----------------------------------------------------------------------
def sum_comp(comp, other, val, n: int, comp_pad: int, other_extent: int) -> torch.Tensor:
    """Per-compressed-index sums of this rank's chunk, (comp_pad,): the
    chunk's product with a column of ones (each value times 1, exactly)."""
    ones = torch.ones((max(other_extent, 1), 1), dtype=val.dtype, device=val.device)
    return segment_rows(comp[:n], val[:n], other[:n], ones, comp_pad, val.dtype)[:, 0]


def by_other(other, n: int) -> torch.Tensor:
    """The stable permutation of this rank's real entries by ``other``."""
    return order_by(other[:n])


def sum_other(other, val, n: int, other_pad: int, perm, dist: bool, comm) -> torch.Tensor:
    """Per-uncompressed-index sums over every rank: each rank's sums over
    ``other_pad`` indices meet in one reduce-scatter, and each rank keeps
    its chunk (``other_pad / P``); ``perm`` is :func:`by_other`'s."""
    o = other[:n][perm]
    part = segment_sum(val[:n][perm], torch.diff(torch.searchsorted(
        o, torch.arange(other_pad + 1, dtype=o.dtype, device=o.device))))
    return comm.psum_scatter(part) if dist else part


# ----------------------------------------------------------------------
# SpMM
# ----------------------------------------------------------------------
def spmm_rows(comp, other, val, n: int, comp_pad: int, x: torch.Tensor, dtype) -> torch.Tensor:
    """(CSR) this rank's output rows of ``A @ X`` with X whole on the rank:
    (comp_pad, n_cols)."""
    return segment_rows(comp[:n], val[:n], other[:n], x, comp_pad, dtype)


def spmm_rows_ring(comp, other, val, n: int, comp_pad: int, x_loc: torch.Tensor, dtype, comm) -> torch.Tensor:
    """(CSR, split 0) ``A @ X`` with X split 0: X's row chunks ride a
    ppermute ring, P - 1 sends, so that no rank holds more than one chunk of
    X.  At step t a rank holds the chunk of rank (rank + t) % P, and adds
    the products of its entries whose column falls in that chunk (picked in
    their order, so each row's run stays sorted)."""
    P, me = comm.size, comm.rank
    if P == 1:
        return spmm_rows(comp, other, val, n, comp_pad, x_loc, dtype)
    chunk = x_loc.shape[0]
    o = other[:n].to(torch.int64)
    owner_of = o // max(chunk, 1)
    acc = torch.zeros((comp_pad, x_loc.shape[1]), dtype=dtype, device=x_loc.device)
    xc = x_loc
    for t in range(P):
        owner = (me + t) % P
        g = torch.nonzero(owner_of == owner)[:, 0]
        if g.numel():
            segment_rows(comp[g], val[g], o[g] - owner * chunk, xc, comp_pad, dtype, out=acc)
        if t < P - 1:
            xc = comm.ppermute(xc, [(i, (i - 1) % P) for i in range(P)])
    return acc


def spmm_inner(comp, other, val, n: int, perm, m_pad: int, x: torch.Tensor, dtype, dist: bool, comm) -> torch.Tensor:
    """(CSC) ``A @ X`` where a rank's columns are the rows of X it holds:
    no gather of X; each rank's partial (m_pad, n_cols) product, summed by
    output row over the entries sorted by row (``perm``), meets the others
    in one reduce-scatter."""
    part = segment_rows(other[:n][perm], val[:n][perm], comp[:n][perm], x, m_pad, dtype)
    return comm.psum_scatter(part) if dist else part


def dense_times_rows(comp, other, val, n: int, perm, e_t: torch.Tensor, offset: int, n_out: int, dtype,
                     dist: bool, comm) -> torch.Tensor:
    """(CSR) ``E @ A``: the rank's rows of A meet E's matching columns
    (``e_t`` is E transposed, the rows ``offset + comp``), summed by
    output column over the entries sorted by column (``perm``), then one
    all-reduce: (q, n_out) on every rank."""
    idx = comp[:n][perm].to(torch.int64) + offset
    out = segment_rows(other[:n][perm], val[:n][perm], idx, e_t, n_out, dtype).T.contiguous()
    return comm.psum(out) if dist else out


def dense_times_cols(comp, other, val, n: int, comp_pad: int, e_t: torch.Tensor, dtype) -> torch.Tensor:
    """(CSC) ``E @ A``: the rank's own output columns, no collective:
    (q, comp_pad)."""
    return segment_rows(comp[:n], val[:n], other[:n], e_t, comp_pad, dtype).T.contiguous()


# ----------------------------------------------------------------------
# SpGEMM: sparse @ sparse -> sparse, output-sparse triplet ring
# ----------------------------------------------------------------------
def spgemm_step(ac, ao, av, bc, bo, bv, n_b: int, owner: int, chunk_b: int, n_out: int, dtype):
    """One ring step: every entry (i, j, v) of A whose column j falls in the
    resident B chunk (rows of ``owner``) expands to the products v * B[j, :]
    (one per stored entry of B's row j), which are then canonicalized: a
    stable sort by (row, column) and the sum of each run.  Every run is
    kept, whatever its sum.  Returns this rank's (comp, other, val)."""
    rel = ao.to(torch.int64) - owner * chunk_b
    hit = torch.nonzero((rel >= 0) & (rel < chunk_b))[:, 0]
    dev = ac.device
    if hit.numel() == 0 or n_b == 0:
        empty = torch.zeros(0, dtype=torch.int64, device=dev)
        return empty, empty, torch.zeros(0, dtype=dtype, device=dev)
    rel = rel[hit]
    starts = lindptr(bc[:n_b], chunk_b)
    first = starts[rel]
    counts = starts[rel + 1] - first
    total = int(counts.sum())
    a_idx = torch.repeat_interleave(torch.arange(hit.numel(), device=dev), counts)
    b_pos = first[a_idx] + torch.arange(total, device=dev) - (torch.cumsum(counts, 0) - counts)[a_idx]
    a_sel = hit[a_idx]
    key = pair_key(ac[a_sel], bo[b_pos], n_out)
    val = av[a_sel].to(dtype) * bv[b_pos].to(dtype)
    del a_idx
    key, perm = torch.sort(key, stable=True)
    val = val[perm]
    del perm
    head = torch.ones(total, dtype=torch.bool, device=dev)
    head[1:] = key[1:] != key[:-1]
    starts = torch.nonzero(head)[:, 0]
    val = segment_sum(val, torch.diff(starts, append=torch.tensor([total], device=dev)))
    key = key[starts]
    ext = max(int(n_out), 1)
    return key // ext, key % ext, val


def spgemm_planes(a, n_a: int, b, lnnz_b, chunk_b: int, comp_pad_a: int, n_out: int, dtype, dist: bool, comm):
    """The output-sparse SpGEMM: P ring steps; each step's canonical
    partial products go through the count re-sync and fold into the
    accumulator by :func:`merge_planes` ("add"); B's planes then move one
    rank along the ring (P - 1 sends).  Nothing dense is built.  Returns
    ``(comp, other, val, lnnz, capacity)``."""
    from ..resilience.faults import inject

    P = nshards(dist, comm)
    me = shard_index(dist, comm)
    ac, ao, av = (p[:n_a] for p in a)
    bc, bo, bv = b
    acc = None
    for t in range(P):
        owner = (me + t) % P
        pc, po, pv = spgemm_step(ac, ao, av, bc, bo, bv, lnnz_b[owner], owner, chunk_b, n_out, dtype)
        # the step's count re-sync is the ring's one collective choke
        # point, so the comm.collective fault site fires here, as the
        # reference's does; the loop holds no state of its operands, so a
        # failed step aborts the product cleanly and a retry recomputes it
        inject("comm.collective", op="spgemm.nnz_resync", step=t)
        part = finish(pc, po, pv, dist, comm, comp_pad_a)
        if acc is None:
            acc = part
        else:
            acc = merge_planes("add", acc[:3], part[:3], acc[3][me], part[3][me], n_out, comp_pad_a, dist, comm)
        if t < P - 1:
            ring = [(i, (i - 1) % P) for i in range(P)]
            bc, bo = comm.ppermute(bc, ring), comm.ppermute(bo, ring)
            bv = _from_bytes(comm.ppermute(_as_bytes(bv), ring), bv.dtype)
    return acc


# ----------------------------------------------------------------------
# triplet-preserving re-compression (CSR <-> CSC, never dense)
# ----------------------------------------------------------------------
def recompress_planes(comp_g, other, val, n: int, extent_old: int, extent_new: int):
    """Whole planes sorted by the old compressed axis, re-keyed and sorted
    stably by the other one; padded to ``max(n, 1)`` with the new axis'
    sentinel ``max(extent_new, 1)``."""
    key = pair_key(other[:n], comp_g[:n], extent_old)
    perm = order_by(key)
    return pad_planes(other[:n][perm], comp_g[:n][perm], val[:n][perm], max(n, 1), max(extent_new, 1))

