"""Flash attention, forward and backward: the hand-written CUDA kernels and
their plain PyTorch versions.

The counterpart of JAX's packaged TPU kernel
``jax.experimental.pallas.ops.tpu.flash_attention`` as
``heat_tpu/nn/attention.py::_local_flash`` calls it: full-sequence attention
over (s, h, d) tensors in which a query attends a key iff both lie before
``n_true`` or both at or after it (the segment ids that isolate the padded
tail) and, under ``causal``, the key is not after the query.

:func:`flash_attention` launches ``csrc/flash_attn.cu`` for a CUDA tensor,
or raises with the reason the kernel cannot take it; for a CPU tensor, and
only there, it runs :func:`_flash_plain`.  Where a gradient is wanted it
goes through :class:`_FlashAttention`, the counterpart of JAX's
``_flash_attention`` ``custom_vjp``: the forward also keeps each row's
log-sum-exp (one float32 per query and head, where JAX keeps ``l`` and
``m``), and the backward runs the passes of ``csrc/flash_attn_bwd.cu`` in
JAX's order -- ``di = rowsum(o * do)``, dK/dV, then dQ -- or, on the CPU,
their plain versions, written out blockwise the same way.  dK/dV and dQ take
one of two routes, chosen by shape in :func:`bwd_route`: ``"tc"`` (d <= 64:
a pre-pass splits q, k, v and do into TF32 planes, then both kernels
multiply on the tensor cores in 3xTF32) or ``"cuda_core"`` (64 < d <= 256:
exact float32 FMAs on the CUDA cores).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..core import _build
from ..core.linalg.basics import full_f32_matmul

__all__ = ["FLASH_BWD_LAUNCHES", "FLASH_LAUNCHES", "bwd_route", "flash_attention", "flash_unsupported"]

#: launches of the CUDA flash-attention kernel in this process (the plain version adds nothing)
FLASH_LAUNCHES = 0
#: launches of each CUDA backward kernel in this process, dK/dV and dQ by route: one backward launches
#: di once, and prep, dkv_tc and dq_tc (tc route) or dkv_cuda_core and dq_cuda_core once each
FLASH_BWD_LAUNCHES = {"di": 0, "prep": 0, "dkv_tc": 0, "dq_tc": 0, "dkv_cuda_core": 0, "dq_cuda_core": 0}

_MAX_HEAD_DIM = 256  # widest head flash_attn.cu holds: Q's planes and a ring of three 32 KB items fill 224 KB
_TILE = 32  # the shortest tile of a block of either direction (flash_attn_bwd.cu's keys at d > 128)
_MAX_BLOCKS = (1 << 31) - 1  # the grid's x extent
_MAX_HEADS = 65535  # the grid's y extent: flash_prep and flash_bwd_prep launch a row of blocks per head
_PLAIN_SCORES = 1 << 26  # scores per query block of the plain versions (256 MB in float32)
_TC_MAX_HEAD_DIM = 64  # the backward's tc route holds d <= 64, padded to 64 (flash_attn_bwd.cu kTcD)
_TC_ROWS = 128  # rows a tc block owns; the planes' rows are s rounded up to it (kTcBlockRows)
_TC_PLANES = 14  # q, k, v, do natural and q, k, do transposed, big and small (2 kPlanes)
_TC_TILE = 64 * 64  # floats of a plane's tile (kTile)


def flash_unsupported(s: int, h: int, d: int, dtype) -> Optional[str]:
    """Why the CUDA kernels (forward and backward) cannot take (s, h, d)
    tensors of ``dtype``, or None: they take float32, s >= 1, 1 <= h <= 65535
    and 1 <= d <= 256."""
    if dtype != torch.float32:
        return f"takes float32, got {dtype}"
    if s < 1 or h < 1:
        return f"needs s >= 1 and h >= 1, got s={s}, h={h}"
    if not 1 <= d <= _MAX_HEAD_DIM:
        return f"takes a head dimension of 1 to {_MAX_HEAD_DIM}, got d={d}"
    if -(-s // _TILE) * h > _MAX_BLOCKS:
        return f"launches one block per {_TILE} rows and head, at most {_MAX_BLOCKS}; s={s}, h={h}"
    if h > _MAX_HEADS:
        return f"launches its pre-passes with one grid row per head, at most {_MAX_HEADS}; h={h}"
    return None


def bwd_route(s: int, h: int, d: int) -> str:
    """The route of the backward's dK/dV and dQ kernels for (s, h, d)
    tensors that :func:`flash_unsupported` takes: ``"tc"`` for d <= 64 (the
    tensor cores in 3xTF32), ``"cuda_core"`` for wider heads (exact float32
    FMAs), which the tc route's one 64-column warpgroup tile does not hold."""
    return "tc" if d <= _TC_MAX_HEAD_DIM else "cuda_core"


# ----------------------------------------------------------------------
# the plain versions: float32 (float64 stays float64), full-precision
# products, a block of queries at a time so that the (h, s, s) scores are
# never held whole; under ``causal`` a block reads only the keys up to its
# last query
# ----------------------------------------------------------------------
def _wide(dtype) -> torch.dtype:
    return torch.promote_types(dtype, torch.float32)


def _query_blocks(s: int, h: int, causal: bool):
    """(i0, i1, nk): each block of queries and the keys it may read."""
    rows = max(1, _PLAIN_SCORES // max(1, h * s))
    for i0 in range(0, s, rows):
        i1 = min(s, i0 + rows)
        yield i0, i1, (i1 if causal else s)


def _masked_scores(qb, kb, i0, i1, scale, causal, n_true):
    """The (h, queries, keys) scaled scores of a block, -inf where the query
    may not attend the key."""
    pos = torch.arange(max(i1, kb.shape[0]), device=qb.device)
    pad = pos >= n_true
    scores = torch.einsum("qhd,khd->hqk", qb, kb) * scale
    mask = pad[i0:i1, None] == pad[None, : kb.shape[0]]
    if causal:
        mask &= pos[None, : kb.shape[0]] <= pos[i0:i1, None]
    return scores.masked_fill_(~mask, float("-inf"))


def _flash_plain(q, k, v, scale: float, causal: bool, n_true: int, with_lse: bool = False):
    """The attention, and with ``with_lse`` each row's log-sum-exp of its
    scaled scores as an (h, s) tensor (the forward's residual)."""
    s, h, d = q.shape
    wide = _wide(q.dtype)
    qf, kf, vf = q.to(wide), k.to(wide), v.to(wide)
    out = torch.empty((s, h, d), dtype=wide, device=q.device)
    lse = torch.empty((h, s), dtype=wide, device=q.device) if with_lse else None
    with full_f32_matmul():
        for i0, i1, nk in _query_blocks(s, h, causal):
            scores = _masked_scores(qf[i0:i1], kf[:nk], i0, i1, scale, causal, n_true)
            if with_lse:
                lse[:, i0:i1] = torch.logsumexp(scores, dim=-1)
            out[i0:i1] = torch.einsum("hqk,khd->qhd", torch.softmax(scores, dim=-1), vf[:nk])
    out = out.to(q.dtype)
    return (out, lse) if with_lse else out


def _bwd_di_plain(o, do) -> torch.Tensor:
    """di[h, i] = sum_c o[i, h, c] do[i, h, c]."""
    wide = _wide(o.dtype)
    return torch.einsum("qhd,qhd->hq", o.to(wide), do.to(wide))


def _probs(qb, kb, lse_b, i0, i1, scale, causal, n_true):
    """P of a block of queries, recomputed from the log-sum-exp (0 where masked)."""
    return torch.exp(_masked_scores(qb, kb, i0, i1, scale, causal, n_true) - lse_b[..., None])


def _bwd_dkv_plain(q, k, v, do, lse, di, scale: float, causal: bool, n_true: int):
    """dK = scale dS^T Q and dV = P^T dO, summed over the blocks of queries."""
    s, h, d = q.shape
    wide = _wide(q.dtype)
    qf, kf, vf, gf = q.to(wide), k.to(wide), v.to(wide), do.to(wide)
    dk = torch.zeros((s, h, d), dtype=wide, device=q.device)
    dv = torch.zeros((s, h, d), dtype=wide, device=q.device)
    with full_f32_matmul():
        for i0, i1, nk in _query_blocks(s, h, causal):
            p = _probs(qf[i0:i1], kf[:nk], lse[:, i0:i1], i0, i1, scale, causal, n_true)
            dv[:nk] += torch.einsum("hqk,qhd->khd", p, gf[i0:i1])
            ds = p * (torch.einsum("qhd,khd->hqk", gf[i0:i1], vf[:nk]) - di[:, i0:i1, None])
            dk[:nk] += torch.einsum("hqk,qhd->khd", ds, qf[i0:i1])
    return (dk * scale).to(k.dtype), dv.to(v.dtype)


def _bwd_dq_plain(q, k, v, do, lse, di, scale: float, causal: bool, n_true: int) -> torch.Tensor:
    """dQ = scale dS K, a block of queries at a time."""
    s, h, d = q.shape
    wide = _wide(q.dtype)
    qf, kf, vf, gf = q.to(wide), k.to(wide), v.to(wide), do.to(wide)
    dq = torch.empty((s, h, d), dtype=wide, device=q.device)
    with full_f32_matmul():
        for i0, i1, nk in _query_blocks(s, h, causal):
            p = _probs(qf[i0:i1], kf[:nk], lse[:, i0:i1], i0, i1, scale, causal, n_true)
            ds = p * (torch.einsum("qhd,khd->hqk", gf[i0:i1], vf[:nk]) - di[:, i0:i1, None])
            dq[i0:i1] = torch.einsum("hqk,khd->qhd", ds, kf[:nk]) * scale
    return dq.to(q.dtype)


def _perm8(n: int) -> torch.Tensor:
    """Row perm8(p) of each group of 8 at position p: (p % 4) * 2 + p // 4
    (flash_attn_bwd.cu's perm8)."""
    p = torch.arange(n)
    return (p & ~7) | ((p & 3) << 1) | ((p & 7) >> 2)


def _tile_order() -> tuple:
    """(row, depth) of each float of a 64 x 64 tile laid out for the
    kernels' wgmma descriptors (flash_attn_bwd.cu's tile_row and tile_col,
    the inverse of tf32x3.cuh's cm_off / 4)."""
    e = torch.arange(_TC_TILE)
    return ((e >> 6) & 7) * 8 + ((e >> 2) & 7), ((e >> 9) & 7) * 8 + ((e >> 5) & 1) * 4 + (e & 3)


def _bwd_prep_plain(q, k, v, do, lse, di) -> torch.Tensor:
    """The tc route's pre-pass: a flat float32 tensor of 14 planes of h sp
    64 floats (sp = s rounded up to 128; zeros past s and d), each a TF32
    big part then its small part (``core/_tf32x3.py``), of q, k, v, do
    natural (rows x depths) and q, k, do transposed (depths x rows, position
    p of each group of 8 rows holding row perm8(p)); each plane as (h, sp /
    64) tiles of 64 rows (or depths) x 64 depths (or rows) in the order
    :func:`_tile_order` gives; then lse and di as (h, sp), zeros past s."""
    from ..core._tf32x3 import tf32_rna

    s, h, d = q.shape
    sp = -(-s // _TC_ROWS) * _TC_ROWS
    nt, w = sp // _TC_MAX_HEAD_DIM, _TC_MAX_HEAD_DIM
    rows, cols = (i.to(q.device) for i in _tile_order())
    perm = _perm8(sp).to(q.device)
    out = torch.zeros((_TC_PLANES * h * sp * w + 2 * h * sp,), dtype=torch.float32, device=q.device)
    planes = out[: _TC_PLANES * h * sp * w].view(_TC_PLANES, h, nt, _TC_TILE)
    for i, x in enumerate((q, k, v, do, q, k, do)):
        xp = torch.zeros((h, sp, w), dtype=torch.float32, device=q.device)
        xp[:, :s, :d] = x.permute(1, 0, 2)
        if i < 4:
            tiles = xp.view(h, nt, w, w)  # (head, tile, row, depth)
        else:
            tiles = xp[:, perm].view(h, nt, w, w).transpose(2, 3)  # (head, tile, depth, position)
        flat = tiles[:, :, rows, cols].contiguous()
        planes[2 * i] = big = tf32_rna(flat)
        planes[2 * i + 1] = tf32_rna(flat - big)
    pad = out[_TC_PLANES * h * sp * w:].view(2, h, sp)
    pad[0, :, :s] = lse
    pad[1, :, :s] = di
    return out


# ----------------------------------------------------------------------
# the CUDA kernels
# ----------------------------------------------------------------------
_LIB = None
_BWD_LIB = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("flash_attn")
        lib.heat_flash_attn_f32.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int64] * 12
            + [ctypes.c_float, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        )
        lib.heat_flash_attn_f32.restype = ctypes.c_int
        lib.heat_flash_attn_scratch.argtypes = [ctypes.c_int64] * 3
        lib.heat_flash_attn_scratch.restype = ctypes.c_int64
        _LIB = lib
    return _LIB


def _bwd_lib() -> ctypes.CDLL:
    global _BWD_LIB
    if _BWD_LIB is None:
        lib = _build.load("flash_attn_bwd")
        lib.heat_flash_bwd_di.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 9 + [ctypes.c_void_p]
        tail = [ctypes.c_int64] * 3 + [ctypes.c_void_p, ctypes.c_float, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]
        lib.heat_flash_bwd_dkv.argtypes = [ctypes.c_void_p] * 8 + tail
        lib.heat_flash_bwd_dq.argtypes = [ctypes.c_void_p] * 7 + tail
        lib.heat_flash_bwd_tc_scratch.argtypes = [ctypes.c_int64] * 2
        lib.heat_flash_bwd_tc_scratch.restype = ctypes.c_int64
        lib.heat_flash_bwd_prep.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int64] * 3 + [ctypes.c_void_p] * 3
        tc_tail = [ctypes.c_int64] * 3 + [ctypes.c_float, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]
        lib.heat_flash_bwd_dkv_tc.argtypes = [ctypes.c_void_p] * 3 + tc_tail
        lib.heat_flash_bwd_dq_tc.argtypes = [ctypes.c_void_p] * 4 + tc_tail
        for fn in (lib.heat_flash_bwd_di, lib.heat_flash_bwd_dkv, lib.heat_flash_bwd_dq, lib.heat_flash_bwd_prep,
                   lib.heat_flash_bwd_dkv_tc, lib.heat_flash_bwd_dq_tc):
            fn.restype = ctypes.c_int
        _BWD_LIB = lib
    return _BWD_LIB


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def _flash_cuda(q, k, v, scale: float, causal: bool, n_true: int, with_lse: bool = False):
    """Launch csrc/flash_attn.cu (its pre-pass, then the kernel) on
    PyTorch's current stream (no synchronise); with ``with_lse`` the kernel
    also writes each row's log-sum-exp into an (h, s) float32 tensor.  The
    pre-pass writes K and V's TF32 planes into a scratch tensor of 4 h s d
    floats (s and d rounded up to 64), freed when the call returns: the
    backward reads k and v in float32 through their strides, not these
    planes, so keeping them until the backward would hold 134 MB at (16384,
    8, 64) for nothing."""
    global FLASH_LAUNCHES
    s, h, d = q.shape
    out = torch.empty((s, h, d), dtype=torch.float32, device=q.device)
    lse = torch.empty((h, s), dtype=torch.float32, device=q.device) if with_lse else None
    lib = _lib()
    scratch = torch.empty((lib.heat_flash_attn_scratch(s, h, d),), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.heat_flash_attn_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), None if lse is None else lse.data_ptr(),
            s, h, d, *q.stride(), *k.stride(), *v.stride(), scale, n_true, int(causal), scratch.data_ptr(), stream,
        )
    _check(err, "flash-attention")
    FLASH_LAUNCHES += 1
    return (out, lse) if with_lse else out


def _stream(t) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _bwd_di_cuda(o, do) -> torch.Tensor:
    """csrc/flash_attn_bwd.cu's flash_bwd_di: an (h, s) float32 tensor."""
    s, h, d = o.shape
    di = torch.empty((h, s), dtype=torch.float32, device=o.device)
    with torch.cuda.device(o.device):
        err = _bwd_lib().heat_flash_bwd_di(o.data_ptr(), do.data_ptr(), di.data_ptr(), s, h, d, *o.stride(),
                                           *do.stride(), _stream(o))
    _check(err, "flash-attention backward (di)")
    FLASH_BWD_LAUNCHES["di"] += 1
    return di


def _strides(*ts):
    flat = [x for t in ts for x in t.stride()]
    return (ctypes.c_int64 * len(flat))(*flat)


def _route(q, route: Optional[str]) -> str:
    """``route``, or the one :func:`bwd_route` picks; raises where the tc
    route cannot take d."""
    s, h, d = q.shape
    fits = bwd_route(s, h, d)
    if route is None:
        return fits
    if route not in ("tc", "cuda_core"):
        raise ValueError(f"the flash-attention backward has the routes tc and cuda_core, not {route!r}")
    if route == "tc" and fits != "tc":
        raise ValueError(f"the flash-attention backward's tc route takes d <= {_TC_MAX_HEAD_DIM}, got d={d}")
    return route


def _bwd_prep_cuda(q, k, v, do, lse, di) -> torch.Tensor:
    """csrc/flash_attn_bwd.cu's flash_bwd_prep: the tc route's TF32 planes
    of q, k, v and do and its padded lse and di, as :func:`_bwd_prep_plain`
    lays them out, in a scratch tensor of (14 * 64 + 2) h sp floats (sp = s
    rounded up to 128): 0.47 GB at (16384, 8, 64).  The backward frees it
    when it returns."""
    s, h, d = q.shape
    _route(q, "tc")
    lib = _bwd_lib()
    planes = torch.empty((lib.heat_flash_bwd_tc_scratch(s, h),), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = lib.heat_flash_bwd_prep(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                                      di.data_ptr(), s, h, d, _strides(q, k, v, do), planes.data_ptr(), _stream(q))
    _check(err, "flash-attention backward (prep)")
    FLASH_BWD_LAUNCHES["prep"] += 1
    return planes


def _bwd_dkv_cuda(q, k, v, do, lse, di, scale: float, causal: bool, n_true: int, route: str,
                  planes: Optional[torch.Tensor] = None):
    """dK and dV, contiguous, by ``route``: csrc/flash_attn_bwd.cu's
    flash_bwd_dkv_tc on the pre-pass's ``planes``, or flash_bwd_dkv."""
    s, h, d = q.shape
    route = _route(q, route)
    dk = torch.empty((s, h, d), dtype=torch.float32, device=q.device)
    dv = torch.empty_like(dk)
    lib = _bwd_lib()
    with torch.cuda.device(q.device):
        if route == "tc":
            err = lib.heat_flash_bwd_dkv_tc(planes.data_ptr(), dk.data_ptr(), dv.data_ptr(), s, h, d, scale, n_true,
                                            int(causal), _stream(q))
        else:
            err = lib.heat_flash_bwd_dkv(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(), di.data_ptr(),
                dk.data_ptr(), dv.data_ptr(), s, h, d, _strides(q, k, v, do), scale, n_true, int(causal), _stream(q),
            )
    _check(err, f"flash-attention backward (dkv, {route} route)")
    FLASH_BWD_LAUNCHES[f"dkv_{route}"] += 1
    return dk, dv


def _bwd_dq_cuda(q, k, v, do, lse, di, scale: float, causal: bool, n_true: int, route: str,
                 planes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """dQ, contiguous, by ``route``: csrc/flash_attn_bwd.cu's
    flash_bwd_dq_tc on the pre-pass's ``planes``, or flash_bwd_dq."""
    s, h, d = q.shape
    route = _route(q, route)
    dq = torch.empty((s, h, d), dtype=torch.float32, device=q.device)
    lib = _bwd_lib()
    with torch.cuda.device(q.device):
        if route == "tc":
            err = lib.heat_flash_bwd_dq_tc(planes.data_ptr(), lse.data_ptr(), di.data_ptr(), dq.data_ptr(), s, h, d,
                                           scale, n_true, int(causal), _stream(q))
        else:
            err = lib.heat_flash_bwd_dq(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(), di.data_ptr(),
                dq.data_ptr(), s, h, d, _strides(q, k, v, do), scale, n_true, int(causal), _stream(q),
            )
    _check(err, f"flash-attention backward (dq, {route} route)")
    FLASH_BWD_LAUNCHES[f"dq_{route}"] += 1
    return dq


def _bwd_cuda(q, k, v, do, lse, di, scale: float, causal: bool, n_true: int, route: Optional[str] = None):
    """dQ, dK, dV by the route :func:`bwd_route` picks or by ``route``; the
    tc route's pre-pass runs once for both kernels."""
    route = _route(q, route)
    planes = _bwd_prep_cuda(q, k, v, do, lse, di) if route == "tc" else None
    dk, dv = _bwd_dkv_cuda(q, k, v, do, lse, di, scale, causal, n_true, route, planes)
    dq = _bwd_dq_cuda(q, k, v, do, lse, di, scale, causal, n_true, route, planes)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """Attention with its gradient: the forward keeps q, k, v, the output and
    the log-sum-exp; the backward runs di, dK/dV, then dQ."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float, causal: bool, n_true: int):
        run = _flash_plain if q.device.type == "cpu" else _flash_cuda
        out, lse = run(q, k, v, scale, causal, n_true, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (scale, causal, n_true)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        args = ctx.args
        if q.device.type == "cpu":
            di = _bwd_di_plain(out, do)
            dk, dv = _bwd_dkv_plain(q, k, v, do, lse, di, *args)
            dq = _bwd_dq_plain(q, k, v, do, lse, di, *args)
        else:
            if do.dtype != torch.float32:
                raise TypeError(f"the CUDA flash-attention backward takes a float32 gradient, got {do.dtype}")
            di = _bwd_di_cuda(out, do)
            dq, dk, dv = _bwd_cuda(q, k, v, do, lse, di, *args)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, scale: float, causal: bool, n_true: int) -> torch.Tensor:
    """Attention of (s, h, d) tensors ``q``, ``k``, ``v``: a (s, h, d)
    result in q's dtype, the tail from ``n_true`` on isolated as its own
    segment.  Strided inputs are read in place.  Differentiable in q, k and
    v; without a gradient wanted, the forward alone runs and keeps nothing.

    A CPU tensor runs the plain versions; a CUDA tensor runs the kernels or
    raises."""
    if q.ndim != 3 or q.shape != k.shape or k.shape != v.shape:
        raise ValueError(f"need q, k and v of one (s, h, d) shape, got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if not q.device == k.device == v.device:
        raise ValueError(f"q, k and v lie on {q.device}, {k.device} and {v.device}")
    s, h, d = q.shape
    n_true = max(0, min(int(n_true), s))
    scale, causal = float(scale), bool(causal)
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no flash-attention kernel for device {q.device}")
    if q.device.type == "cuda":
        if not q.dtype == k.dtype == v.dtype == torch.float32:
            raise TypeError(f"the CUDA flash-attention kernel takes float32, got {q.dtype}, {k.dtype} and {v.dtype}")
        reason = flash_unsupported(s, h, d, q.dtype)
        if reason is not None:
            raise ValueError(f"the CUDA flash-attention kernel {reason}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _FlashAttention.apply(q, k, v, scale, causal, n_true)
    run = _flash_plain if q.device.type == "cpu" else _flash_cuda
    return run(q, k, v, scale, causal, n_true)
