"""Forward flash attention: the hand-written CUDA kernel and its plain
PyTorch version.

The counterpart of JAX's packaged TPU kernel
``jax.experimental.pallas.ops.tpu.flash_attention`` as
``heat_tpu/nn/attention.py::_local_flash`` calls it: full-sequence attention
over (s, h, d) tensors in which a query attends a key iff both lie before
``n_true`` or both at or after it (the segment ids that isolate the padded
tail) and, under ``causal``, the key is not after the query.

:func:`flash_attention` launches ``csrc/flash_attn.cu`` for a CUDA tensor,
or raises with the reason the kernel cannot take it; for a CPU tensor, and
only there, it runs :func:`_flash_plain`.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..core import _build
from ..core.linalg.basics import full_f32_matmul

__all__ = ["FLASH_LAUNCHES", "flash_attention", "flash_unsupported"]

#: launches of the CUDA flash-attention kernel in this process (the plain version adds nothing)
FLASH_LAUNCHES = 0

_MAX_HEAD_DIM = 256  # widest head flash_attn.cu holds: Q's planes and a ring of three 32 KB items fill 224 KB
_TILE = 64  # queries per warpgroup (flash_attn.cu kBQ); the gate counts blocks of one warpgroup
_MAX_BLOCKS = (1 << 31) - 1  # the grid's x extent
_PLAIN_SCORES = 1 << 26  # scores per query block of the plain version (256 MB in float32)


def flash_unsupported(s: int, h: int, d: int, dtype) -> Optional[str]:
    """Why the CUDA kernel cannot take (s, h, d) tensors of ``dtype``, or
    None: it takes float32, any s >= 1 and h >= 1, and 1 <= d <= 256."""
    if dtype != torch.float32:
        return f"takes float32, got {dtype}"
    if s < 1 or h < 1:
        return f"needs s >= 1 and h >= 1, got s={s}, h={h}"
    if not 1 <= d <= _MAX_HEAD_DIM:
        return f"takes a head dimension of 1 to {_MAX_HEAD_DIM}, got d={d}"
    if -(-s // _TILE) * h > _MAX_BLOCKS:
        return f"launches one block per {_TILE} queries and head, at most {_MAX_BLOCKS}; s={s}, h={h}"
    return None


def _flash_plain(q, k, v, scale: float, causal: bool, n_true: int) -> torch.Tensor:
    """The same attention in plain PyTorch, in float32 with full-precision
    products, a block of queries at a time so that the (h, s, s) scores are
    never held whole; under ``causal`` a block reads only the keys up to its
    last query."""
    s, h, d = q.shape
    qf, kf, vf = q.float(), k.float(), v.float()
    out = torch.empty((s, h, d), dtype=torch.float32, device=q.device)
    pos = torch.arange(s, device=q.device)
    pad = pos >= n_true
    rows = max(1, _PLAIN_SCORES // max(1, h * s))
    with full_f32_matmul():
        for i0 in range(0, s, rows):
            i1 = min(s, i0 + rows)
            nk = i1 if causal else s
            scores = torch.einsum("qhd,khd->hqk", qf[i0:i1], kf[:nk]) * scale
            mask = pad[i0:i1, None] == pad[None, :nk]
            if causal:
                mask &= pos[None, :nk] <= pos[i0:i1, None]
            scores.masked_fill_(~mask, float("-inf"))
            out[i0:i1] = torch.einsum("hqk,khd->qhd", torch.softmax(scores, dim=-1), vf[:nk])
    return out.to(q.dtype)


_LIB = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("flash_attn")
        lib.heat_flash_attn_f32.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 12
            + [ctypes.c_float, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        )
        lib.heat_flash_attn_f32.restype = ctypes.c_int
        lib.heat_flash_attn_scratch.argtypes = [ctypes.c_int64] * 3
        lib.heat_flash_attn_scratch.restype = ctypes.c_int64
        _LIB = lib
    return _LIB


def _flash_cuda(q, k, v, scale: float, causal: bool, n_true: int) -> torch.Tensor:
    """Launch csrc/flash_attn.cu (its pre-pass, then the kernel) on
    PyTorch's current stream (no synchronise).  The pre-pass writes K and V's
    TF32 planes into a scratch tensor of 4 h s d floats (s and d rounded up
    to 64), freed when the call returns."""
    global FLASH_LAUNCHES
    s, h, d = q.shape
    out = torch.empty((s, h, d), dtype=torch.float32, device=q.device)
    lib = _lib()
    scratch = torch.empty((lib.heat_flash_attn_scratch(s, h, d),), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.heat_flash_attn_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), s, h, d,
            *q.stride(), *k.stride(), *v.stride(), scale, n_true, int(causal), scratch.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"flash-attention kernel launch failed: CUDA error {err}")
    FLASH_LAUNCHES += 1
    return out


def flash_attention(q, k, v, scale: float, causal: bool, n_true: int) -> torch.Tensor:
    """Attention of (s, h, d) tensors ``q``, ``k``, ``v``: a (s, h, d)
    result in q's dtype, the tail from ``n_true`` on isolated as its own
    segment.  Strided inputs are read in place.

    A CPU tensor runs the plain version; a CUDA tensor runs the kernel or
    raises."""
    if q.ndim != 3 or q.shape != k.shape or k.shape != v.shape:
        raise ValueError(f"need q, k and v of one (s, h, d) shape, got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if not q.device == k.device == v.device:
        raise ValueError(f"q, k and v lie on {q.device}, {k.device} and {v.device}")
    s, h, d = q.shape
    n_true = max(0, min(int(n_true), s))
    if q.device.type == "cpu":
        return _flash_plain(q, k, v, float(scale), bool(causal), n_true)
    if q.device.type != "cuda":
        raise ValueError(f"no flash-attention kernel for device {q.device}")
    if not q.dtype == k.dtype == v.dtype == torch.float32:
        raise TypeError(f"the CUDA flash-attention kernel takes float32, got {q.dtype}, {k.dtype} and {v.dtype}")
    reason = flash_unsupported(s, h, d, q.dtype)
    if reason is not None:
        raise ValueError(f"the CUDA flash-attention kernel {reason}")
    return _flash_cuda(q, k, v, float(scale), bool(causal), n_true)
