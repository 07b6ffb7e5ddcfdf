"""The plain emulation of ``csrc/tf32x3.cuh``: 3xTF32 products with integer
operations on the float32 bits.

The hand-written kernels K2 (``csrc/syrk.cu``), K3/K4 (``csrc/fft_stage.cu``),
K6 (``csrc/fft_axis.cu``), K7 (``csrc/flash_attn.cu``) and K7-bwd's tc route
(``csrc/flash_attn_bwd.cu``) multiply on the tensor cores in 3xTF32: each float32 operand x is split into
``big = rna(x)`` and ``small = rna(x - big)``, both exact in TF32 (10
mantissa bits), and a product ``a b`` is taken as
``a_small b_big + a_big b_small + a_big b_big`` (the small x small term,
about 2^-22 relative, is dropped).  The tensor core cannot run here, so the
CPU tests hold the kernels' precision class through these functions: the
products of two TF32 values are exact in float32, so a full-float32 matmul
of the split operands gives the same terms.  K1's tc route
(``csrc/lloyd.cu``) takes its one-hot products over three planes instead
(:func:`tf32_split`, by truncation), which hold a float32 exactly.  Nothing on the kernels'
path calls this module; the plain version of K7-bwd's pre-pass
(``nn/_flash.py::_bwd_prep_plain``) splits with :func:`tf32_rna`.
"""

from __future__ import annotations

import torch

from .linalg.basics import full_f32_matmul

__all__ = ["tf32_rna", "tf32_mm", "tf32_split", "tf32_trunc", "tf32x3_mm"]


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32, to nearest with ties away from zero,
    as ``cvt.rna.tf32.f32`` rounds: add half of the 13 dropped bits' range
    to the bits, then clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) cut to TF32 by clearing its 13 low bits (toward zero)."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def tf32_split(x: torch.Tensor, planes: int = 3):
    """``x`` (float32) as TF32 planes.  Two planes split as
    ``csrc/tf32x3.cuh`` does: ``big = rna(x)``, ``small = rna(x - big)``,
    the remainder dropped.  Three split as lloyd.cu's ``split3`` does, by
    truncation: ``big`` and ``mid`` the top 11 significant bits of ``x`` and
    of ``x - big``, ``small`` the at most 2 bits left; the three sum to ``x``
    exactly."""
    if planes == 2:
        big = tf32_rna(x)
        return big, tf32_rna(x - big)
    if planes != 3:
        raise ValueError(f"splits into 2 or 3 planes, got {planes}")
    big = tf32_trunc(x)
    rest = x - big
    mid = tf32_trunc(rest)
    return big, mid, rest - mid


def tf32x3_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (float32, batched as ``torch.matmul``) as the kernels take
    it: each operand split into TF32 big and small parts, small x big +
    big x small + big x big summed in float32."""
    ab, bb = tf32_rna(a), tf32_rna(b)
    as_, bs = tf32_rna(a - ab), tf32_rna(b - bb)
    with full_f32_matmul():
        return as_ @ bb + ab @ bs + ab @ bb


def tf32_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in one TF32 pass, for contrast: about three decimal digits."""
    with full_f32_matmul():
        return tf32_rna(a) @ tf32_rna(b)
