"""The fused last-axis DFT pass, K6 (counterpart of
heat_tpu/fft/_pallas_fft.py, whose Pallas kernel ``_axis_pass_fn`` this
replaces).

A length ``n = n1 * n2`` with ``n1`` the largest divisor <= 128 and
``n2 = n / n1 <= 8`` is transformed in one read and one write of the rows.
With the row viewed as ``x[j2, j1]`` (``j = j1 + n1 * j2``) and the output
index ``k = k2 + n2 * k1``:

    stage A   Y[k2, j1] = sum_j2 x[j2, j1] W_n2^(j2 k2)   (radix-n2 butterflies)
    twiddle   Y[k2, j1] *= W_n^(j1 k2)
    stage B   Z[k2, k1] = sum_j1 Y[k2, j1] W_n1^(j1 k1)  (an n1-point DFT)
    X[k2 + n2 k1] = Z[k2, k1]

:func:`fused_axis_pass` launches ``csrc/fft_axis.cu`` for CUDA float32 planes
and raises where it cannot; for CPU planes, and only there, it runs
:func:`_axis_pass_plain`, the same three steps in plain PyTorch.  The CUDA
kernel writes X in its final order, so the reference's transpose after the
kernel is gone.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch

from ..core import _build
from ..core.linalg.basics import full_f32_matmul
from ._planar import complex_source
from ._weight_cache import on_device

__all__ = ["FFT_AXIS_LAUNCHES", "axis_pass_unsupported", "fused_axis_pass"]

#: launches of the CUDA axis-pass kernel in this process (the plain version adds nothing)
FFT_AXIS_LAUNCHES = 0

_LANES = 128  # largest stage-B length n1
_MAX_RADIX = 8  # largest stage-A radix n2
_MAX_BLOCKS = (1 << 31) - 1


@functools.lru_cache(maxsize=512)
def _split_factors(n: int):
    """(n1, n2): n1 = largest divisor <= 128, n2 = n/n1 (the small stage-A
    radix); None when the pair does not exist."""
    best = None
    d = 1
    while d * d <= n:
        if n % d == 0:
            for f in (d, n // d):
                if f <= _LANES and (best is None or f > best):
                    best = f
        d += 1
    if best is None or best < 2:
        return None
    n1 = best
    n2 = n // n1
    if n2 > _MAX_RADIX:
        return None
    return n1, n2


def _consts(n: int, inverse: bool):
    """Stage-A constants W_n2^(j2 k2) (f64, [j2, k2]), the twiddle
    W_n^(j1 k2) as (n2, n1) f32 planes, and the stage-B DFT matrix as f32
    (re, im, re + im) planes -- the reference's exact arrays."""
    n1, n2 = _split_factors(n)
    sign = 1.0 if inverse else -1.0
    ang2 = 2.0 * np.pi * (np.outer(np.arange(n2), np.arange(n2)) % n2) / max(n2, 1)
    c2re = np.cos(ang2)
    c2im = sign * np.sin(ang2)
    angt = 2.0 * np.pi * (np.outer(np.arange(n2), np.arange(n1)) % n) / n
    twr = np.asarray(np.cos(angt), np.float32)
    twi = np.asarray(sign * np.sin(angt), np.float32)
    ang1 = 2.0 * np.pi * (np.outer(np.arange(n1), np.arange(n1)) % n1) / n1
    w1re = np.cos(ang1)
    w1im = sign * np.sin(ang1)
    w1 = (
        np.asarray(w1re, np.float32),
        np.asarray(w1im, np.float32),
        np.asarray(w1re + w1im, np.float32),
    )
    return n1, n2, c2re, c2im, (twr, twi), w1


def _kernel_consts(n: int, inverse: bool):
    """What the CUDA kernel and the plain version read, all f32: the
    stage-A constants (n2, n2) [j2, k2] (rounded to f32 as the reference's
    kernel rounds its scalar constants), the twiddle (n2, n1) and the stage-B
    matrix (n1, n1), each as (re, im)."""
    _, _, c2re, c2im, (twr, twi), (w1re, w1im, _) = _consts(n, inverse)
    return (np.asarray(c2re, np.float32), np.asarray(c2im, np.float32), twr, twi, w1re, w1im)


def axis_pass_unsupported(n: int, batch: int, dtype) -> Optional[str]:
    """Why K6 cannot take ``batch`` rows of length ``n`` of ``dtype``, or None."""
    if dtype != torch.float32:
        return f"takes float32, got {dtype}"
    if batch < 1:
        return f"needs at least one row, got {batch}"
    if _split_factors(n) is None:
        return f"needs n = n1 * n2 with n1 <= {_LANES} and n2 <= {_MAX_RADIX}, got n={n}"
    rows = _rows_per_block(*_split_factors(n))
    if -(-batch // rows) > _MAX_BLOCKS:
        return f"takes at most {_MAX_BLOCKS * rows} rows, got {batch}"
    return None


def _rows_per_block(n1: int, n2: int) -> int:
    """Batch rows of one block of csrc/fft_axis.cu (its ``batch_rows``): 8
    warps of 32 stage-B rows x 32 bins tile (rows, n1 rounded up to 8), so a
    block covers 64, 128 or 256 stage-B rows, that is that many over n2 rows
    of the batch."""
    n1p = -(-n1 // 8) * 8
    warps_n = 1 if n1p <= 32 else 2 if n1p <= 64 else 4
    return (256 // warps_n) // n2


def _axis_pass_plain(re, im, n1: int, n2: int, consts):
    """Stage A, the twiddle and stage B in plain PyTorch on (batch, n)
    planes; X comes back in the order k = k2 + n2 * k1."""
    c2re, c2im, twr, twi, w1re, w1im = consts
    b = re.shape[0]
    xr = re.reshape(b, n2, n1)
    xi = im.reshape(b, n2, n1) if im is not None else None
    yr = torch.einsum("bjl,jk->bkl", xr, c2re)
    yi = torch.einsum("bjl,jk->bkl", xr, c2im)
    if xi is not None:
        yr = yr - torch.einsum("bjl,jk->bkl", xi, c2im)
        yi = yi + torch.einsum("bjl,jk->bkl", xi, c2re)
    yr, yi = yr * twr - yi * twi, yr * twi + yi * twr  # [b, k2, j1]
    with full_f32_matmul():
        zr = yr @ w1re - yi @ w1im  # [b, k2, k1]
        zi = yr @ w1im + yi @ w1re
    return zr.transpose(1, 2).reshape(b, n1 * n2), zi.transpose(1, 2).reshape(b, n1 * n2)


_LIB = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("fft_axis")
        lib.heat_fft_axis_f32.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
        ]
        lib.heat_fft_axis_f32.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _axis_pass_cuda(re, im, n: int, inverse: bool):
    """Launch csrc/fft_axis.cu on PyTorch's current stream (no synchronise).
    The result is one complex64 tensor, returned as its (real, imag) views."""
    global FFT_AXIS_LAUNCHES
    n1, n2 = _split_factors(n)
    batch = re.numel() // n
    src = complex_source(re, im)
    if src is not None:
        in_re, es_in = src.data_ptr(), 2
        in_im = in_re + 4
    else:
        re = re.contiguous()
        im = im.contiguous() if im is not None else None
        in_re, in_im, es_in = re.data_ptr(), (im.data_ptr() if im is not None else None), 1
    c2re, c2im, twr, twi, w1re, w1im = on_device(_kernel_consts, n, bool(inverse), device=re.device)
    out = torch.empty(re.shape, dtype=torch.complex64, device=re.device)
    o = torch.view_as_real(out)
    with torch.cuda.device(re.device):
        stream = torch.cuda.current_stream(re.device).cuda_stream
        err = _lib().heat_fft_axis_f32(
            in_re, in_im, es_in, batch, n1, n2,
            c2re.data_ptr(), c2im.data_ptr(), twr.data_ptr(), twi.data_ptr(), w1re.data_ptr(), w1im.data_ptr(),
            o.data_ptr(), o.data_ptr() + 4, 2, stream,
        )
    if err != 0:
        raise RuntimeError(f"fft axis-pass kernel launch failed: CUDA error {err}")
    FFT_AXIS_LAUNCHES += 1
    return out.real, out.imag


def fused_axis_pass(re, im, inverse: bool):
    """Last-axis DFT of (batch..., n) float32 planes; ``im=None`` means real
    input (no imaginary plane is read).

    CPU planes run the plain version; CUDA planes run the kernel or raise."""
    n = int(re.shape[-1])
    batch = re.numel() // n if n else 0
    if im is not None and (im.shape != re.shape or im.device != re.device or im.dtype != re.dtype):
        raise ValueError(f"planes differ: re {tuple(re.shape)} {re.dtype} on {re.device}, im {tuple(im.shape)} {im.dtype} on {im.device}")
    if re.dtype != torch.float32:
        raise TypeError(f"the fused axis pass takes float32, got {re.dtype}")
    reason = axis_pass_unsupported(n, batch, re.dtype)
    if reason is not None:
        raise ValueError(f"the fused axis pass {reason}")
    if re.device.type == "cpu":
        n1, n2 = _split_factors(n)
        consts = on_device(_kernel_consts, n, bool(inverse), device=re.device)
        ore, oim = _axis_pass_plain(re.reshape(batch, n), None if im is None else im.reshape(batch, n), n1, n2, consts)
        return ore.reshape(re.shape), oim.reshape(re.shape)
    if re.device.type != "cuda":
        raise ValueError(f"no axis-pass kernel for device {re.device}")
    return _axis_pass_cuda(re, im, n, inverse)
