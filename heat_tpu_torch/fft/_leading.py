"""Leading-contraction 2-D/3-D FFT engine (counterpart of heat_tpu/fft/_leading.py).

Every DFT stage contracts the LEADING dim of its operand, so the stage's
output cycles the axis order and the next transform axis arrives in front
without a transpose.  The complex pair lives in separate re/im planes; a
stage is two products against the concatenated ``[W_re | W_im]`` matrix plus
a combine.  The real-input transform halves axis 0 to ``m = n0 // 2`` bins,
carries the Nyquist bin through a side chain and builds the Hermitian upper
half at the end.  The norm is folded into the exit-stage matrices.

Three hand-written CUDA kernels carry the float32 stages:

* K3, ``csrc/fft_stage.cu`` (:func:`_stage_fused`,
  :func:`_stage_fused_blocked`): one stage, both products and the combine,
  written as two planes; the blocked form reads the re/im column blocks of
  the entry product's (K, B, 2m) output by index arithmetic;
* K4, the same source (:func:`_stage_pair_fused`, :func:`_entry_pair_fused`):
  the same stage written as one cat-layout (M, 2n) output (the pair-block
  (..., 2, n) layout), or straight into a complex64 result;
* K5, ``csrc/fft_ext.cu`` (:func:`_ext_fused`): the combine of the raw exit
  products plus the Hermitian extension, an exact indexed copy that writes
  the complex64 spectrum.

Each wrapper launches its kernel for CUDA float32 tensors, raises where it
cannot, and runs its plain PyTorch version for CPU tensors only.  Float64
and shapes a gate refuses take the reference's XLA twins (``_stage``,
``_stage_pair``, ``_ext_xla``), which are ``torch.matmul`` and indexing.
The entry and exit products outside the kernels are ``torch.matmul`` in
full float32.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from ..core import _build
from ..core.linalg.basics import full_f32_matmul
from ._planar import _dt, _w, complex_source, hermitian_upper, scale_factor
from ._weight_cache import byte_lru as _byte_lru

__all__ = [
    "FFT_EXT_LAUNCHES",
    "FFT_PAIR_LAUNCHES",
    "FFT_STAGE_LAUNCHES",
    "cfftn_leading",
    "ext_unsupported",
    "leading_eligible",
    "rfft2_leading",
    "rfft3_leading",
    "stage_unsupported",
]

#: launches of K3 (the two-plane stage) in this process; plain versions add nothing
FFT_STAGE_LAUNCHES = 0
#: launches of K4 (the cat-layout pair stage)
FFT_PAIR_LAUNCHES = 0
#: launches of K5 (the combine plus Hermitian extension)
FFT_EXT_LAUNCHES = 0

_STAGE_BN = 64  # output bins per block of fft_stage.cu
_MAX_BLOCKS = (1 << 31) - 1


# ----------------------------------------------------------------------
# the weight matrices: host float64, exactly as the reference makes them
# ----------------------------------------------------------------------
@_byte_lru
def _cs(n: int, inverse: bool):
    """Host f64 (cos, sign*sin) planes of the n-point DFT matrix."""
    j = np.arange(n, dtype=np.float64)
    jk = np.outer(j, j) % n
    ang = 2.0 * np.pi * jk / n
    sign = 1.0 if inverse else -1.0
    return np.cos(ang), sign * np.sin(ang)


@_byte_lru
def _w_entry_half(n: int, m: int, dt: str, part: str):
    """(n, m) real-input entry matrix for bins 0..m-1 (axis-0 halving)."""
    c, s = _cs(n, False)
    w = c if part == "re" else s
    return np.asarray(w[:, :m], dt)


@_byte_lru
def _w_entry_cat(n: int, m: int, dt: str):
    """(n, 2m) ``[re-bins 0..m-1 | im-bins 0..m-1]`` entry matrix: one
    product reads x once; the mid stage addresses the column blocks."""
    c, s = _cs(n, False)
    return np.asarray(np.concatenate([c[:, :m], s[:, :m]], 1), dt)


@_byte_lru
def _w_cat(n: int, dt: str, inverse: bool, scale: float):
    """(n, 2n) ``[W_re | W_im] * scale`` stage matrix (scale folds the norm
    into the exit stage)."""
    c, s = _cs(n, inverse)
    return np.asarray(np.concatenate([c, s], 1) * scale, dt)


@_byte_lru
def _w_cat_im(n: int, dt: str, inverse: bool, scale: float):
    """(n, 2n) ``[-W_im | W_re] * scale``: the imaginary plane's partner of
    ``_w_cat`` (``re @ _w_cat + im @ _w_cat_im`` lands the combined cat)."""
    c, s = _cs(n, inverse)
    return np.asarray(np.concatenate([-s, c], 1) * scale, dt)


@_byte_lru
def _w_block(n: int, dt: str, inverse: bool, scale: float):
    """(2, n, 2, n) pair-block stage matrix: ``W[p, j, q, k]`` maps input
    plane p (0 = re, 1 = im) and source index j to output plane q and bin k."""
    c, s = _cs(n, inverse)
    w = np.empty((2, n, 2, n), np.float64)
    w[0, :, 0, :] = c
    w[1, :, 0, :] = -s
    w[0, :, 1, :] = s
    w[1, :, 1, :] = c
    return np.asarray(w * scale, dt)


def _dg0(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Leading-dim contraction: (K, ...rest) x (K, N) -> (...rest, N)."""
    k = a.shape[0]
    rest = a.shape[1:]
    with full_f32_matmul():
        out = a.reshape(k, -1).T @ w
    return out.reshape(*rest, w.shape[1])


def _stage(re, im, wcat, n: int):
    """One complex DFT stage over the LEADING dim (K3's plain version and the
    f64 route): two cat products and the combine."""
    zr = _dg0(re, wcat)
    zi = _dg0(im, wcat)
    return zr[..., :n] - zi[..., n:], zr[..., n:] + zi[..., :n]


def _stage_pair(z, n: int, inverse: bool, scale: float):
    """(n, ...rest, 2, m) -> (...rest, m, 2, k): one leading+pair contraction
    against ``_w_block`` (K4's twin, the f64 route)."""
    wb = _w(_w_block, n, _dt(z), inverse, float(scale), like=z)
    with full_f32_matmul():
        return torch.tensordot(z, wb, dims=([0, z.ndim - 2], [1, 0]))


def _pair_plain(re2, im2, wcat, n: int):
    """K4's plain version: the two cat products of (K, M) planes written out
    as one (M, 2n) cat-layout output."""
    ore, oim = _stage(re2, im2, wcat, n)
    return torch.cat([ore, oim], 1)


# ----------------------------------------------------------------------
# gates and launches
# ----------------------------------------------------------------------
def stage_unsupported(k: int, m_total: int, n: int, dtype) -> Optional[str]:
    """Why K3/K4 cannot contract K = ``k`` rows into ``m_total`` x ``n``
    outputs of ``dtype``, or None."""
    if dtype != torch.float32:
        return f"takes float32, got {dtype}"
    if min(k, m_total, n) < 1:
        return f"needs non-empty operands, got K={k}, M={m_total}, n={n}"
    if -(-m_total // 128) * -(-n // _STAGE_BN) > _MAX_BLOCKS:
        return f"takes at most {_MAX_BLOCKS} blocks of 128 x {_STAGE_BN} outputs, got M={m_total}, n={n}"
    return None


def ext_unsupported(m: int, n1: int, n2: int, dtype) -> Optional[str]:
    """Why K5 cannot extend an (m, n1, n2) half spectrum of ``dtype``, or None."""
    if dtype != torch.float32:
        return f"takes float32, got {dtype}"
    if min(m, n1, n2) < 1:
        return f"needs a non-empty half spectrum, got m={m}, n1={n1}, n2={n2}"
    if -(-(m + 1) * n1 * n2 // 256) > _MAX_BLOCKS:
        return f"takes at most {_MAX_BLOCKS * 256} source elements, got {(m + 1) * n1 * n2}"
    return None


_STAGE_LIB = None
_EXT_LIB = None


def _stage_lib() -> ctypes.CDLL:
    global _STAGE_LIB
    if _STAGE_LIB is None:
        lib = _build.load("fft_stage")
        i64, ptr = ctypes.c_int64, ctypes.c_void_p
        lib.heat_fft_stage_f32.argtypes = [ptr, ptr, i64, i64, i64, i64, i64, i64, i64, ptr, ptr, ptr, i64, i64, ptr]
        lib.heat_fft_stage_f32.restype = ctypes.c_int
        _STAGE_LIB = lib
    return _STAGE_LIB


def _ext_lib() -> ctypes.CDLL:
    global _EXT_LIB
    if _EXT_LIB is None:
        lib = _build.load("fft_ext")
        i64, ptr = ctypes.c_int64, ctypes.c_void_p
        lib.heat_fft_ext_f32.argtypes = [ptr, ptr, ptr, ptr, i64, i64, i64, ptr, ptr, i64, ptr]
        lib.heat_fft_ext_f32.restype = ctypes.c_int
        _EXT_LIB = lib
    return _EXT_LIB


def _check(name: str, *tensors) -> torch.device:
    """Common checks of a kernel wrapper's float32 operands: one device, a
    CPU or CUDA one."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: operands on {dev} and {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} takes float32, got {t.dtype}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no {name} kernel for device {dev}")
    return dev


def _planes_source(re, im):
    """(re pointer, im pointer, element stride) of a plane pair: the two
    views of one complex64 tensor are read in place, anything else as
    contiguous planes.  The tensors to keep alive come last."""
    src = complex_source(re, im)
    if src is not None:
        return src.data_ptr(), src.data_ptr() + 4, 2, (src,)
    re, im = re.contiguous(), im.contiguous()
    return re.data_ptr(), im.data_ptr(), 1, (re, im)


def _launch_stage(a_re, a_im, lda, es_in, mb, bs, k, m_total, n, w, o_re, o_im, ldo, es_out, dev):
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _stage_lib().heat_fft_stage_f32(
            a_re, a_im, lda, es_in, mb, bs, k, m_total, n, w.data_ptr(), o_re, o_im, ldo, es_out, stream
        )
    if err != 0:
        raise RuntimeError(f"fft stage kernel launch failed: CUDA error {err}")


def _stage_out(m_total: int, n: int, dev, layout: str):
    """Output of K3/K4 and its (re pointer, im pointer, row stride, element
    stride): two (M, n) planes ("planes"), one (M, 2n) cat-layout tensor
    ("cat"), or one (M, n) complex64 tensor ("complex")."""
    if layout == "planes":
        ore = torch.empty((m_total, n), dtype=torch.float32, device=dev)
        oim = torch.empty((m_total, n), dtype=torch.float32, device=dev)
        return (ore, oim), ore.data_ptr(), oim.data_ptr(), n, 1
    if layout == "cat":
        out = torch.empty((m_total, 2 * n), dtype=torch.float32, device=dev)
        return out, out.data_ptr(), out.data_ptr() + 4 * n, 2 * n, 1
    out = torch.empty((m_total, n), dtype=torch.complex64, device=dev)
    return out, out.data_ptr(), out.data_ptr() + 4, 2 * n, 2


def _stage_fused(re, im, n: int, inverse: bool, scale: float):
    """K3 on separate (K, ...rest) planes -> two (...rest, n) planes."""
    global FFT_STAGE_LAUNCHES
    k = int(re.shape[0])
    rest = tuple(int(s) for s in re.shape[1:])
    m_total = int(np.prod(rest, dtype=np.int64))
    dev = _check("the fft stage", re, im)
    if re.shape != im.shape:
        raise ValueError(f"the fft stage: planes {tuple(re.shape)} and {tuple(im.shape)}")
    reason = stage_unsupported(k, m_total, n, re.dtype)
    if reason is not None:
        raise ValueError(f"the fft stage {reason}")
    w = _w(_w_cat, n, "float32", bool(inverse), float(scale), like=re)
    if k != w.shape[0]:
        raise ValueError(f"the fft stage contracts {k} rows with an {w.shape[0]}-point stage matrix")
    if dev.type == "cpu":
        return _stage(re, im, w, n)
    a_re, a_im, es, keep = _planes_source(re, im)
    (ore, oim), o_re, o_im, ldo, es_out = _stage_out(m_total, n, dev, "planes")
    _launch_stage(a_re, a_im, m_total * es, es, m_total, 0, k, m_total, n, w, o_re, o_im, ldo, es_out, dev)
    FFT_STAGE_LAUNCHES += 1
    return ore.reshape(*rest, n), oim.reshape(*rest, n)


def _stage_fused_blocked(z, n: int, m: int, inverse: bool, scale: float):
    """K3 reading a BLOCK-CAT operand: z is (K, B, 2m) with re bins in
    columns [0, m) and im bins in [m, 2m) of every B-row (the entry
    product's natural output); out two (B, m, n) planes.  The kernel
    addresses the halves itself; no slice is copied."""
    global FFT_STAGE_LAUNCHES
    k, b = int(z.shape[0]), int(z.shape[1])
    if z.ndim != 3 or int(z.shape[2]) != 2 * m:
        raise ValueError(f"the blocked fft stage needs (K, B, {2 * m}), got {tuple(z.shape)}")
    dev = _check("the fft stage", z)
    reason = stage_unsupported(k, b * m, n, z.dtype)
    if reason is not None:
        raise ValueError(f"the fft stage {reason}")
    w = _w(_w_cat, n, "float32", bool(inverse), float(scale), like=z)
    if k != w.shape[0]:
        raise ValueError(f"the fft stage contracts {k} rows with an {w.shape[0]}-point stage matrix")
    if dev.type == "cpu":
        ore, oim = _stage(z[..., :m], z[..., m:], w, n)
        return ore, oim
    z = z.contiguous()
    (ore, oim), o_re, o_im, ldo, es_out = _stage_out(b * m, n, dev, "planes")
    base = z.data_ptr()
    _launch_stage(base, base + 4 * m, b * 2 * m, 1, m, 2 * m, k, b * m, n, w, o_re, o_im, ldo, es_out, dev)
    FFT_STAGE_LAUNCHES += 1
    return ore.reshape(b, m, n), oim.reshape(b, m, n)


def _stage_pair_fused(z, n: int, inverse: bool, scale: float, planes: bool = False):
    """K4: z is (K, ...rest, 2, m); out (...rest, m, 2, n) in cat layout, or
    with ``planes`` the (re, im) pair of (...rest, m, n) planes (on the card
    the real and imaginary views of one complex64 tensor)."""
    global FFT_PAIR_LAUNCHES
    k = int(z.shape[0])
    rest = tuple(int(s) for s in z.shape[1:-2])
    m = int(z.shape[-1])
    if z.ndim < 3 or int(z.shape[-2]) != 2:
        raise ValueError(f"the fft pair stage needs (K, ..., 2, m), got {tuple(z.shape)}")
    b = int(np.prod(rest, dtype=np.int64))
    dev = _check("the fft pair stage", z)
    reason = stage_unsupported(k, b * m, n, z.dtype)
    if reason is not None:
        raise ValueError(f"the fft pair stage {reason}")
    w = _w(_w_cat, n, "float32", bool(inverse), float(scale), like=z)
    if k != w.shape[0]:
        raise ValueError(f"the fft pair stage contracts {k} rows with an {w.shape[0]}-point stage matrix")
    if dev.type == "cpu":
        z3 = z.reshape(k, b, 2 * m)
        re2, im2 = z3[..., :m].reshape(k, b * m), z3[..., m:].reshape(k, b * m)
        out = _pair_plain(re2, im2, w, n)
        if planes:
            return out[:, :n].reshape(*rest, m, n), out[:, n:].reshape(*rest, m, n)
        return out.reshape(*rest, m, 2, n)
    z = z.contiguous()
    out, o_re, o_im, ldo, es_out = _stage_out(b * m, n, dev, "complex" if planes else "cat")
    base = z.data_ptr()
    _launch_stage(base, base + 4 * m, b * 2 * m, 1, m, 2 * m, k, b * m, n, w, o_re, o_im, ldo, es_out, dev)
    FFT_PAIR_LAUNCHES += 1
    if planes:
        out = out.reshape(*rest, m, n)
        return out.real, out.imag
    return out.reshape(*rest, m, 2, n)


def _entry_pair_fused(re, im, n: int, inverse: bool):
    """K4 as the complex ENTRY: separate (K, ...rest) planes in, cat-layout
    pair tensor (...rest, 2, n) out.  The real and imaginary views of one
    complex64 tensor are read in place."""
    global FFT_PAIR_LAUNCHES
    k = int(re.shape[0])
    rest = tuple(int(s) for s in re.shape[1:])
    m_total = int(np.prod(rest, dtype=np.int64))
    dev = _check("the fft pair stage", re, im)
    if re.shape != im.shape:
        raise ValueError(f"the fft pair stage: planes {tuple(re.shape)} and {tuple(im.shape)}")
    reason = stage_unsupported(k, m_total, n, re.dtype)
    if reason is not None:
        raise ValueError(f"the fft pair stage {reason}")
    w = _w(_w_cat, n, "float32", bool(inverse), 1.0, like=re)
    if k != w.shape[0]:
        raise ValueError(f"the fft pair stage contracts {k} rows with an {w.shape[0]}-point stage matrix")
    if dev.type == "cpu":
        return _pair_plain(re.reshape(k, m_total), im.reshape(k, m_total), w, n).reshape(*rest, 2, n)
    a_re, a_im, es, keep = _planes_source(re, im)
    out, o_re, o_im, ldo, es_out = _stage_out(m_total, n, dev, "cat")
    _launch_stage(a_re, a_im, m_total * es, es, m_total, 0, k, m_total, n, w, o_re, o_im, ldo, es_out, dev)
    FFT_PAIR_LAUNCHES += 1
    return out.reshape(*rest, 2, n)


def _stage_auto(re, im, n: int, inverse: bool, scale: float):
    """K3 where its gate admits the planes, else the plain cat-product stage
    (the f64 route), the scale folded into the matrix either way."""
    m_total = int(np.prod(re.shape[1:], dtype=np.int64))
    if stage_unsupported(int(re.shape[0]), m_total, n, re.dtype) is None:
        return _stage_fused(re, im, n, inverse, scale)
    return _stage(re, im, _w(_w_cat, n, _dt(re), inverse, float(scale), like=re), n)


def _stage_pair_auto(z, n: int, inverse: bool, scale: float, planes: bool = False):
    """K4 where its gate admits z, else the pair-block product."""
    b = int(np.prod(z.shape[1:-2], dtype=np.int64))
    if stage_unsupported(int(z.shape[0]), b * int(z.shape[-1]), n, z.dtype) is None:
        return _stage_pair_fused(z, n, inverse, scale, planes)
    out = _stage_pair(z, n, inverse, scale)
    return (out[..., 0, :], out[..., 1, :]) if planes else out


# ----------------------------------------------------------------------
# Hermitian extension (axis 0): out rows 0..m-1 are the combined half
# spectrum, row m the Nyquist plane, rows m+1..n-1 the mirrored source row
# with both trailing axes mapped k -> (n-k) % n and im negated
# ----------------------------------------------------------------------
def _ext_xla(ere, eim, nyr, nyi):
    """The extension by roll/flip/concat (the f64 route, and with the
    combine in front K5's plain version)."""
    m = int(ere.shape[0])
    return (
        torch.cat([ere, nyr[None], hermitian_upper(ere, m - 1)], 0),
        torch.cat([eim, nyi[None], -hermitian_upper(eim, m - 1)], 0),
    )


def _ext_fused(zr, zi, nyr, nyi):
    """K5: raw exit products (m, n1, 2*n2) and the Nyquist planes (n1, n2)
    -> the full (2m, n1, n2) spectrum; on the card the real and imaginary
    views of one complex64 tensor."""
    global FFT_EXT_LAUNCHES
    m, n1, n2t = (int(s) for s in zr.shape)
    n2 = n2t // 2
    dev = _check("the fft extension", zr, zi, nyr, nyi)
    if zi.shape != zr.shape or n2t != 2 * n2 or tuple(nyr.shape) != (n1, n2) or tuple(nyi.shape) != (n1, n2):
        raise ValueError(
            f"the fft extension needs (m, n1, 2*n2) products and (n1, n2) Nyquist planes, got "
            f"{tuple(zr.shape)}, {tuple(zi.shape)}, {tuple(nyr.shape)}, {tuple(nyi.shape)}"
        )
    reason = ext_unsupported(m, n1, n2, zr.dtype)
    if reason is not None:
        raise ValueError(f"the fft extension {reason}")
    if dev.type == "cpu":
        ere = zr[..., :n2] - zi[..., n2:]
        eim = zr[..., n2:] + zi[..., :n2]
        return _ext_xla(ere, eim, nyr, nyi)
    zr, zi, nyr, nyi = (t.contiguous() for t in (zr, zi, nyr, nyi))
    out = torch.empty((2 * m, n1, n2), dtype=torch.complex64, device=dev)
    o = torch.view_as_real(out)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _ext_lib().heat_fft_ext_f32(
            zr.data_ptr(), zi.data_ptr(), nyr.data_ptr(), nyi.data_ptr(), m, n1, n2,
            o.data_ptr(), o.data_ptr() + 4, 2, stream,
        )
    if err != 0:
        raise RuntimeError(f"fft extension kernel launch failed: CUDA error {err}")
    FFT_EXT_LAUNCHES += 1
    return out.real, out.imag


def leading_eligible(re: torch.Tensor, axes, im_present: bool) -> bool:
    """2-D/3-D all-axes full-length f32/f64 transforms; the real path (no
    im) halves axis 0, so n0 must be even."""
    nd = re.ndim
    if nd not in (2, 3) or len(axes) != nd:
        return False
    if re.dtype not in (torch.float32, torch.float64):
        return False
    if sorted(a % nd for a in axes) != list(range(nd)):
        return False
    if any(int(s) < 2 for s in re.shape):
        return False
    if not im_present and int(re.shape[0]) % 2 != 0:
        return False
    return True


def _alt(n: int, like: torch.Tensor) -> torch.Tensor:
    """(+1, -1, +1, ...) of length n: bin n/2 of a DFT is the alternating sum."""
    return torch.from_numpy(np.where(np.arange(n) % 2 == 0, 1.0, -1.0).astype(_dt(like))).to(like.device)


def rfft3_leading(x: torch.Tensor, norm) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full 3-D spectrum of a real (n0, n1, n2) array, all axes.

    Axis 0 is halved to m = n0//2 bins (the Nyquist bin rides a side chain),
    the three stages contract the leading dim in turn, and the Hermitian
    upper half is assembled by K5.  Float32: the cat entry product, K3's
    blocked form, the exit products left uncombined, K5."""
    n0, n1, n2 = (int(s) for s in x.shape)
    m = n0 // 2
    dt = _dt(x)
    s = scale_factor([n0, n1, n2], norm, False)

    wc1 = _w(_w_cat, n1, dt, False, 1.0, like=x)
    wc2 = _w(_w_cat, n2, dt, False, float(s), like=x)  # norm folded into the exit
    if stage_unsupported(n1, n2 * m, n1, x.dtype) is None:
        # one cat entry product (x read once) feeding the blocked mid kernel
        z = _dg0(x, _w(_w_entry_cat, n0, m, dt, like=x))  # (n1, n2, 2m)
        mre, mim = _stage_fused_blocked(z, n1, m, False, 1.0)  # (n2, m, n1)
        del z
    else:
        re = _dg0(x, _w(_w_entry_half, n0, m, dt, "re", like=x))  # (n1, n2, m)
        im = _dg0(x, _w(_w_entry_half, n0, m, dt, "im", like=x))
        mre, mim = _stage_auto(re, im, n1, False, 1.0)  # (n2, m, n1)
    fuse_ext = ext_unsupported(m, n1, n2, x.dtype) is None
    if fuse_ext:
        # the exit products stay uncombined: K5 folds the combine into its pass
        zr2 = _dg0(mre, wc2)  # (m, n1, 2n2)
        zi2 = _dg0(mim, wc2)
    else:
        ere, eim = _stage_auto(mre, mim, n2, False, float(s))  # (m, n1, n2)
    del mre, mim

    # Nyquist side chain: bin n0/2 of the axis-0 DFT is the alternating sum,
    # then an ordinary 2-D transform of that (real) plane
    with full_f32_matmul():
        nyq = torch.tensordot(_alt(n0, x), x, dims=([0], [0]))  # (n1, n2)
    a = _dg0(nyq, wc1)  # (n2, 2n1)
    br = _dg0(a[:, :n1], wc2)  # (n1, 2n2)
    bi = _dg0(a[:, n1:], wc2)
    nyr = br[:, :n2] - bi[:, n2:]
    nyi = br[:, n2:] + bi[:, :n2]

    if fuse_ext:
        return _ext_fused(zr2, zi2, nyr, nyi)
    return _ext_xla(ere, eim, nyr, nyi)


def rfft2_leading(x: torch.Tensor, norm) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full 2-D spectrum of a real (n0, n1) array, both axes: axis 0 halved
    through the cat entry product, one pair stage (K4), the Nyquist side
    chain and the 2-D mirror of the upper half."""
    n0, n1 = (int(s) for s in x.shape)
    m = n0 // 2
    dt = _dt(x)
    s = scale_factor([n0, n1], norm, False)

    z = _dg0(x, _w(_w_entry_cat, n0, m, dt, like=x))  # (n1, 2m)
    ere, eim = _stage_pair_auto(z.reshape(n1, 2, m), n1, False, float(s), planes=True)  # (m, k1) each
    del z

    with full_f32_matmul():
        nyq = torch.tensordot(_alt(n0, x), x, dims=([0], [0]))  # (n1,)
    a = _dg0(nyq, _w(_w_cat, n1, dt, False, float(s), like=x))  # (2n1,)
    nyr = a[:n1]
    nyi = a[n1:]

    def upper(p):
        return torch.roll(p[1:m], -1, 1).flip((0, 1))

    return (
        torch.cat([ere, nyr[None], upper(ere)], 0),
        torch.cat([eim, nyi[None], -upper(eim)], 0),
    )


def cfftn_leading(re: torch.Tensor, im: torch.Tensor, inverse: bool, norm) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full 2-D/3-D transform of a complex plane pair, all axes.

    The entry contracts axis 0 with the ``[W_re|W_im]`` / ``[-W_im|W_re]``
    pair and lands the pair-block layout (K4 as the entry); every later
    axis is one pair stage (K4), the last written as the result's planes.
    Norm is folded into the last stage's matrix."""
    nd = re.ndim
    shape = tuple(int(s) for s in re.shape)
    dt = _dt(re)
    s = scale_factor(list(shape), norm, inverse)

    n0 = shape[0]
    if stage_unsupported(n0, int(np.prod(shape[1:], dtype=np.int64)), n0, re.dtype) is None:
        z = _entry_pair_fused(re, im, n0, inverse)  # (*rest, 2, n0)
    else:
        z = _dg0(re, _w(_w_cat, n0, dt, inverse, 1.0, like=re)) + _dg0(
            im, _w(_w_cat_im, n0, dt, inverse, 1.0, like=re)
        )  # (*rest, 2n0) cat layout
        z = z.reshape(*shape[1:], 2, n0)
    for ax in range(1, nd - 1):
        z = _stage_pair_auto(z, shape[ax], inverse, 1.0)
    return _stage_pair_auto(z, shape[nd - 1], inverse, float(s), planes=True)
