"""Real-pair (planar) FFT engines (counterpart of heat_tpu/fft/_planar.py).

Every transform of the port works on two real planes (re, im), as the
reference's accelerator route does; the complex DNDarray is taken apart at
the entry and put together at the exit (``fft.py``).  The transform rides
matrix products:

* length ``n <= CUTOFF``: the DFT is a literal matrix product with the
  (symmetric) DFT matrix, 3-mult (Karatsuba) complex or 2-mult real input;
* larger ``n`` that factors as ``n1 * n2`` with ``n1 <= 128`` and
  ``n2 <= 8`` (float32): the fused axis pass, the hand-written kernel K6
  (:mod:`._axis_pass`);
* other composite ``n``: Bailey's four-step factorization, each factor
  recursing down to the matrix base case;
* prime ``n > CUTOFF``: Bluestein's chirp-z algorithm, a circular
  convolution of power-of-two length through the four-step.

The 2-D/3-D all-axes transforms take the leading-contraction engine
(:mod:`._leading`, kernels K3-K5) or, where it does not apply (a real input
of odd leading extent), the interleaved engines below.

The DFT matrices are built on the host in float64, exactly as the
reference builds them, and the products run in full float32 (no TF32):
:func:`heat_tpu_torch.core.linalg.basics.full_f32_matmul`.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.linalg.basics import full_f32_matmul
from ._weight_cache import byte_lru as _byte_lru
from ._weight_cache import on_device

__all__ = [
    "fft_planes",
    "fftn_planes",
    "real_fftn",
    "scale_factor",
    "fft1",
    "rfft1",
    "irfft1",
    "hfft1",
    "ihfft1",
]

#: largest DFT applied as one literal matrix product (the reference's default)
CUTOFF = 64


def _dt(t: torch.Tensor) -> str:
    """The numpy name of a tensor's dtype ("float32"), as the weight functions take it."""
    return str(t.dtype).replace("torch.", "")


def _w(make, *args, like: torch.Tensor):
    """The matrices ``make(*args)`` as tensors on ``like``'s device (cached)."""
    return on_device(make, *args, device=like.device)


def complex_source(re: torch.Tensor, im: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """The complex tensor whose real and imaginary views ``re`` and ``im``
    are, when they are exactly that (a kernel wrote its result in complex64
    and handed it on as planes); else None."""
    base = re._base
    if base is None or im is None or im._base is not base or not base.is_complex() or not base.is_contiguous():
        return None
    strides = tuple(2 * s for s in base.stride())
    if re.shape != base.shape or im.shape != base.shape or re.stride() != strides or im.stride() != strides:
        return None
    if re.data_ptr() != base.data_ptr() or im.data_ptr() != re.data_ptr() + re.element_size():
        return None
    return base


def as_complex(re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
    """One complex tensor of a plane pair, without a copy where the planes
    are the two views of one already."""
    src = complex_source(re, im)
    return src if src is not None else torch.complex(re, im)


def _mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    with full_f32_matmul():
        return torch.matmul(a, w)


@_byte_lru
def _dft_w(n: int, inverse: bool, dtype: str):
    """(W_re, W_im, W_re+W_im) for the symmetric n-point DFT matrix."""
    j = np.arange(n, dtype=np.float64)
    # angle built from jk mod n keeps the argument small
    jk = np.outer(j, j) % n
    ang = 2.0 * np.pi * jk / n
    sign = 1.0 if inverse else -1.0
    wre = np.cos(ang)
    wim = sign * np.sin(ang)
    return (
        np.asarray(wre, dtype),
        np.asarray(wim, dtype),
        np.asarray(wre + wim, dtype),
    )


@_byte_lru
def _twiddle(n1: int, n2: int, n: int, inverse: bool, dtype: str):
    """T[j1, k2] = exp(sign * 2*pi*i * j1*k2 / n) for the four-step."""
    j1 = np.arange(n1, dtype=np.float64)
    k2 = np.arange(n2, dtype=np.float64)
    jk = np.outer(j1, k2) % n
    ang = 2.0 * np.pi * jk / n
    sign = 1.0 if inverse else -1.0
    return np.asarray(np.cos(ang), dtype), np.asarray(sign * np.sin(ang), dtype)


def _cmul(are, aim, bre, bim):
    """Elementwise planar complex multiply (aim None means a real a)."""
    if aim is None:
        return are * bre, are * bim
    return are * bre - aim * bim, are * bim + aim * bre


def _apply_w(re, im, w) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., n) @ DFT matrix, 3-mult complex or 2-mult real-input."""
    wre, wim, wsum = w
    if im is None:
        return _mm(re, wre), _mm(re, wim)
    t1 = _mm(re, wre)
    t2 = _mm(im, wim)
    t3 = _mm(re + im, wsum)
    return t1 - t2, t3 - t1 - t2


@functools.lru_cache(maxsize=512)
def _largest_factor(n: int, cap: int) -> int:
    """Largest divisor of n that is <= cap (1 if n is prime past cap)."""
    best = 1
    d = 1
    while d * d <= n:
        if n % d == 0:
            if d <= cap:
                best = max(best, d)
            q = n // d
            if q <= cap:
                best = max(best, q)
        d += 1
    return best


def _next_pow2(n: int) -> int:
    m = 1
    while m < n:
        m <<= 1
    return m


def _einsum_w(spec: str, re, im, w) -> Tuple[torch.Tensor, torch.Tensor]:
    """Karatsuba complex DFT through an einsum spec."""
    wre, wim, wsum = w
    with full_f32_matmul():
        if im is None:
            return torch.einsum(spec, re, wre), torch.einsum(spec, re, wim)
        t1 = torch.einsum(spec, re, wre)
        t2 = torch.einsum(spec, im, wim)
        t3 = torch.einsum(spec, re + im, wsum)
    return t1 - t2, t3 - t1 - t2


def _fft_last(re, im, inverse: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unscaled DFT along the LAST axis; im may be None (real input).

    The route is the reference's accelerator route with its fused axis pass
    on (``HEAT_TPU_FFT_PALLAS=1``): the matrix base case up to ``CUTOFF``,
    Bluestein for primes past it, K6 where a float32 length has its factor
    pair, the four-step otherwise."""
    from . import _axis_pass

    n = re.shape[-1]
    dt = _dt(re)
    if n == 1:
        return re, torch.zeros_like(re) if im is None else im
    if n <= CUTOFF:
        return _apply_w(re, im, _w(_dft_w, n, inverse, dt, like=re))
    n1 = _largest_factor(n, CUTOFF)
    if n1 == 1:
        return _bluestein_last(re, im, inverse)
    batch = re.shape[:-1]
    if _axis_pass.axis_pass_unsupported(n, int(np.prod(batch, dtype=np.int64)), re.dtype) is None:
        return _axis_pass.fused_axis_pass(re, im, inverse)
    n2 = n // n1
    if n2 <= CUTOFF:
        # single-level four-step inside two einsums.
        # j = j1 + n1*j2: x[..., j2, j1]; A: DFT over j2 -> [..., k2, j1]
        re = re.reshape(*batch, n2, n1)
        im = im.reshape(*batch, n2, n1) if im is not None else None
        re, im = _einsum_w("...ji,jk->...ki", re, im, _w(_dft_w, n2, inverse, dt, like=re))
        tw_re, tw_im = _w(_twiddle, n1, n2, n, inverse, dt, like=re)  # [j1, k2]
        re, im = _cmul(re, im, tw_re.T, tw_im.T)  # planes are [..., k2, j1]
        # B: DFT over j1, output laid out [..., k1, k2]: the C-order ravel
        # IS the k = k2 + n2*k1 output order
        re, im = _einsum_w("...kj,jl->...lk", re, im, _w(_dft_w, n1, inverse, dt, like=re))
        return re.reshape(*batch, n), im.reshape(*batch, n)
    # deep factorization: j = j1 + n1*j2 puts x[j] at [..., j2, j1]
    re = re.reshape(*batch, n2, n1).transpose(-1, -2)  # (..., j1, j2)
    im = im.reshape(*batch, n2, n1).transpose(-1, -2) if im is not None else None
    re, im = _fft_last(re, im, inverse)  # DFT over j2 -> (..., j1, k2)
    re, im = _cmul(re, im, *_w(_twiddle, n1, n2, n, inverse, dt, like=re))
    re = re.transpose(-1, -2)  # (..., k2, j1)
    im = im.transpose(-1, -2)
    re, im = _fft_last(re, im, inverse)  # DFT over j1 -> (..., k2, k1)
    # output index k = k2 + n2*k1: ravel of the (k1, k2) layout
    re = re.transpose(-1, -2).reshape(*batch, n)
    im = im.transpose(-1, -2).reshape(*batch, n)
    return re, im


@_byte_lru
def _bluestein_consts(n: int, inverse: bool, dtype: str):
    """Chirp and the precomputed spectrum of the chirp filter."""
    m = _next_pow2(2 * n - 1)
    j = np.arange(n, dtype=np.int64)
    # j^2 mod 2n keeps the chirp angle small and exact
    ang = np.pi * ((j * j) % (2 * n)).astype(np.float64) / n
    sign = 1.0 if inverse else -1.0
    # c[j] = e^{sign*i*pi*j^2/n}: c[j]*c[k]*conj(c[k-j]) = e^{sign*2*pi*i*jk/n}
    chirp = np.cos(ang) + 1j * sign * np.sin(ang)
    b = np.zeros(m, dtype=np.complex128)
    conj_c = np.conj(chirp)
    b[:n] = conj_c
    b[m - n + 1:] = conj_c[1:n][::-1]  # b[m-j] = conj(c[j])
    B = np.fft.fft(b)  # a host constant, as in the reference
    return (
        np.asarray(chirp.real, dtype),
        np.asarray(chirp.imag, dtype),
        np.asarray(B.real, dtype),
        np.asarray(B.imag, dtype),
        m,
    )


def _bluestein_last(re, im, inverse: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chirp-z DFT for prime n past the matmul cutoff (last axis)."""
    n = re.shape[-1]
    are, aim, Bre, Bim, m = _w(_bluestein_consts, n, inverse, _dt(re), like=re)
    xre, xim = _cmul(re, im, are, aim)
    xre = torch.nn.functional.pad(xre, (0, m - n))
    xim = torch.nn.functional.pad(xim, (0, m - n))
    Xre, Xim = _fft_last(xre, xim, False)  # m is a power of two -> four-step
    Cre, Cim = _cmul(Xre, Xim, Bre, Bim)
    cre, cim = _fft_last(Cre, Cim, True)
    cre, cim = cre[..., :n] / m, cim[..., :n] / m  # unscaled inverse
    return _cmul(cre, cim, are, aim)


def fft_planes(re, im: Optional[torch.Tensor], axis: int, inverse: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unscaled planar DFT along ``axis``; ``im=None`` means real input."""
    axis = axis % re.ndim
    last = re.ndim - 1
    if axis != last:
        re = torch.movedim(re, axis, last)
        im = torch.movedim(im, axis, last) if im is not None else None
    re, im = _fft_last(re, im, inverse)
    if axis != last:
        re = torch.movedim(re, last, axis)
        im = torch.movedim(im, last, axis)
    return re, im


def scale_factor(lengths: Sequence[int], norm: Optional[str], inverse: bool) -> float:
    """Composite normalization over the transformed axis lengths."""
    total = 1.0
    for n in lengths:
        total *= float(n)
    if norm in (None, "backward"):
        return 1.0 / total if inverse else 1.0
    if norm == "ortho":
        return total ** -0.5
    if norm == "forward":
        return 1.0 if inverse else 1.0 / total
    raise ValueError(f'norm must be None, "ortho", "backward" or "forward", got {norm!r}')


def fftn_planes(re, im, axes: Sequence[int], inverse: bool, norm: Optional[str]):
    """Planar N-D DFT over ``axes`` with numpy norm semantics applied."""
    for ax in axes:
        re, im = fft_planes(re, im, ax, inverse)
    return _scaled(re, im, scale_factor([re.shape[a] for a in axes], norm, inverse))


# ----------------------------------------------------------------------
# interleaved-minor engines: the complex pair stored INSIDE the minor dim
# (z[..., 2k+c]), one real product against the 2x2-block DFT matrix per
# stage.  The port reaches them where the leading engine does not apply.
# ----------------------------------------------------------------------
@_byte_lru
def _w2_full(n: int, inverse: bool, dtype: str):
    """(2n, 2n) interleaved real form of the complex DFT matrix."""
    wre, wim = _dft_w(n, inverse, "float64")[:2]
    W = np.zeros((n, 2, n, 2), np.float64)
    W[:, 0, :, 0] = wre
    W[:, 1, :, 0] = -wim
    W[:, 0, :, 1] = wim
    W[:, 1, :, 1] = wre
    return np.asarray(W.reshape(2 * n, 2 * n), dtype)


@_byte_lru
def _w2_real_in(n: int, m: int, dtype: str):
    """(n, 2m) real-input DFT matrix truncated at the Nyquist bin."""
    wre, wim = _dft_w(n, False, "float64")[:2]
    W = np.stack([wre[:, :m], wim[:, :m]], axis=-1)  # (n, m, 2)
    return np.asarray(W.reshape(n, 2 * m), dtype)


@_byte_lru
def _w2_split(n: int, dtype: str, inverse: bool = False):
    """(2n, n) re and im column blocks of the full interleaved matrix."""
    W = _w2_full(n, inverse, dtype)
    return np.ascontiguousarray(W[:, 0::2]), np.ascontiguousarray(W[:, 1::2])


@_byte_lru
def _w2_row_split(n: int, dtype: str, inverse: bool = False):
    """(n, 2n) row blocks applying the DFT to a SEPARATE re / im plane:
    out_interleaved = re @ rows_re + im @ rows_im."""
    W = _w2_full(n, inverse, dtype)
    return np.ascontiguousarray(W[0::2, :]), np.ascontiguousarray(W[1::2, :])


def hermitian_upper(p: torch.Tensor, rows: int) -> torch.Tensor:
    """Upper-half mirror of a leading-axis half spectrum: rows 1..rows of
    ``p`` evaluated at ``p[n0-k0, (n1-k1)%n1, (n2-k2)%n2]`` (one roll, one
    flip of all three axes).  Negate the result for the imaginary plane."""
    u = p[1 : rows + 1]
    return torch.roll(u, shifts=(-1, -1), dims=(1, 2)).flip((0, 1, 2))


def _mm_merged(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """One matmul along the merged minor dim (the whole DFT stage)."""
    return _mm(a.reshape(-1, a.shape[-1]), w).reshape(*a.shape[:-1], w.shape[1])


def _mid_and_exit(z, n0: int, n1: int, inverse: bool, dt: str):
    """Stage X / stage Y / exit of both interleaved engines: z (lead, n1, 2n0)
    -> re, im planes (k0, k1, lead)."""
    lead = int(z.shape[0])
    z = _mm_merged(z, _w(_w2_full, n0, inverse, dt, like=z))  # (lead, n1, 2k0)
    z = z.reshape(lead, n1, n0, 2).permute(0, 2, 1, 3).reshape(lead, n0, 2 * n1)
    wre, wim = _w(_w2_split, n1, dt, inverse, like=z)
    re = _mm_merged(z, wre).permute(1, 2, 0)  # (k0, k1, lead)
    im = _mm_merged(z, wim).permute(1, 2, 0)
    return re, im


def rfft3_half_interleaved(x: torch.Tensor, norm) -> Tuple[torch.Tensor, torch.Tensor]:
    """numpy ``rfftn`` semantics for 3-D real input, all axes: the half
    spectrum (k0, k1, n2//2+1) of a real (n0, n1, n2) array."""
    n0, n1, n2 = (int(s) for s in x.shape)
    m2 = n2 // 2 + 1
    dt = _dt(x)
    z = _mm_merged(x, _w(_w2_real_in, n2, m2, dt, like=x))  # (n0, n1, 2m2)
    z = z.reshape(n0, n1, m2, 2).permute(2, 1, 0, 3).reshape(m2, n1, 2 * n0)
    re, im = _mid_and_exit(z, n0, n1, False, dt)  # (k0, k1, m2)
    return _scaled(re, im, scale_factor([n0, n1, n2], norm, False))


def _rfft3_interleaved(x: torch.Tensor, norm) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full 3-D spectrum of a real (n0, n1, n2) array, all axes, with axis 0
    halved to n0//2 + 1 bins and the Hermitian upper half mirrored."""
    n0, n1, n2 = (int(s) for s in x.shape)
    m0 = n0 // 2 + 1
    dt = _dt(x)
    W = _w(_w2_real_in, n0, m0, dt, like=x)
    with full_f32_matmul():
        z = torch.tensordot(x, W, dims=([0], [0]))  # (n1, n2, 2m0)
    z = z.reshape(n1, n2, m0, 2).permute(2, 1, 0, 3).reshape(m0, n2, 2 * n1)
    z = _mm_merged(z, _w(_w2_full, n1, False, dt, like=x))  # (m0, n2, 2k1)
    z = z.reshape(m0, n2, n1, 2).permute(0, 2, 1, 3).reshape(m0, n1, 2 * n2)
    wre, wim = _w(_w2_split, n2, dt, like=x)
    re_lo = _mm_merged(z, wre)  # (m0, k1, k2)
    im_lo = _mm_merged(z, wim)
    re = torch.cat([re_lo, hermitian_upper(re_lo, n0 - m0)], 0)
    im = torch.cat([im_lo, -hermitian_upper(im_lo, n0 - m0)], 0)
    return _scaled(re, im, scale_factor([n0, n1, n2], norm, False))


@_byte_lru
def _w_irfft_exit(m_used: int, n_out: int, dtype: str):
    """(2*m_used, n_out) c2r exit matrix: the Hermitian extension IS the
    matrix (weight 2 for interior bins, 1 for DC and an even-n Nyquist; the
    sin rows vanish there).  Unscaled."""
    k = np.arange(m_used, dtype=np.float64)
    x = np.arange(n_out, dtype=np.float64)
    ang = 2.0 * np.pi * np.outer(k, x) / n_out
    w = np.full(m_used, 2.0)
    w[0] = 1.0
    if n_out % 2 == 0 and m_used == n_out // 2 + 1:
        w[-1] = 1.0
    W = np.zeros((m_used, 2, n_out), np.float64)
    W[:, 0, :] = w[:, None] * np.cos(ang)
    W[:, 1, :] = -w[:, None] * np.sin(ang)
    return np.asarray(W.reshape(2 * m_used, n_out), dtype)


def irfft3_interleaved(re: torch.Tensor, im: torch.Tensor, n_out: int, norm) -> torch.Tensor:
    """numpy ``irfftn`` semantics: half spectrum (n0, n1, m2) -> real
    (n0, n1, n_out); inverse over axes 0 and 1 first, then the c2r exit
    matrix."""
    n0, n1, _ = (int(s) for s in re.shape)
    dt = _dt(re)
    m_used = n_out // 2 + 1
    re, im = _fit(re, im, 2, m_used)
    reT = re.permute(1, 2, 0)  # (n1, mu, n0)
    imT = im.permute(1, 2, 0)
    rrow, irow = _w(_w2_row_split, n0, dt, True, like=re)
    z = _mm_merged(reT, rrow) + _mm_merged(imT, irow)  # (n1, mu, 2k0)
    z = z.reshape(n1, m_used, n0, 2).permute(2, 1, 0, 3).reshape(n0, m_used, 2 * n1)
    z = _mm_merged(z, _w(_w2_full, n1, True, dt, like=re))  # (k0, mu, 2k1)
    z = z.reshape(n0, m_used, n1, 2).permute(0, 2, 1, 3).reshape(n0, n1, 2 * m_used)
    out = _mm_merged(z, _w(_w_irfft_exit, m_used, n_out, dt, like=re))  # (k0, k1, n_out)
    return _scaled(out, None, scale_factor([n0, n1, n_out], norm, True))[0]


def cfft3_interleaved(re, im, inverse: bool, norm) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full 3-D transform of a complex plane pair, all axes."""
    n0, n1, n2 = (int(s) for s in re.shape)
    dt = _dt(re)
    rrow, irow = _w(_w2_row_split, n2, dt, inverse, like=re)
    z = _mm_merged(re, rrow) + _mm_merged(im, irow)  # (n0, n1, 2k2)
    z = z.reshape(n0, n1, n2, 2).permute(2, 1, 0, 3).reshape(n2, n1, 2 * n0)
    re_o, im_o = _mid_and_exit(z, n0, n1, inverse, dt)  # (k0, k1, k2)
    return _scaled(re_o, im_o, scale_factor([n0, n1, n2], norm, inverse))


def cfft2_interleaved(re, im, inverse: bool, norm):
    """Full 2-D transform of a complex plane pair, both axes."""
    n0, n1 = (int(s) for s in re.shape)
    dt = _dt(re)
    rrow, irow = _w(_w2_row_split, n0, dt, inverse, like=re)
    z = _mm_merged(re.T, rrow) + _mm_merged(im.T, irow)  # (n1, 2k0)
    z = z.reshape(n1, n0, 2).permute(1, 0, 2).reshape(n0, 2 * n1)
    wre, wim = _w(_w2_split, n1, dt, inverse, like=re)
    return _scaled(_mm_merged(z, wre), _mm_merged(z, wim), scale_factor([n0, n1], norm, inverse))


def rfft2_half_interleaved(x, norm):
    """numpy ``rfft2``: real (n0, n1) -> (k0, n1//2+1)."""
    n0, n1 = (int(s) for s in x.shape)
    m1 = n1 // 2 + 1
    dt = _dt(x)
    z = _mm_merged(x, _w(_w2_real_in, n1, m1, dt, like=x))  # (n0, 2m1)
    z = z.reshape(n0, m1, 2).permute(1, 0, 2).reshape(m1, 2 * n0)
    wre, wim = _w(_w2_split, n0, dt, like=x)
    re = _mm_merged(z, wre).T  # (k0, m1)
    im = _mm_merged(z, wim).T
    return _scaled(re, im, scale_factor([n0, n1], norm, False))


def rfft2_full_interleaved(x, norm):
    """Full 2-D spectrum of a real array: half + Hermitian extension along
    the minor axis (full[x, k] = conj(full[rev x, n1-k]))."""
    n1 = int(x.shape[1])
    m1 = n1 // 2 + 1
    re_lo, im_lo = rfft2_half_interleaved(x, norm)

    def upper(p):
        return torch.roll(p[:, 1 : n1 - m1 + 1], -1, 0).flip((0, 1))

    return torch.cat([re_lo, upper(re_lo)], 1), torch.cat([im_lo, -upper(im_lo)], 1)


def irfft2_interleaved(re, im, n_out: int, norm):
    """numpy ``irfft2``: half spectrum (n0, m1) -> real (n0, n_out)."""
    n0 = int(re.shape[0])
    dt = _dt(re)
    m_used = n_out // 2 + 1
    re, im = _fit(re, im, 1, m_used)
    rrow, irow = _w(_w2_row_split, n0, dt, True, like=re)
    z = _mm_merged(re.T, rrow) + _mm_merged(im.T, irow)  # (mu, 2k0)
    z = z.reshape(m_used, n0, 2).permute(1, 0, 2).reshape(n0, 2 * m_used)
    out = _mm_merged(z, _w(_w_irfft_exit, m_used, n_out, dt, like=re))  # (k0, n_out)
    return _scaled(out, None, scale_factor([n0, n_out], norm, True))[0]


def _interleaved_eligible(re: torch.Tensor, axes) -> bool:
    nd = re.ndim
    return (
        nd in (2, 3)
        and len(axes) == nd
        and re.dtype in (torch.float32, torch.float64)
        and sorted(a % nd for a in axes) == list(range(nd))
        and all(int(s) >= 2 for s in re.shape)
    )


def real_fftn(re: torch.Tensor, axes: Sequence[int], norm) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full N-D FFT of a REAL array via half spectrum + Hermitian extension.

    The 2-D/3-D all-axes case takes the leading engine (even n0) or the
    interleaved one; anything else transforms the last axis's half spectrum
    through the other axes and mirrors the upper half."""
    if _interleaved_eligible(re, axes):
        from . import _leading

        if _leading.leading_eligible(re, axes, False):
            if re.ndim == 3:
                return _leading.rfft3_leading(re, norm)
            return _leading.rfft2_leading(re, norm)
        if re.ndim == 3:
            return _rfft3_interleaved(re, norm)
        return rfft2_full_interleaved(re, norm)
    axes = [a % re.ndim for a in axes]
    al = axes[-1]
    n = re.shape[al]
    m = n // 2 + 1
    fre, fim = fft_planes(re, None, al, False)
    fre, fim = fre.narrow(al, 0, m), fim.narrow(al, 0, m)
    for ax in axes[:-1]:
        fre, fim = fft_planes(fre, fim, ax, False)
    # upper half along the last axis: X[.., k] = conj(X[rev(..), n-k])
    src_last = torch.arange(n - m, 0, -1, device=re.device)  # n - k for k in [m, n)
    sub_re = torch.index_select(fre, al, src_last)
    sub_im = torch.index_select(fim, al, src_last)
    for ax in axes[:-1]:
        length = fre.shape[ax]
        rev = torch.cat([torch.zeros(1, dtype=torch.int64), torch.arange(length - 1, 0, -1)]).to(re.device)
        sub_re = torch.index_select(sub_re, ax, rev)
        sub_im = torch.index_select(sub_im, ax, rev)
    full_re = torch.cat([fre, sub_re], dim=al)
    full_im = torch.cat([fim, -sub_im], dim=al)
    return _scaled(full_re, full_im, scale_factor([re.shape[a] for a in axes], norm, False))


# ----------------------------------------------------------------------
# numpy-semantics 1-D ops on planes (fitting, real/Hermitian kinds, norms)
# ----------------------------------------------------------------------
def _fit(re, im, axis: int, n: int):
    """Truncate / zero-pad planes along ``axis`` to length ``n`` (numpy's
    pre-transform ``n`` semantics)."""
    axis = axis % re.ndim
    cur = re.shape[axis]
    if n == cur:
        return re, im
    if n < cur:
        return re.narrow(axis, 0, n), None if im is None else im.narrow(axis, 0, n)

    def pad(p):
        widths = list(p.shape)
        widths[axis] = n - cur
        return torch.cat([p, p.new_zeros(widths)], dim=axis)

    return pad(re), None if im is None else pad(im)


def _scaled(re, im, s: float):
    if s == 1.0:
        return re, im
    return re * s, None if im is None else im * s


def _hermitian_extend(re, im, axis: int, n_out: int):
    """Full-length spectrum from its first ``n_out//2+1`` bins:
    b[k] = a[k] for k < m, b[k] = conj(a[n_out-k]) above."""
    axis = axis % re.ndim
    m = n_out // 2 + 1
    re, im = _fit(re, im, axis, m)
    if im is None:
        im = torch.zeros_like(re)
    ext_idx = torch.arange(n_out - m, 0, -1, device=re.device)
    re_full = torch.cat([re, torch.index_select(re, axis, ext_idx)], dim=axis)
    im_full = torch.cat([im, -torch.index_select(im, axis, ext_idx)], dim=axis)
    return re_full, im_full


def fft1(re, im, axis: int, n: Optional[int], norm, inverse: bool):
    """numpy fft/ifft semantics on planes (complex in, complex out)."""
    n = n if n is not None else re.shape[axis]
    re, im = _fit(re, im, axis, n)
    re, im = fft_planes(re, im, axis, inverse)
    return _scaled(re, im, scale_factor([n], norm, inverse))


def rfft1(re, axis: int, n: Optional[int], norm):
    """numpy rfft: real input, spectrum truncated at Nyquist."""
    axis = axis % re.ndim
    n = n if n is not None else re.shape[axis]
    re, _ = _fit(re, None, axis, n)
    fre, fim = fft_planes(re, None, axis, False)
    m = n // 2 + 1
    return _scaled(fre.narrow(axis, 0, m), fim.narrow(axis, 0, m), scale_factor([n], norm, False))


def irfft1(re, im, axis: int, n: Optional[int], norm):
    """numpy irfft: Hermitian-extend, inverse transform, real output."""
    n_out = n if n is not None else 2 * (re.shape[axis] - 1)
    re_f, im_f = _hermitian_extend(re, im, axis, n_out)
    ore, _ = fft_planes(re_f, im_f, axis, True)
    return _scaled(ore, None, scale_factor([n_out], norm, True))[0]


def hfft1(re, im, axis: int, n: Optional[int], norm):
    """numpy hfft: forward transform of the Hermitian-extended signal, real
    output, forward-family norm scaling."""
    n_out = n if n is not None else 2 * (re.shape[axis] - 1)
    re_f, im_f = _hermitian_extend(re, im, axis, n_out)
    ore, _ = fft_planes(re_f, im_f, axis, False)
    return _scaled(ore, None, scale_factor([n_out], norm, False))[0]


def ihfft1(re, axis: int, n: Optional[int], norm):
    """numpy ihfft == conj(rfft)/n with inverse-family norm scaling."""
    n_in = n if n is not None else re.shape[axis]
    fre, fim = rfft1(re, axis, n_in, None)
    fre, fim = _scaled(fre, fim, scale_factor([n_in], norm, True))
    return fre, -fim
