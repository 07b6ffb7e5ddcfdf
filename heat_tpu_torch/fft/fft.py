"""Distributed FFT (counterpart of heat_tpu/fft/fft.py, its 22 exports).

A DNDarray of the port holds a native complex tensor; a transform takes it
apart into (re, im) planes, runs the planar engines of ``_planar.py`` and
``_leading.py`` (the reference's accelerator route, with the hand-written
kernels K3-K6 on the card and their plain versions on the CPU), and puts
the result back together as one complex tensor.

Distribution: axes other than the split axis are transformed on each rank's
chunk.  A transform along the split axis of an array of two or more
dimensions rides the pencil: one tiled all-to-all per live plane makes the
axis local (:meth:`Communication.all_to_all`), the axis is transformed, and
a second all-to-all puts the split back.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core import factories, types
from ..core.dndarray import DNDarray
from ..core.stride_tricks import sanitize_axis
from . import _planar as _pl

__all__ = [
    "fft",
    "fft2",
    "fftfreq",
    "fftn",
    "fftshift",
    "hfft",
    "hfft2",
    "hfftn",
    "ifft",
    "ifft2",
    "ifftn",
    "ifftshift",
    "ihfft",
    "ihfft2",
    "ihfftn",
    "irfft",
    "irfft2",
    "irfftn",
    "rfft",
    "rfft2",
    "rfftfreq",
    "rfftn",
]


def _check(x):
    if not isinstance(x, DNDarray):
        raise TypeError(f"x must be a DNDarray, is {type(x)}")


def _promote_plane(buf: torch.Tensor) -> torch.Tensor:
    """A real plane of at least float32 (integers and half types promote)."""
    if not buf.is_floating_point() or buf.element_size() < 4:
        return buf.to(torch.float32)
    return buf


def _planes(t: torch.Tensor):
    """(re, im | None) planes of a local tensor."""
    if t.is_complex():
        return t.real, t.imag
    return _promote_plane(t), None


def _wrap(x: DNDarray, re, im, gshape, split) -> DNDarray:
    arr = re if im is None else _pl.as_complex(re, im)
    return DNDarray(arr, gshape, types.canonical_heat_type(arr.dtype), split, x.device, x.comm)


def _planar_prog(kind: str, norm, axes_ns):
    """The whole transform chain of one call as a function of the planes."""

    def run(re, im):
        if kind in ("fft", "ifft"):
            inv = kind == "ifft"
            full = all(n is None for _, n in axes_ns)
            axes_l = [a for a, _ in axes_ns]
            if not inv and im is None and len(axes_ns) >= 2 and full:
                # real input, full lengths: half spectrum + Hermitian extension
                return _pl.real_fftn(re, axes_l, norm)
            if len(axes_ns) in (2, 3) and full:
                if im is not None and _pl._interleaved_eligible(re, axes_l):
                    from . import _leading

                    if _leading.leading_eligible(re, axes_l, True):
                        return _leading.cfftn_leading(re, im, inv, norm)
                    if re.ndim == 3:
                        return _pl.cfft3_interleaved(re, im, inv, norm)
                    return _pl.cfft2_interleaved(re, im, inv, norm)
                if im is None and inv and _pl._interleaved_eligible(re, axes_l):
                    # ifftn of a REAL array: conj(fft(x))/N
                    fre, fim = _pl.real_fftn(re, axes_l, None)
                    return _pl._scaled(fre, -fim, _pl.scale_factor([re.shape[a] for a in axes_l], norm, True))
            for a, n in axes_ns:
                re, im = _pl.fft1(re, im, a, n, norm, inv)
            return re, im
        if kind in ("rfft", "ihfft"):
            if (
                im is None
                and len(axes_ns) in (2, 3)
                and all(n is None for _, n in axes_ns)
                and tuple(a for a, _ in axes_ns) == tuple(range(len(axes_ns)))
                and _pl._interleaved_eligible(re, [a for a, _ in axes_ns])
            ):
                # rfftn/rfft2 stop at the half spectrum; ihfftn is conj(rfftn)/N
                half = _pl.rfft3_half_interleaved if re.ndim == 3 else _pl.rfft2_half_interleaved
                if kind == "rfft":
                    return half(re, norm)
                fre, fim = half(re, None)
                return _pl._scaled(fre, -fim, _pl.scale_factor(list(re.shape), norm, True))
            last_a, last_n = axes_ns[-1]
            op = _pl.rfft1 if kind == "rfft" else _pl.ihfft1
            re, im = op(re, last_a, last_n, norm)
            inv = kind == "ihfft"
            for a, n in axes_ns[:-1]:
                re, im = _pl.fft1(re, im, a, n, norm, inv)
            return re, im
        # irfft / hfft: complex passes first, the real-output op last
        inv = kind == "irfft"
        if (
            im is not None
            and len(axes_ns) in (2, 3)
            and all(n is None for _, n in axes_ns[:-1])
            and tuple(a for a, _ in axes_ns) == tuple(range(len(axes_ns)))
            and _pl._interleaved_eligible(re, [a for a, _ in axes_ns])
        ):
            n_out = axes_ns[-1][1]
            n_out = int(n_out) if n_out is not None else 2 * (re.shape[-1] - 1)
            if n_out >= 2:
                ir = _pl.irfft3_interleaved if re.ndim == 3 else _pl.irfft2_interleaved
                if kind == "irfft":
                    return ir(re, im, n_out, norm), None
                # hfftn = irfftn(conj a) * N with forward-family norms
                lengths = list(re.shape[:-1]) + [n_out]
                out = ir(re, -im, n_out, "forward")
                return _pl._scaled(out, None, _pl.scale_factor(lengths, norm, False))[0], None
        for a, n in axes_ns[:-1]:
            re, im = _pl.fft1(re, im, a, n, norm, inv)
        last_a, last_n = axes_ns[-1]
        op = _pl.irfft1 if kind == "irfft" else _pl.hfft1
        return op(re, im, last_a, last_n, norm), None

    return run


def _pencil_out_len(op_kind: str, n_true: int, n_param) -> int:
    """Global output length along the transform axis (numpy semantics)."""
    if op_kind in ("fft", "ifft"):
        return n_param if n_param is not None else n_true
    if op_kind in ("rfft", "ihfft"):
        n = n_param if n_param is not None else n_true
        return n // 2 + 1
    # irfft / hfft: Hermitian input of length m -> real signal of n_out
    return n_param if n_param is not None else 2 * (n_true - 1)


def _pad_axis(t: torch.Tensor, axis: int, extent: int) -> torch.Tensor:
    """``t`` zero-padded along ``axis`` to ``extent``."""
    pad = extent - t.shape[axis]
    if pad == 0:
        return t
    widths = list(t.shape)
    widths[axis] = pad
    return torch.cat([t, t.new_zeros(widths)], dim=axis)


def _pencil_planar_kind_fn(comm, op_kind: str, axis: int, partner: int, n_true: int, n_param, norm, re, im):
    """ANY transform kind along the split axis through two all_to_alls per
    live plane: the split axis is made local (the partner axis is cut over
    the ranks instead), its padding dropped, the axis transformed with
    numpy's ``n`` semantics, padded to the canonical extent and sent back.
    Real-input kinds ship one plane in, real-output kinds one plane back."""
    tre = comm.all_to_all(re, split_axis=partner, concat_axis=axis).narrow(axis, 0, n_true)
    tim = comm.all_to_all(im, split_axis=partner, concat_axis=axis).narrow(axis, 0, n_true) if im is not None else None
    if op_kind in ("fft", "ifft"):
        ore, oim = _pl.fft1(tre, tim, axis, n_param, norm, op_kind == "ifft")
    elif op_kind == "rfft":
        ore, oim = _pl.rfft1(tre, axis, n_param, norm)
    elif op_kind == "ihfft":
        ore, oim = _pl.ihfft1(tre, axis, n_param, norm)
    else:
        op = _pl.irfft1 if op_kind == "irfft" else _pl.hfft1
        ore, oim = op(tre, tim, axis, n_param, norm), None
    m_pad = comm.padded_extent(_pencil_out_len(op_kind, n_true, n_param))
    rre = comm.all_to_all(_pad_axis(ore, axis, m_pad), split_axis=axis, concat_axis=partner)
    if oim is None:
        return (rre,)
    return rre, comm.all_to_all(_pad_axis(oim, axis, m_pad), split_axis=axis, concat_axis=partner)


def _pencil_pick_partner(gshape, split: int, comm) -> Optional[int]:
    """Partner axis for the pencil all_to_all: a divisible axis if one
    exists, else the axis with the least relative padding."""
    best, best_frac = None, None
    for d in range(len(gshape)):
        if d == split:
            continue
        pad = comm.pad_amount(gshape[d])
        if pad == 0:
            return d
        frac = pad / (gshape[d] + pad)
        if best is None or frac < best_frac:
            best, best_frac = d, frac
    return best


def _pencil_apply_planar(re, im, gshape, split, op_kind, n_param, norm, comm):
    """One split-axis transform via the pencil, on this rank's PADDED planes.
    Returns (planes, new gshape); a non-divisible partner is padded locally
    before and cut after (padding a non-split axis moves no data)."""
    partner = _pencil_pick_partner(gshape, split, comm)
    padded = comm.padded_extent(gshape[partner])
    re = _pad_axis(re, partner, padded)
    im = _pad_axis(im, partner, padded) if im is not None else None
    out = _pencil_planar_kind_fn(comm, op_kind, split, partner, gshape[split], n_param, norm, re, im)
    out = tuple(o.narrow(partner, 0, gshape[partner]) for o in out)
    m_out = _pencil_out_len(op_kind, gshape[split], n_param)
    return out, tuple(m_out if d == split else s for d, s in enumerate(gshape))


def _planar_split_chain(y: DNDarray, kind: str, axes_ns, norm) -> DNDarray:
    """Transform chain of an array split along one of its transform axes:
    the split-axis pass rides the pencil, every other pass runs on this
    rank's padded chunk (axis != split, so the padding is never mixed in)."""
    comm, split = y.comm, y.split
    if kind in ("fft", "ifft"):
        ops = [(kind, a, n) for a, n in axes_ns]
    elif kind in ("rfft", "ihfft"):
        rest = "fft" if kind == "rfft" else "ifft"
        ops = [(kind, *axes_ns[-1])] + [(rest, a, n) for a, n in axes_ns[:-1]]
    else:  # irfft / hfft: complex passes first, real-output op last
        rest = "ifft" if kind == "irfft" else "fft"
        ops = [(rest, a, n) for a, n in axes_ns[:-1]] + [(kind, *axes_ns[-1])]

    re, im = _planes(y.larray_padded)
    gshape = y.shape
    for op_kind, a, n in ops:
        if a == split:
            planes, gshape = _pencil_apply_planar(re, im, gshape, split, op_kind, n, norm, comm)
            re = planes[0]
            im = planes[1] if len(planes) == 2 else None
        else:
            re, im = _planar_prog(op_kind, norm, ((a, n),))(re, im)
            m_out = _pencil_out_len(op_kind, gshape[a], n)
            gshape = tuple(m_out if d == a else s for d, s in enumerate(gshape))
    return _wrap(y, re, im, gshape, split)


def _planar_entry(x: DNDarray, kind: str, axes_ns, norm) -> DNDarray:
    """Planar transform chain; split-axis passes use the pencil."""
    if kind in ("rfft", "ihfft") and types.heat_type_is_complexfloating(x.dtype):
        raise TypeError(f"{kind} requires a real-typed DNDarray, is {x.dtype.__name__}")
    axes_ns = tuple((int(a), None if n is None else int(n)) for a, n in axes_ns)
    split = x.split
    if split is not None and x.comm.size > 1 and any(a == split for a, _ in axes_ns):
        if x.ndim >= 2:
            return _planar_split_chain(x, kind, axes_ns, norm)
        # a split 1-D array: its one axis is gathered
        out_re, out_im = _planar_prog(kind, norm, axes_ns)(*_planes(x._dense()))
        arr = out_re if out_im is None else _pl.as_complex(out_re, out_im)
        return DNDarray.from_dense(arr, split, x.device, x.comm)
    # no transform axis is split (or one rank holds the split axis whole):
    # each rank transforms its padded chunk; an untransformed split axis
    # keeps its true extent, a transformed one takes the output's
    out_re, out_im = _planar_prog(kind, norm, axes_ns)(*_planes(x.larray_padded))
    transformed = {a for a, _ in axes_ns}
    gshape = tuple(
        x.shape[d] if d == split and d not in transformed else int(s) for d, s in enumerate(out_re.shape)
    )
    return _wrap(x, out_re, out_im, gshape, split)


def _axes2(x, axes):
    if axes is None:
        axes = (-2, -1)
    return tuple(sanitize_axis(x.shape, a) for a in axes)


def _nd_axes(arr, s, axes):
    """NumPy-style (s, axes) normalization for n-D transforms."""
    nd = arr.ndim
    if axes is None:
        axes = tuple(range(nd)) if s is None else tuple(range(nd - len(s), nd))
    else:
        axes = tuple(a % nd for a in axes)
    if s is None:
        s = (None,) * len(axes)
    return tuple(s), axes


def _axes_ns_of(x, s, axes) -> tuple:
    """(axis, n) pairs with numpy (s, axes) normalization."""
    s2, axes2 = _nd_axes(x, s, axes)
    return tuple(zip(axes2, s2))


def _nd_axes_arg(x, axes):
    return None if axes is None else tuple(sanitize_axis(x.shape, a) for a in axes)


# ----------------------------------------------------------------------
# 1-D transforms
# ----------------------------------------------------------------------
def fft(x: DNDarray, n: Optional[int] = None, axis: int = -1, norm: Optional[str] = None) -> DNDarray:
    """1-D complex FFT along ``axis``."""
    _check(x)
    return _planar_entry(x, "fft", ((sanitize_axis(x.shape, axis), n),), norm)


def ifft(x: DNDarray, n: Optional[int] = None, axis: int = -1, norm: Optional[str] = None) -> DNDarray:
    """1-D inverse FFT."""
    _check(x)
    return _planar_entry(x, "ifft", ((sanitize_axis(x.shape, axis), n),), norm)


def rfft(x: DNDarray, n: Optional[int] = None, axis: int = -1, norm: Optional[str] = None) -> DNDarray:
    """Real-input FFT; output truncated at Nyquist."""
    _check(x)
    if types.heat_type_is_complexfloating(x.dtype):
        raise TypeError(f"x must be a real-typed DNDarray, is {x.dtype.__name__}")
    return _planar_entry(x, "rfft", ((sanitize_axis(x.shape, axis), n),), norm)


def irfft(x: DNDarray, n: Optional[int] = None, axis: int = -1, norm: Optional[str] = None) -> DNDarray:
    """Inverse of rfft, real output."""
    _check(x)
    return _planar_entry(x, "irfft", ((sanitize_axis(x.shape, axis), n),), norm)


def hfft(x: DNDarray, n: Optional[int] = None, axis: int = -1, norm: Optional[str] = None) -> DNDarray:
    """FFT of a Hermitian-symmetric signal."""
    _check(x)
    return _planar_entry(x, "hfft", ((sanitize_axis(x.shape, axis), n),), norm)


def ihfft(x: DNDarray, n: Optional[int] = None, axis: int = -1, norm: Optional[str] = None) -> DNDarray:
    """Inverse Hermitian FFT."""
    _check(x)
    return _planar_entry(x, "ihfft", ((sanitize_axis(x.shape, axis), n),), norm)


# ----------------------------------------------------------------------
# 2-D / N-D transforms
# ----------------------------------------------------------------------
def fft2(x: DNDarray, s=None, axes=(-2, -1), norm=None) -> DNDarray:
    """2-D FFT."""
    _check(x)
    return _planar_entry(x, "fft", _axes_ns_of(x, s, _axes2(x, axes)), norm)


def ifft2(x: DNDarray, s=None, axes=(-2, -1), norm=None) -> DNDarray:
    """2-D inverse FFT."""
    _check(x)
    return _planar_entry(x, "ifft", _axes_ns_of(x, s, _axes2(x, axes)), norm)


def fftn(x: DNDarray, s=None, axes=None, norm=None) -> DNDarray:
    """N-D FFT."""
    _check(x)
    return _planar_entry(x, "fft", _axes_ns_of(x, s, _nd_axes_arg(x, axes)), norm)


def ifftn(x: DNDarray, s=None, axes=None, norm=None) -> DNDarray:
    """N-D inverse FFT."""
    _check(x)
    return _planar_entry(x, "ifft", _axes_ns_of(x, s, _nd_axes_arg(x, axes)), norm)


def rfft2(x: DNDarray, s=None, axes=(-2, -1), norm=None) -> DNDarray:
    """2-D real FFT."""
    _check(x)
    return _planar_entry(x, "rfft", _axes_ns_of(x, s, _axes2(x, axes)), norm)


def irfft2(x: DNDarray, s=None, axes=(-2, -1), norm=None) -> DNDarray:
    """2-D inverse real FFT."""
    _check(x)
    return _planar_entry(x, "irfft", _axes_ns_of(x, s, _axes2(x, axes)), norm)


def rfftn(x: DNDarray, s=None, axes=None, norm=None) -> DNDarray:
    """N-D real FFT."""
    _check(x)
    return _planar_entry(x, "rfft", _axes_ns_of(x, s, _nd_axes_arg(x, axes)), norm)


def irfftn(x: DNDarray, s=None, axes=None, norm=None) -> DNDarray:
    """N-D inverse real FFT."""
    _check(x)
    return _planar_entry(x, "irfft", _axes_ns_of(x, s, _nd_axes_arg(x, axes)), norm)


def hfft2(x: DNDarray, s=None, axes=(-2, -1), norm=None) -> DNDarray:
    """2-D Hermitian FFT."""
    _check(x)
    return _planar_entry(x, "hfft", _axes_ns_of(x, s, _axes2(x, axes)), norm)


def hfftn(x: DNDarray, s=None, axes=None, norm=None) -> DNDarray:
    """N-D Hermitian FFT."""
    _check(x)
    return _planar_entry(x, "hfft", _axes_ns_of(x, s, _nd_axes_arg(x, axes)), norm)


def ihfft2(x: DNDarray, s=None, axes=(-2, -1), norm=None) -> DNDarray:
    """2-D inverse Hermitian FFT."""
    _check(x)
    return _planar_entry(x, "ihfft", _axes_ns_of(x, s, _axes2(x, axes)), norm)


def ihfftn(x: DNDarray, s=None, axes=None, norm=None) -> DNDarray:
    """N-D inverse Hermitian FFT."""
    _check(x)
    return _planar_entry(x, "ihfft", _axes_ns_of(x, s, _nd_axes_arg(x, axes)), norm)


# ----------------------------------------------------------------------
# helpers
# ----------------------------------------------------------------------
def _freq(values: np.ndarray, dtype, split, device, comm) -> DNDarray:
    dt = types.float32 if dtype is None else types.canonical_heat_type(dtype)
    return factories.array(torch.from_numpy(values).to(dt.torch_type()), split=split, device=device, comm=comm)


def fftfreq(n: int, d: float = 1.0, dtype=None, split=None, device=None, comm=None) -> DNDarray:
    """Sample frequencies of fft (float32 unless ``dtype`` says otherwise)."""
    return _freq(np.fft.fftfreq(n, d=d), dtype, split, device, comm)


def rfftfreq(n: int, d: float = 1.0, dtype=None, split=None, device=None, comm=None) -> DNDarray:
    """Sample frequencies of rfft."""
    return _freq(np.fft.rfftfreq(n, d=d), dtype, split, device, comm)


def _shift(x: DNDarray, axes, inverse: bool) -> DNDarray:
    _check(x)
    if axes is None:
        axes = tuple(range(x.ndim))
    elif not isinstance(axes, (tuple, list)):
        axes = (axes,)
    axes = tuple(sanitize_axis(x.shape, a) for a in axes)
    shifts = [(-(x.shape[a] // 2) if inverse else x.shape[a] // 2) for a in axes]
    if x.split is None or x.split not in axes or x.comm.size == 1:
        return x._like(torch.roll(x.larray_padded, shifts, axes))  # every rolled axis is whole on each rank
    # a roll along the split axis: the array is gathered
    return DNDarray.from_dense(torch.roll(x._dense(), shifts, axes), x.split, x.device, x.comm)


def fftshift(x: DNDarray, axes=None) -> DNDarray:
    """Shift the zero frequency to the centre (a roll by n // 2 per axis)."""
    return _shift(x, axes, False)


def ifftshift(x: DNDarray, axes=None) -> DNDarray:
    """Inverse of fftshift."""
    return _shift(x, axes, True)
