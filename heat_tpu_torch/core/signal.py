"""Signal processing (counterpart of heat_tpu/core/signal.py).

One 1-D convolution, ``convolve``: on one rank (or with an unsplit kernel)
``torch.nn.functional.conv1d`` of the padded signal with the flipped kernel,
in IEEE arithmetic (the JAX package convolves at ``Precision.HIGHEST``; the
card's cuDNN would take TF32 by default, about 1e-3 off).  A kernel split
over several ranks is streamed: each round broadcasts one rank's chunk
(``comm.bcast``) and adds its shifted partial convolution, so no rank ever
holds the whole kernel.
"""

from __future__ import annotations

import contextlib

import torch

from ..parallel.comm import _as_bytes, _from_bytes
from .dndarray import DNDarray

__all__ = ["convolve"]


@contextlib.contextmanager
def _ieee_convolution():
    """Run the enclosed convolutions in IEEE float32 (no TF32 in cuDNN)."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def _conv1d_valid(signal: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """The valid convolution of two 1-D tensors of one floating type: the
    cross-correlation with the flipped kernel (complex by its four real
    products)."""
    if signal.is_complex():
        sr, si, kr, ki = signal.real, signal.imag, kernel.real, kernel.imag
        return torch.complex(_conv1d_valid(sr, kr) - _conv1d_valid(si, ki),
                             _conv1d_valid(sr, ki) + _conv1d_valid(si, kr))
    with _ieee_convolution():
        return torch.nn.functional.conv1d(signal[None, None, :], kernel.flip(0)[None, None, :])[0, 0]


def convolve(a, v, mode: str = "full") -> DNDarray:
    """1-D discrete convolution of ``a`` with the kernel ``v``.

    Modes: 'full' (default), 'same' (an odd kernel only) and 'valid'.  A
    kernel longer than the signal swaps with it in 'full' mode and raises
    otherwise.  Exact types compute in float64 and are rounded half to even;
    the result has ``a``'s split."""
    from . import factories, types

    if not isinstance(a, DNDarray):
        a = factories.array(a)
    if not isinstance(v, DNDarray):
        v = factories.array(v, comm=a.comm)
    if a.ndim != 1 or v.ndim != 1:
        raise ValueError("only 1-dimensional input DNDarrays are allowed")
    if mode == "same" and v.shape[0] % 2 == 0:
        raise ValueError("Mode 'same' cannot be used with even-sized kernel")
    if mode not in ("full", "same", "valid"):
        raise ValueError(f"Supported modes are 'full', 'same', 'valid', got {mode!r}")
    if v.shape[0] > a.shape[0]:
        if mode == "full":
            a, v = v, a
        else:
            raise ValueError("filter size must not be greater than the signal size in mode 'same'/'valid'")

    promoted = types.promote_types(a.dtype, v.dtype)
    exact = types.heat_type_is_exact(promoted)
    compute = torch.float64 if exact else promoted.torch_type()
    signal = a._dense().to(compute)
    if v.split is not None and v.comm.size > 1:
        out = _streamed_kernel_conv(signal, v, mode, compute)
    else:
        kernel = v._dense().to(signal.device, compute)
        k = kernel.shape[0]
        pad = {"full": k - 1, "same": k // 2, "valid": 0}[mode]
        out = _conv1d_valid(torch.nn.functional.pad(signal, (pad, pad)), kernel)
    if exact:
        out = torch.round(out)
    out = types._cast(out, types.canonical_heat_type(compute), promoted)
    return DNDarray.from_dense(out, a.split, a.device, a.comm, dtype=promoted)


def _streamed_kernel_conv(signal: torch.Tensor, v: DNDarray, mode: str, compute: torch.dtype) -> torch.Tensor:
    """Convolution with a kernel split over the ranks: full(a, v) is the sum
    over the kernel's chunks c of full(a, c) shifted by c's offset.  Round r
    broadcasts rank r's chunk (its padded length, the true part used); the
    mode's slice is taken from the accumulated full result."""
    comm = v.comm
    n, k = signal.shape[0], v.shape[0]
    mine = v.larray_padded.to(signal.device, compute)
    b = mine.shape[0]
    out = torch.zeros(n + k - 1, dtype=compute, device=signal.device)
    for r in range(comm.size):
        s = r * b
        w = min(k, s + b) - s
        if w <= 0:
            break
        chunk = _from_bytes(comm.bcast(_as_bytes(mine.clone()), root=r), compute)[:w]
        part = _conv1d_valid(torch.nn.functional.pad(signal, (w - 1, w - 1)), chunk)
        out[s:s + n + w - 1] += part
    if mode == "full":
        return out
    if mode == "same":
        return out[k // 2:k // 2 + n]
    return out[k - 1:n]
