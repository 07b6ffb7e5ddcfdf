"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

The fused Lloyd step of KMeans (the counterpart of
``heat_tpu/core/kernels.py::_lloyd_kernel``) is ``csrc/lloyd.cu``: one pass
over a rank's padded chunk of points gives the per-cluster sums, the member
counts, the inertia and, on request, the labels.  The wrapper
:func:`lloyd_partials` launches it for a CUDA tensor and raises where it
cannot; for a CPU tensor, and only there, it runs :func:`_lloyd_plain`, the
same function in plain PyTorch.  :func:`lloyd_update` adds the cross-rank sum
and the centre update.

Sums come back in float64: the kernel accumulates each block's columns in
f64 and adds the blocks in a fixed order, so a run is bitwise reproducible
and counts stay exact beyond 2^24 members.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build
from .linalg.basics import full_f32_matmul

__all__ = ["LLOYD_LAUNCHES", "lloyd_partials", "lloyd_unsupported", "lloyd_update"]

#: launches of the CUDA Lloyd kernel in this process (the plain version adds nothing)
LLOYD_LAUNCHES = 0

_TILE = 256  # points per tile and threads per block (lloyd.cu kTile)
_MAX_FEATURES = 128  # widest register tile lloyd.cu instantiates
_SMEM_LIMIT = 232448  # shared memory one block may use on Hopper (227 KB)
_PLAIN_ROWS = 1 << 20  # rows per chunk of the plain version


def _feature_bucket(f: int) -> int:
    for fb in (8, 16, 32, 64):
        if f <= fb:
            return fb
    return 128


def lloyd_smem_bytes(f: int, k: int) -> int:
    """Shared memory of one kernel block (mirrors ``smem_bytes`` in lloyd.cu)."""
    fb = _feature_bucket(f)
    w = k * f + k + 1
    warps = _TILE // 32
    return 4 * k * fb + 8 * w + 4 * (k + _TILE * (fb + 1) + 2 * warps * k + _TILE + warps)


def lloyd_unsupported(f: int, k: int) -> Optional[str]:
    """Why the CUDA kernel cannot take f features and k centres, or None."""
    if f < 1 or k < 1:
        return f"needs f >= 1 and k >= 1, got f={f}, k={k}"
    if f > _MAX_FEATURES:
        return f"holds a point in registers up to {_MAX_FEATURES} features, got f={f}"
    smem = lloyd_smem_bytes(f, k)
    if smem > _SMEM_LIMIT:
        return f"needs {smem} bytes of shared memory for f={f}, k={k}; a block has {_SMEM_LIMIT}"
    return None


def _lloyd_plain(xp: torch.Tensor, centers: torch.Tensor, n_true: int, labels: bool):
    """The fused step in plain PyTorch (matmul, argmin, index_add_), in
    chunks of rows; sums, counts and inertia are accumulated in float64."""
    rows, f = xp.shape
    k = centers.shape[0]
    dev = xp.device
    sums = torch.zeros((k, f), dtype=torch.float64, device=dev)
    counts = torch.zeros((k,), dtype=torch.float64, device=dev)
    inertia = torch.zeros((), dtype=torch.float64, device=dev)
    lab = torch.empty((rows,), dtype=torch.int64, device=dev) if labels else None
    c2 = torch.sum(centers * centers, dim=1)
    with full_f32_matmul():
        for start in range(0, rows, _PLAIN_ROWS):
            xc = xp[start : start + _PLAIN_ROWS]
            half = c2[None, :] - 2.0 * (xc @ centers.T)
            j = torch.argmin(half, dim=1)
            if lab is not None:
                lab[start : start + xc.shape[0]] = j
            nv = max(0, min(xc.shape[0], n_true - start))
            if nv == 0:
                continue
            xv, jv = xc[:nv], j[:nv]
            x2 = torch.sum(xv * xv, dim=1)
            vmin = torch.gather(half[:nv], 1, jv[:, None])[:, 0]
            sums.index_add_(0, jv, xv.to(torch.float64))
            counts.index_add_(0, jv, torch.ones((nv,), dtype=torch.float64, device=dev))
            inertia += torch.sum((x2 + vmin).to(torch.float64))
    return sums, counts, inertia, lab


def _lloyd_cuda(xp: torch.Tensor, centers: torch.Tensor, n_true: int, labels: bool):
    """Launch csrc/lloyd.cu on PyTorch's current stream (no synchronise)."""
    global LLOYD_LAUNCHES
    rows, f = xp.shape
    k = centers.shape[0]
    dev = xp.device
    nblocks = max(1, min(-(-rows // _TILE), _resident_blocks(dev, f, k)))
    w = k * f + k + 1
    partial = torch.empty((nblocks, w), dtype=torch.float64, device=dev)
    out = torch.empty((w,), dtype=torch.float64, device=dev)
    lab = torch.empty((rows,), dtype=torch.int64, device=dev) if labels else None
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.heat_lloyd_step_f32(
            xp.data_ptr(), centers.data_ptr(), rows, n_true, f, k,
            partial.data_ptr(), nblocks, out.data_ptr(),
            lab.data_ptr() if lab is not None else None, stream,
        )
    if err != 0:
        raise RuntimeError(f"lloyd kernel launch failed: CUDA error {err}")
    LLOYD_LAUNCHES += 1
    return out[: k * f].view(k, f), out[k * f : k * f + k], out[k * f + k], lab


_LIB = None
_RESIDENT: dict = {}


def _resident_blocks(dev: torch.device, f: int, k: int) -> int:
    """Blocks the card holds at once for (f, k): the grid of the kernel.
    A larger grid would leave blocks queued behind whole grid-stride loops."""
    key = (dev.index, f, k)
    if key not in _RESIDENT:
        per_sm = _lib().heat_lloyd_blocks_per_sm(f, k)
        if per_sm < 1:
            raise RuntimeError(f"the CUDA Lloyd kernel cannot be resident for f={f}, k={k}")
        _RESIDENT[key] = per_sm * torch.cuda.get_device_properties(dev).multi_processor_count
    return _RESIDENT[key]


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("lloyd")
        fn = lib.heat_lloyd_step_f32
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        lib.heat_lloyd_blocks_per_sm.argtypes = [ctypes.c_int64, ctypes.c_int64]
        lib.heat_lloyd_blocks_per_sm.restype = ctypes.c_int64
        _LIB = lib
    return _LIB


def lloyd_partials(xp: torch.Tensor, centers: torch.Tensor, n_true: int, labels: bool = False):
    """One rank's fused Lloyd pass: ``(sums (k, f), counts (k,), inertia ())``
    in float64, plus the int64 labels of all ``xp`` rows (or None).  Rows at
    or past ``n_true`` add nothing.

    A CPU tensor runs the plain version; a CUDA tensor runs the kernel or
    raises."""
    if xp.ndim != 2 or centers.ndim != 2 or xp.shape[1] != centers.shape[1]:
        raise ValueError(f"need points (rows, f) and centres (k, f), got {tuple(xp.shape)} and {tuple(centers.shape)}")
    if xp.device != centers.device:
        raise ValueError(f"points on {xp.device} and centres on {centers.device}")
    n_true = int(n_true)
    if xp.device.type == "cpu":
        return _lloyd_plain(xp, centers.to(xp.dtype), n_true, labels)
    if xp.device.type != "cuda":
        raise ValueError(f"no Lloyd kernel for device {xp.device}")
    if xp.dtype != torch.float32 or centers.dtype != torch.float32:
        raise TypeError(f"the CUDA Lloyd kernel takes float32, got {xp.dtype} points and {centers.dtype} centres")
    if not xp.is_contiguous():
        raise ValueError("the CUDA Lloyd kernel needs contiguous points")
    reason = lloyd_unsupported(xp.shape[1], centers.shape[0])
    if reason is not None:
        raise ValueError(f"the CUDA Lloyd kernel {reason}")
    return _lloyd_cuda(xp, centers.contiguous(), n_true, labels)


def _postprocess(sums: torch.Tensor, counts: torch.Tensor, centers: torch.Tensor):
    """New centres (an empty cluster keeps its old centre) and the shift
    ``sum((new - old)^2)`` (heat_tpu/core/kernels.py::_postprocess)."""
    mean = sums / torch.clamp(counts, min=1.0)[:, None]
    new = torch.where(counts[:, None] > 0, mean, centers.to(torch.float64)).to(centers.dtype)
    shift = torch.sum((new.to(torch.float32) - centers.to(torch.float32)) ** 2)
    return new, shift


def _lloyd_single(xp: torch.Tensor, centers: torch.Tensor, n_true: int, labels: bool = False, comm=None):
    """One Lloyd step on one chunk: ``(new_centers, shift, inertia[,
    labels])``.  With ``comm``, the partial sums are added over its ranks
    (one all-reduce of k*f + k + 1 values) before the centres move."""
    sums, counts, inertia, lab = lloyd_partials(xp, centers, n_true, labels)
    if comm is not None and comm.size > 1:
        k, f = centers.shape
        packed = comm.psum(torch.cat([sums.reshape(-1), counts, inertia.reshape(1)]))
        sums, counts, inertia = packed[: k * f].view(k, f), packed[k * f : k * f + k], packed[k * f + k]
    new, shift = _postprocess(sums, counts, centers)
    out = (new, shift, inertia.to(torch.float32))
    return out + (lab,) if labels else out


def lloyd_update(x, centers: torch.Tensor, labels: bool = False) -> Tuple[torch.Tensor, ...]:
    """One fused Lloyd iteration on a DNDarray of points split along rows (or
    not split): ``(new_centers, shift, inertia[, labels])``.

    Each rank runs the fused pass on its padded chunk; for split points one
    all-reduce of the partial sums follows.  ``labels`` are this rank's, one
    per row of its padded chunk."""
    if x.split == 0:
        return _lloyd_single(x.larray_padded, centers, x.lshape[0], labels, x.comm)
    if x.split is None:
        return _lloyd_single(x.larray_padded, centers, x.shape[0], labels)
    raise NotImplementedError(f"the fused Lloyd step takes points split along rows or not split, got split={x.split}")
