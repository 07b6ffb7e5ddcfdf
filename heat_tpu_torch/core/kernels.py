"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

The fused Lloyd step of KMeans (the counterpart of
``heat_tpu/core/kernels.py::_lloyd_kernel``) is ``csrc/lloyd.cu``: one pass
over a rank's padded chunk of points gives the per-cluster sums, the member
counts, the inertia and, on request, the labels.  The wrapper
:func:`lloyd_partials` launches it for a CUDA tensor and raises where it
cannot; for a CPU tensor, and only there, it runs :func:`_lloyd_plain`, the
same function in plain PyTorch.  :func:`lloyd_update` adds the cross-rank sum
and the centre update.  The kernel has two routes, chosen by shape in
:func:`lloyd_route`: ``"tc"`` (per-warp batches, the sums as one-hot products
on the tensor cores) where it fits, ``"walk"`` (per-block tiles listed by
cluster) for every other shape the gate takes.

Sums come back in float64: the kernel accumulates each block's columns in
f64 and adds the blocks in a fixed order, so a run is bitwise reproducible
and counts stay exact beyond 2^24 members.

The Gram matrix of hierarchical SVD (the counterpart of
``heat_tpu/core/kernels.py::_syrk_kernel``) is ``csrc/syrk.cu``:
:func:`gram_partials` gives ``x[:n_true].T @ x[:n_true]`` of a rank's padded
chunk, in the same idiom: the kernel for a CUDA float32 tensor or a raise,
:func:`_gram_plain` for a CPU tensor.  It too adds f64 partials in a fixed
order, and its G is exactly symmetric.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build
from .linalg.basics import full_f32_matmul

__all__ = [
    "GRAM_LAUNCHES",
    "LLOYD_LAUNCHES",
    "gram_partials",
    "gram_unsupported",
    "lloyd_partials",
    "lloyd_route",
    "lloyd_unsupported",
    "lloyd_update",
]

#: launches of the CUDA Lloyd kernel in this process (the plain version adds nothing)
LLOYD_LAUNCHES = 0
#: launches of the CUDA Gram kernel in this process (the plain version adds nothing)
GRAM_LAUNCHES = 0

_TILE = 256  # points per tile and threads per block of the walk route (lloyd.cu kTile)
_TC_WARPS = 4  # warps per block of the tc route (lloyd.cu kTcWarps)
_TC_STAGES = {16: 3, 32: 3, 64: 3, 128: 2}  # batches in a warp's cp.async ring by width (tc_stages)
_TC_POINTS = {16: 2, 32: 2, 64: 1, 128: 1}  # points a lane owns at a time by width (tc_points)
_TC_MAX_TILES = 8  # output tiles of 16 features x 8 clusters the tc route holds (kTcMaxTiles)
_ROUTES = {"walk": 0, "tc": 1}
_MAX_FEATURES = 128  # widest register tile lloyd.cu instantiates
_SMEM_LIMIT = 232448  # shared memory one block may use on Hopper (227 KB)
_PLAIN_ROWS = 1 << 20  # rows per chunk of the plain versions
_GRAM_MAX_N = 512  # widest matrix syrk.cu takes
_GRAM_TILE = 64  # side of an output tile (syrk.cu kT)
_GRAM_STAGE_ROWS = 64  # rows per shared-memory stage (syrk.cu kK)
_GRAM_MAX_RUNS = 65535  # runs of rows: the grid's y extent


def _feature_bucket(f: int) -> int:
    for fb in (8, 16, 32, 64):
        if f <= fb:
            return fb
    return 128


def _tc_bucket(f: int) -> int:
    for fb in (16, 32, 64):
        if f <= fb:
            return fb
    return 128


def _tc_tiles(f: int, k: int) -> int:
    return (_tc_bucket(f) // 16) * -(-k // 8)


def lloyd_route(f: int, k: int, aligned: bool = True) -> str:
    """The kernel's route for f features and k centres (mirrors
    ``route_takes`` in lloyd.cu): ``"tc"`` where f is a multiple of 4, the
    sums fit in at most 8 output tiles of 16 features x 8 clusters and the
    points are 16-byte aligned; ``"walk"`` otherwise."""
    if aligned and 1 <= f <= _MAX_FEATURES and f % 4 == 0 and k >= 1 and _tc_tiles(f, k) <= _TC_MAX_TILES:
        return "tc"
    return "walk"


def lloyd_smem_bytes(f: int, k: int, route: Optional[str] = None) -> int:
    """Shared memory of one kernel block of the route (default: the route
    :func:`lloyd_route` picks); mirrors ``tc_smem_bytes`` and
    ``smem_bytes`` in lloyd.cu."""
    if (route or lloyd_route(f, k)) == "tc":
        fb = _tc_bucket(f)
        doubles = (_tc_tiles(f, k) * 128 + k + 2) & ~1
        ring = _TC_STAGES[fb] * 32 * _TC_POINTS[fb] * fb
        return 8 * _TC_WARPS * doubles + 4 * (k * fb + ((k + 3) & ~3) + _TC_WARPS * ring)
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
    smem = lloyd_smem_bytes(f, k, "walk")  # the walk route takes every shape the tc route does
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


def _lloyd_launch(fn, xp: torch.Tensor, centers: torch.Tensor, n_true: int, labels: bool, route: str, *extra):
    """Launch a Lloyd step of csrc/lloyd.cu's C interface ``fn`` by ``route``
    on PyTorch's current stream (no synchronise)."""
    rows, f = xp.shape
    k = centers.shape[0]
    dev = xp.device
    nblocks = _lloyd_grid(xp, k, route)
    w = k * f + k + 1
    partial = torch.empty((nblocks, w), dtype=torch.float64, device=dev)
    out = torch.empty((w,), dtype=torch.float64, device=dev)
    lab = torch.empty((rows,), dtype=torch.int64, device=dev) if labels else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            xp.data_ptr(), centers.data_ptr(), rows, n_true, f, k, partial.data_ptr(), nblocks, out.data_ptr(),
            lab.data_ptr() if lab is not None else None, _ROUTES[route], stream, *extra,
        )
    if err != 0:
        raise RuntimeError(f"lloyd kernel launch ({route} route) failed: CUDA error {err}")
    return out[: k * f].view(k, f), out[k * f : k * f + k], out[k * f + k], lab


def _lloyd_cuda(xp: torch.Tensor, centers: torch.Tensor, n_true: int, labels: bool, route: Optional[str] = None):
    """Launch csrc/lloyd.cu on PyTorch's current stream (no synchronise), by
    the route :func:`lloyd_route` picks or by ``route`` (``"walk"`` takes
    every shape; ``"tc"`` raises on a shape it does not take)."""
    global LLOYD_LAUNCHES
    f, k = xp.shape[1], centers.shape[0]
    fits = lloyd_route(f, k, xp.data_ptr() % 16 == 0)
    if route is None:
        route = fits
    elif route == "tc" and fits != "tc":
        raise ValueError(f"the Lloyd kernel's tc route does not take f={f}, k={k} with these points: "
                         "it needs f a multiple of 4, at most 8 output tiles and 16-byte aligned points")
    out = _lloyd_launch(_lib().heat_lloyd_step_f32, xp, centers, n_true, labels, route)
    LLOYD_LAUNCHES += 1
    return out


_LIB = None
_RESIDENT: dict = {}
# heat_lloyd_step_f32(x, c, rows, n_true, f, k, partial, nblocks, out, labels, route, stream)
_LLOYD_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
    ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
]


def _lloyd_grid(xp: torch.Tensor, k: int, route: str) -> int:
    """Blocks of a launch: one per tile (walk) or per batch of each of its
    warps (tc), at most as many as the card holds at once."""
    rows, f = xp.shape
    per_block = _TC_WARPS * 32 * _TC_POINTS[_tc_bucket(f)] if route == "tc" else _TILE
    return max(1, min(-(-rows // per_block), _resident_blocks(xp.device, f, k, route)))


def _resident_blocks(dev: torch.device, f: int, k: int, route: str) -> int:
    """Blocks the card holds at once for (f, k) by the route: the grid of
    the kernel.  A larger grid would leave blocks queued behind whole
    grid-stride loops."""
    key = (dev.index, f, k, route)
    if key not in _RESIDENT:
        per_sm = _lib().heat_lloyd_blocks_per_sm(f, k, _ROUTES[route])
        if per_sm < 1:
            raise RuntimeError(f"the CUDA Lloyd kernel's {route} route cannot be resident for f={f}, k={k}")
        _RESIDENT[key] = per_sm * torch.cuda.get_device_properties(dev).multi_processor_count
    return _RESIDENT[key]


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("lloyd")
        fn = lib.heat_lloyd_step_f32
        fn.argtypes = _LLOYD_ARGTYPES
        fn.restype = ctypes.c_int
        lib.heat_lloyd_blocks_per_sm.argtypes = [ctypes.c_int64, ctypes.c_int64, ctypes.c_int64]
        lib.heat_lloyd_blocks_per_sm.restype = ctypes.c_int64
        _LIB = lib
    return _LIB


#: the phases of csrc/lloyd.cu's clock64() stamps by route, in the order of its enum
LLOYD_PHASES = {
    "walk": ("stage", "distances", "count", "scan", "list", "sums", "barrier"),
    "tc": ("stage", "distances", "count", "unused", "fragments", "sums", "syncwarp"),
}
_PHASES_LIB = None


def lloyd_phase_cycles(xp: torch.Tensor, centers: torch.Tensor, n_true: int, route: Optional[str] = None) -> dict:
    """One step of the stamped build (``csrc/lloyd_phases.cu``) on CUDA
    float32 tensors, by the route :func:`lloyd_route` picks or by ``route``:
    the cycles each phase took, summed over every thread of the grid, by
    phase name.  A measurement: it is not counted in ``LLOYD_LAUNCHES`` and
    nothing on the main path calls it."""
    global _PHASES_LIB
    if _PHASES_LIB is None:
        lib = _build.load("lloyd_phases")
        lib.heat_lloyd_phases_f32.argtypes = _LLOYD_ARGTYPES + [ctypes.c_void_p]
        lib.heat_lloyd_phases_f32.restype = ctypes.c_int
        _PHASES_LIB = lib
    if route is None:
        route = lloyd_route(xp.shape[1], centers.shape[0], xp.data_ptr() % 16 == 0)
    names = LLOYD_PHASES[route]
    cycles = torch.zeros((_lloyd_grid(xp, centers.shape[0], route), len(names)), dtype=torch.int64, device=xp.device)
    _lloyd_launch(_PHASES_LIB.heat_lloyd_phases_f32, xp, centers, int(n_true), False, route, cycles.data_ptr())
    return dict(zip(names, cycles.sum(0).tolist()))


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


# ----------------------------------------------------------------------
# Gram matrix (hierarchical SVD)
# ----------------------------------------------------------------------
def gram_unsupported(n: int, dtype) -> Optional[str]:
    """Why the CUDA Gram kernel cannot take an (m, n) matrix of ``dtype``, or
    None.  Rows are not limited."""
    if dtype != torch.float32:
        return f"takes float32, got {dtype}"
    if not 1 <= n <= _GRAM_MAX_N:
        return f"takes 1 to {_GRAM_MAX_N} columns, got n={n}"
    return None


def _gram_plain(x: torch.Tensor, n_true: int) -> torch.Tensor:
    """The Gram matrix of the first ``n_true`` rows in plain PyTorch: chunks
    of rows multiplied and summed in float64, made exactly symmetric, and
    returned as float32."""
    n = x.shape[1]
    g = torch.zeros((n, n), dtype=torch.float64, device=x.device)
    for start in range(0, n_true, _PLAIN_ROWS):
        xc = x[start : min(start + _PLAIN_ROWS, n_true)].to(torch.float64)
        g += xc.T @ xc
    return ((g + g.T) * 0.5).to(torch.float32)


_GRAM_LIB = None
_GRAM_RESIDENT: dict = {}


def _gram_lib() -> ctypes.CDLL:
    global _GRAM_LIB
    if _GRAM_LIB is None:
        lib = _build.load("syrk")
        lib.heat_syrk_f32.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.heat_syrk_f32.restype = ctypes.c_int
        lib.heat_syrk_blocks_per_sm.argtypes = [ctypes.c_int64]
        lib.heat_syrk_blocks_per_sm.restype = ctypes.c_int64
        lib.heat_syrk_units.argtypes = [ctypes.c_int64]
        lib.heat_syrk_units.restype = ctypes.c_int64
        _GRAM_LIB = lib
    return _GRAM_LIB


def _gram_tiles(n: int) -> int:
    """Upper-triangle output tiles of an (n, n) Gram matrix."""
    nt = -(-n // _GRAM_TILE)
    return nt * (nt + 1) // 2


def _gram_runs(dev: torch.device, n: int, n_true: int) -> Tuple[int, int]:
    """``(runs, rows per run)``: the rows cut into runs so that the grid of
    (units, runs) blocks is about one wave of what the card holds at once;
    a unit is one block of a run (syrk.cu: one for 64 < n <= 128, else one
    per upper-triangle tile)."""
    key = (dev.index, n)
    if key not in _GRAM_RESIDENT:
        lib = _gram_lib()
        per_sm = lib.heat_syrk_blocks_per_sm(n)
        if per_sm < 1:
            raise RuntimeError("the CUDA Gram kernel cannot be resident")
        resident = per_sm * torch.cuda.get_device_properties(dev).multi_processor_count
        _GRAM_RESIDENT[key] = max(1, resident // lib.heat_syrk_units(n))
    stages = max(1, -(-n_true // _GRAM_STAGE_ROWS))
    runs = max(1, min(stages, _GRAM_RESIDENT[key], _GRAM_MAX_RUNS))
    per = -(-stages // runs) * _GRAM_STAGE_ROWS
    return max(1, -(-n_true // per)), per


def _gram_cuda(x: torch.Tensor, n_true: int) -> torch.Tensor:
    """Launch csrc/syrk.cu on PyTorch's current stream (no synchronise)."""
    global GRAM_LAUNCHES
    n = x.shape[1]
    dev = x.device
    lib = _gram_lib()
    tiles = _gram_tiles(n)
    runs, per = _gram_runs(dev, n, n_true)
    partial = torch.empty((runs * tiles * _GRAM_TILE * _GRAM_TILE,), dtype=torch.float64, device=dev)
    g = torch.empty((n, n), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.heat_syrk_f32(x.data_ptr(), n_true, n, partial.data_ptr(), runs, per, g.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"gram kernel launch failed: CUDA error {err}")
    GRAM_LAUNCHES += 1
    return g


def gram_partials(x: torch.Tensor, n_true: int) -> torch.Tensor:
    """One rank's Gram matrix ``x[:n_true].T @ x[:n_true]``, (n, n) float32;
    rows at or past ``n_true`` (padding) add nothing.

    A CPU tensor runs the plain version; a CUDA tensor runs the kernel or
    raises."""
    if x.ndim != 2:
        raise ValueError(f"need a matrix (rows, n), got shape {tuple(x.shape)}")
    n_true = int(n_true)
    if not 0 <= n_true <= x.shape[0]:
        raise ValueError(f"n_true={n_true} is outside the {x.shape[0]} rows")
    if x.device.type == "cpu":
        return _gram_plain(x, n_true)
    if x.device.type != "cuda":
        raise ValueError(f"no Gram kernel for device {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"the CUDA Gram kernel takes float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("the CUDA Gram kernel needs a contiguous matrix")
    reason = gram_unsupported(x.shape[1], x.dtype)
    if reason is not None:
        raise ValueError(f"the CUDA Gram kernel {reason}")
    return _gram_cuda(x, n_true)
