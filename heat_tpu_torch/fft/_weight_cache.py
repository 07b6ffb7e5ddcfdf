"""Byte-bounded LRU for the FFT weight, twiddle and chirp matrices
(counterpart of heat_tpu/fft/_weight_cache.py).

The DFT matrices scale as n^2, so every weight function of ``_planar.py``,
``_leading.py`` and ``_axis_pass.py`` shares ONE insertion-ordered LRU keyed
by ``(function name, args)`` and bounded by bytes (:data:`BUDGET_BYTES`):
an insert evicts least-recently-used entries until the total fits.

The weight functions return host float64-derived numpy arrays, exactly as
the reference's do.  :func:`on_device` keeps a torch copy of their result
per (device, args) in the same LRU and under the same budget, so a transform
does not upload its matrices on every call.

Evictions are counted into the telemetry registry
(``fft.weight_cache.evictions``, the reference's counter), and the live
byte total and the budget are callback gauges (``fft.weight_cache.nbytes``,
``fft.weight_cache.budget_bytes``), so a workload thrashing the cache shows
in ``telemetry.snapshot()`` and on ``/varz``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..telemetry import metrics as _tm

__all__ = ["BUDGET_BYTES", "byte_lru", "on_device", "weight_cache_clear", "weight_cache_stats"]

#: bytes the cache may hold, host and device entries together.  An 8192-point
#: transform alone needs about 2.6 GB (the f64 (cos, sin) pair, the f32 cat
#: matrices, their device copies); with less, each call would build them anew
#: on the host, which takes seconds.
BUDGET_BYTES = 4 << 30
_cache: dict = {}  # insertion-ordered; move-to-end on hit
_nbytes = 0

_EVICTIONS = _tm.counter(
    "fft.weight_cache.evictions",
    "FFT weight-cache entries evicted by the shared byte budget",
)
_tm.gauge(
    "fft.weight_cache.nbytes",
    "live bytes held by the shared FFT weight cache",
    fn=lambda: _nbytes,
)
_tm.gauge(
    "fft.weight_cache.budget_bytes",
    "byte budget of the shared FFT weight cache (host and device entries)",
    fn=lambda: BUDGET_BYTES,
)


def _entry_nbytes(val) -> int:
    if isinstance(val, tuple):
        return sum(_entry_nbytes(v) for v in val)
    return int(getattr(val, "nbytes", 0))


def _lookup(key, make):
    global _nbytes
    if key in _cache:
        val = _cache.pop(key)  # re-insert: most recently used
        _cache[key] = val
        return val
    val = make()
    _cache[key] = val
    _nbytes += _entry_nbytes(val)
    while _nbytes > BUDGET_BYTES and len(_cache) > 1:
        old = _cache.pop(next(iter(_cache)))
        _nbytes -= _entry_nbytes(old)
        _EVICTIONS.inc()
    return val


def byte_lru(fn):
    """lru_cache analog bounded by the shared byte budget."""
    tag = fn.__name__

    @functools.wraps(fn)
    def wrapper(*args):
        return _lookup((tag, args), lambda: fn(*args))

    return wrapper


def _to_torch(val, device: torch.device):
    if isinstance(val, tuple):
        return tuple(_to_torch(v, device) for v in val)
    if isinstance(val, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(val)).to(device)
    return val  # ints (a length) pass through


def on_device(make, *args, device: torch.device):
    """``make(*args)`` as torch tensors on ``device`` (tuples stay tuples,
    plain ints pass through), cached under the shared budget."""
    device = torch.device(device)
    key = ("on_device", make.__module__, make.__qualname__, args, str(device))
    return _lookup(key, lambda: _to_torch(make(*args), device))


def weight_cache_stats() -> dict:
    """Size/budget snapshot of the shared weight cache."""
    return {"entries": len(_cache), "nbytes": _nbytes, "budget_nbytes": BUDGET_BYTES, "evictions": int(_EVICTIONS.value)}


def weight_cache_clear() -> None:
    global _nbytes
    _cache.clear()
    _nbytes = 0
