"""The dispatch layer's surface (counterpart of heat_tpu/core/dispatch.py).

The reference routes every op application of its four generic wrappers
(``core/_operations.py``) through ``jax.jit``-compiled closures held in an
executable cache, fuses element-wise chains lazily into one program, and
donates dead buffers to in-place programs.  PyTorch runs eagerly: every op
application launches its kernels at once, and there is nothing to trace,
compile or cache (``jit`` has no counterpart the port needs; capturing
launches in a CUDA graph or with ``torch.compile`` is a speed-up, to be
made where a benchmark can measure it).  So this
module ports the reference's surface and contracts -- its names, its
counters under their registry names, its fault site, its cost accounting
and ``batch_bucket`` -- and gives each XLA-only counter a stated torch
meaning:

* **key** -- the reference's form, ``("apply", op, static kwargs, operand
  specs)``.  An operand's spec is its padded torch shape, dtype and device
  (a tensor) or its value (anything else).  An op is keyed by its
  identity; a Python function by its code object and the values it
  closes over, so the closures the op modules build per call
  (``_ring(torch.add)``) key alike.
* **misses** count keys first seen in this process.  Keys are held in an
  LRU of ``HEAT_TPU_DISPATCH_CACHE_SIZE`` entries; an evicted key misses
  again.  On the card a miss is the first launch at that shape, which is
  where torch loads its kernels lazily and cuBLAS picks a heuristic (the
  "first call" columns of PERF.md).  **hits** count later applications of
  a key.  With ``HEAT_TPU_DISPATCH_CACHE=0`` no key is counted, as in the
  reference, and the ops run as they always do.  Counting is host work
  on every application (the key's operand specs, the registered lock,
  two counters): a few microseconds an op, which shows on ops over a few
  rows (``scripts/torch_dispatch_overhead.py`` measures it).
* **dispatches** count op applications issued through this layer: by the
  four wrappers of ``core/_operations.py``, and by :func:`eager_apply`'s
  other callers (argmin/argmax, the matrix product, Lasso's soft
  threshold and predict).
* **fused_ops** stays 0 and :func:`fusion_enabled` answers False: the port
  has no pending chains.  ``PendingExpr``, ``make_node``, ``chain_apply``,
  ``materialize``, ``cast_node``, ``scalar_leaf``, ``repad``,
  ``cast_store`` and the refcount proofs behind donation are not ported,
  and the port reads neither ``HEAT_TPU_FUSION``, ``_FUSION_DEPTH`` nor
  ``HEAT_TPU_DONATE``.
* **donations** count stores that wrote into the target's existing tensor
  instead of holding a second one: each rank's in-place write of
  ``__setitem__`` and ``fill_diagonal``.  An ``out=`` store rebinds
  ``out`` to the result's tensor (the old one is freed when nothing else
  holds it), so it is no donation.
* **external_dispatches** count launches of the port's own programs
  outside the wrappers: one per K1 Lloyd step of a KMeans fit (each step
  and the final assignment), one per Lasso coordinate-descent sweep, one
  per ``ht.jit`` call.  The reference's fits are one on-device
  ``while_loop`` each, one dispatch however many iterations; the port's
  fits are host loops, so its count grows with ``n_iter``.
* **compile_fallbacks** -- the ``dispatch.compile`` fault site is
  evaluated at each miss.  A transient fault there counts one fallback,
  raises one ``RuntimeWarning`` and the op still runs (its key is not
  kept, so the next application misses again); ``PermanentFault`` and
  ``ChecksumError`` are re-raised.  An error of the op itself propagates
  unchanged and counts nothing.  ``compile_ms`` observes the wall time of
  each miss's application (the first launch, on the host's clock).
* **cost accounting** (``HEAT_TPU_COST_ANALYSIS=1`` or
  :func:`set_cost_accounting`) -- at a miss the application runs under
  ``torch.utils.flop_counter.FlopCounterMode``; its flops and the bytes
  of the operands and results (``nbytes``, each read or written once) are
  recorded under the key.  FlopCounterMode counts the products (mm, bmm,
  convolutions, attention: 2mnk for a matrix product) and no element-wise
  flops, where XLA's cost analysis counts one per element.  A hand-written
  kernel has no FlopCounterMode record: its launch site puts the kernel's
  own cost under the launch key (:func:`kernel_launch`), always, as the
  bytes and operations of its bound.
* **roofline observatory** (``telemetry/observatory.py``,
  ``HEAT_TPU_OBSERVATORY``) -- every warm application of
  :func:`eager_apply` (a key's hit; the reference notes every warm cached
  call) and every :func:`kernel_launch` notes its wall time into the
  observatory's per-key ledger; every ``HEAT_TPU_PERF_SYNC_EVERY``-th
  call of a key waits for the card, so that sample is device time.
"""

from __future__ import annotations

import contextlib
import functools
import threading
import time
import warnings
from collections import OrderedDict
from typing import Any, Optional, Sequence, Tuple

import torch

from ..analysis import tsan as _tsan
from ..telemetry import metrics as _tm
from ..telemetry import observatory as _obsv
from . import _env

__all__ = [
    "CostMeter",
    "batch_bucket",
    "cache_enabled",
    "cache_keys",
    "cache_stats",
    "clear_cache",
    "cost_accounting_enabled",
    "cost_summary",
    "eager_apply",
    "fusion_enabled",
    "kernel_launch",
    "meter_costs",
    "record_external_dispatch",
    "reset_stats",
    "set_cost_accounting",
]

_CACHE_ENABLED = _env.env_flag("HEAT_TPU_DISPATCH_CACHE")
_CACHE_MAXSIZE = _env.env_int("HEAT_TPU_DISPATCH_CACHE_SIZE")
_COST_ENABLED = _env.env_flag("HEAT_TPU_COST_ANALYSIS")


def cache_enabled() -> bool:
    """Whether dispatch keys are counted (``HEAT_TPU_DISPATCH_CACHE``)."""
    return _CACHE_ENABLED


def fusion_enabled() -> bool:
    """Always False: the port has no lazy element-wise chains (every op runs
    eagerly; see the module docstring)."""
    return False


# ----------------------------------------------------------------------
# counters + key cache, in the shared telemetry registry as ``dispatch.*``
# ----------------------------------------------------------------------
_COUNTER_NAMES = ("hits", "misses", "dispatches", "fused_ops", "donations",
                  "external_dispatches", "compile_fallbacks")
_C = {n: _tm.counter(f"dispatch.{n}") for n in _COUNTER_NAMES}

#: wall time of each miss's application (its first launch), milliseconds
_COMPILE_MS = _tm.histogram(
    "dispatch.compile_ms", "wall time of the first application per dispatch key (miss)"
)

#: LRU of the dispatch keys seen (key -> None)
_cache: "OrderedDict[Any, None]" = OrderedDict()

#: the key cache and the cost records are mutated per op application on
#: whichever thread runs ops, and iterated by cache_keys()/cost_summary()
#: from any other; every mutation and iteration holds this registered lock
_CACHE_LOCK = _tsan.register_lock("dispatch.cache")

_tm.gauge("dispatch.cache_size", "live dispatch-key cache entries", fn=lambda: len(_cache))
_tm.gauge(
    "dispatch.hit_rate", "hits / (hits + misses), 0.0 before any lookup",
    fn=lambda: (
        _C["hits"].value / t if (t := _C["hits"].value + _C["misses"].value) else 0.0
    ),
)


def cache_stats() -> dict:
    """Snapshot of the dispatch counters (the reference's keys).

    Torch meanings (the module docstring has the whole story):
    ``misses`` count dispatch keys (op, static kwargs, padded operand
    shapes, dtypes and devices) first seen in this process -- on the card
    the first launch at that shape; ``hits`` later applications of a key;
    ``dispatches`` the op applications issued through this layer;
    ``fused_ops`` stays 0 (no pending chains in the port); ``donations``
    the in-place stores into a target's existing tensor (``__setitem__``,
    ``fill_diagonal``); ``external_dispatches`` launches of the port's
    own programs outside the wrappers (one per KMeans Lloyd step, per Lasso
    sweep, per ``ht.jit`` call: host loops, so they grow with the
    iterations, where the reference counts one per fit);
    ``compile_fallbacks`` the transient faults injected at the
    ``dispatch.compile`` site of a miss (the op still ran).  ``hit_rate``
    is hits / (hits + misses), 0.0 before any lookup; ``cache_size`` the
    live keys.  A thin view over the shared telemetry registry."""
    s = {n: _C[n].value for n in _COUNTER_NAMES}
    total = s["hits"] + s["misses"]
    s["hit_rate"] = (s["hits"] / total) if total else 0.0
    s["cache_size"] = len(_cache)
    return s


def reset_stats() -> None:
    """Zero all dispatch counters (the key cache itself is kept);
    delegates to ``telemetry.reset_all("dispatch")``."""
    from ..telemetry import reset_all

    reset_all("dispatch")


def clear_cache() -> None:
    """Drop every dispatch key (and its cost record) and zero the counters."""
    with _CACHE_LOCK:
        _tsan.note_access("dispatch.cache")
        _cache.clear()
        _cost_records.clear()
    reset_stats()


def record_external_dispatch(n: int = 1) -> None:
    """Count ``n`` launches of the port's own programs outside this layer
    (KMeans' Lloyd steps, Lasso's sweeps, ``ht.jit`` calls)."""
    _C["external_dispatches"].inc(n)


def _note_donation() -> None:
    """Count one in-place store into a target's existing tensor."""
    _C["donations"].inc()


def batch_bucket(n: int, cap: Optional[int] = None) -> int:
    """Quantized leading extent for variable-size batch dispatch.

    Padding every batch up to the next power of two -- capped at ``cap``,
    which is itself a valid bucket -- bounds the set of batch shapes (and
    so of dispatch keys and first launches) to ``log2(cap)+1``.  The
    serving layer pads with real rows to the returned extent."""
    n = int(n)
    if n < 1:
        raise ValueError(f"batch size must be >= 1, got {n}")
    b = 1 << (n - 1).bit_length()
    if cap is not None:
        cap = int(cap)
        if n > cap:
            raise ValueError(f"batch size {n} exceeds the bucket cap {cap}")
        b = min(b, cap)
    return b


# ----------------------------------------------------------------------
# cost accounting (``HEAT_TPU_COST_ANALYSIS=1``): per dispatch key, the
# flops FlopCounterMode counts and the bytes of operands and results, at
# the key's miss
# ----------------------------------------------------------------------
_FLOPS_TOTAL = _tm.counter(
    "dispatch.flops_total", "FlopCounterMode flops summed over the dispatch keys' first applications"
)
_COST_BYTES_TOTAL = _tm.counter(
    "dispatch.cost_bytes_total",
    "operand and result bytes summed over the dispatch keys' first applications",
)

#: dispatch key -> cost record (bounded like the key cache)
_cost_records: "OrderedDict[Any, dict]" = OrderedDict()


def cost_accounting_enabled() -> bool:
    """Whether per-key cost accounting is active."""
    return _COST_ENABLED


def set_cost_accounting(enabled: bool) -> bool:
    """Enable/disable cost accounting at runtime (overrides the env knob);
    returns the previous state."""
    global _COST_ENABLED
    prev = _COST_ENABLED
    _COST_ENABLED = bool(enabled)
    return prev


def _fmt_key_part(obj, depth: int = 0) -> str:
    if callable(obj):
        return getattr(obj, "__name__", type(obj).__name__)
    if hasattr(obj, "co_name"):  # a Python op's code object
        return obj.co_name
    if isinstance(obj, (tuple, list)):
        if depth > 3:
            return "(...)"
        return "(" + ", ".join(_fmt_key_part(o, depth + 1) for o in obj) + ")"
    return str(obj)


def _key_repr(key, limit: int = 200) -> str:
    """Compact human-readable form of a key (op names, shapes, dtypes)."""
    s = _fmt_key_part(key)
    return s if len(s) <= limit else s[: limit - 3] + "..."


def cache_keys() -> list:
    """Readable reprs of every live dispatch key (oldest first, like the LRU)."""
    with _CACHE_LOCK:
        _tsan.note_access("dispatch.cache", write=False)
        keys = list(_cache)
    return [_key_repr(k) for k in keys]


def cost_summary() -> dict:
    """Cost-accounting view: ``{"enabled", "executables", "flops_total",
    "bytes_total", "per_key": {key_repr: {flops, bytes_accessed,
    transcendentals}}}`` (the reference's fields; ``executables`` counts
    the keys with a record).  The totals are the ``dispatch.flops_total`` /
    ``dispatch.cost_bytes_total`` registry counters, so they survive record
    eviction.  ``transcendentals`` is 0: FlopCounterMode does not count
    them."""
    with _CACHE_LOCK:
        _tsan.note_access("dispatch.cache", write=False)
        per_key = {_key_repr(k): dict(v) for k, v in _cost_records.items()}
        n = len(_cost_records)
    return {
        "enabled": _COST_ENABLED,
        "executables": n,
        "flops_total": _FLOPS_TOTAL.value,
        "bytes_total": _COST_BYTES_TOTAL.value,
        "per_key": per_key,
    }


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (tuple, list)):
        for o in obj:
            yield from _tensors(o)


def _counted_apply(key, op, args, kwargs):
    """Apply ``op`` under FlopCounterMode and record the key's cost."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        out = op(*args, **kwargs)
    nbytes = sum(t.nbytes for t in _tensors(args)) + sum(t.nbytes for t in _tensors(out))
    _record_cost(key, counter.get_total_flops(), nbytes)
    return out


def _record_cost(key, flops: float, nbytes: float) -> None:
    """Keep ``key``'s cost record (bounded like the key cache) and add it
    to the totals."""
    rec = {"flops": float(flops), "bytes_accessed": float(nbytes), "transcendentals": 0.0}
    _FLOPS_TOTAL.inc(rec["flops"])
    _COST_BYTES_TOTAL.inc(rec["bytes_accessed"])
    with _CACHE_LOCK:
        _tsan.note_access("dispatch.cache")
        _cost_records[key] = rec
        while len(_cost_records) > _CACHE_MAXSIZE:
            _cost_records.popitem(last=False)


class CostMeter:
    """Accumulated cost of the dispatches one thread ran.

    Filled while a :func:`meter_costs` scope is active on the thread: each
    dispatch adds its key's cost record's flops and bytes.
    ``unmetered_calls`` counts dispatches with no cost record (accounting
    off when the key first ran, or its record evicted)."""

    __slots__ = ("flops", "bytes_accessed", "calls", "unmetered_calls")

    def __init__(self) -> None:
        self.flops = 0.0
        self.bytes_accessed = 0.0
        self.calls = 0
        self.unmetered_calls = 0


class _MeterTLS(threading.local):
    #: the thread's active CostMeter (a class default: no AttributeError
    #: to raise and catch on the per-op read)
    meter = None


_METER_TLS = _MeterTLS()


@contextlib.contextmanager
def meter_costs():
    """Meter the cost of every dispatch on this thread.  Thread-local and
    re-entrant (a nested scope meters independently and the outer scope
    resumes on exit).  Yields the :class:`CostMeter` being filled."""
    meter = CostMeter()
    prev = _METER_TLS.meter
    _METER_TLS.meter = meter
    try:
        yield meter
    finally:
        _METER_TLS.meter = prev


def _meter_note(key) -> None:
    """Add ``key``'s cost to the thread's active meter (no-op without one)."""
    meter = _METER_TLS.meter
    if meter is None:
        return
    with _CACHE_LOCK:
        _tsan.note_access("dispatch.cache", write=False)
        rec = _cost_records.get(key)
    if rec is None:
        meter.unmetered_calls += 1
        return
    meter.calls += 1
    meter.flops += rec["flops"]
    meter.bytes_accessed += rec["bytes_accessed"]


# ----------------------------------------------------------------------
# keys
# ----------------------------------------------------------------------
#: operand and closure types that key as themselves (hashable, no walk)
_PLAIN = frozenset((int, float, bool, str, type(None), torch.dtype, torch.device))


def _static(v, depth: int = 0):
    """Hashable stand-in of a closed-over value or a non-tensor operand."""
    if type(v) in _PLAIN:
        return v
    if isinstance(v, torch.Tensor):
        return (v.shape, v.dtype, v.device)
    if callable(v) and not isinstance(v, type):
        return _op_key(v, depth + 1)
    if isinstance(v, (tuple, list)):
        return tuple(_static(o, depth + 1) for o in v) if depth < 4 else type(v).__name__
    hash(v)  # TypeError for unhashable values: the caller runs the op uncounted
    return v


def _op_key(op, depth: int = 0):
    """An op's identity: the object itself, or for a Python function its
    code object and the values it closes over; for a partial its function
    and bound arguments."""
    if depth > 4:
        return id(op)
    if isinstance(op, functools.partial):
        return ("partial", _op_key(op.func, depth + 1), _static(op.args, depth + 1),
                tuple(sorted((k, _static(v, depth + 1)) for k, v in op.keywords.items())))
    code = getattr(op, "__code__", None)
    if code is None:
        return op
    cells = []
    for c in op.__closure__ or ():
        try:
            cells.append(_static(c.cell_contents, depth + 1))
        except ValueError:  # an empty cell (a function defined after its closure)
            cells.append(None)
    return (code, tuple(cells))


def _key(op, args, kwargs) -> tuple:
    specs = tuple([(a.shape, a.dtype, a.device) if type(a) is torch.Tensor else _static(a) for a in args])
    kw = tuple(sorted((k, _static(v)) for k, v in kwargs.items())) if kwargs else ()
    return ("apply", _op_key(op), kw, specs)


def _lookup(key) -> bool:
    """Count one lookup of ``key``: True on a hit.  A miss evaluates the
    ``dispatch.compile`` fault site before the key is kept.  ``TypeError``
    for a key that holds an unhashable value."""
    with _CACHE_LOCK:
        _tsan.note_access("dispatch.cache")
        hit = key in _cache
        if hit:
            _cache.move_to_end(key)
    if hit:
        _C["hits"].inc()
        return True
    _C["misses"].inc()
    from ..resilience.faults import inject

    inject("dispatch.compile")
    with _CACHE_LOCK:
        _tsan.note_access("dispatch.cache")
        _cache[key] = None
        while len(_cache) > _CACHE_MAXSIZE:
            _cache.popitem(last=False)
    return False


def eager_apply(op, args: Sequence, kwargs: Optional[dict] = None):
    """Apply ``op(*args, **kwargs)`` now, counted under its dispatch key
    (the reference's cached-executable application).  Runs the op uncounted
    when the cache is off or a static value is unhashable."""
    kwargs = kwargs or {}
    if not _CACHE_ENABLED:
        return op(*args, **kwargs)
    try:
        key = _key(op, args, kwargs)
        hit = _lookup(key)
    except TypeError:  # an unhashable static value: run uncounted
        return op(*args, **kwargs)
    except Exception as e:
        from ..resilience.errors import ChecksumError, PermanentFault, TransientFault

        if isinstance(e, (PermanentFault, ChecksumError)) or not isinstance(e, TransientFault):
            raise
        _C["compile_fallbacks"].inc()
        warnings.warn(
            f"dispatch: compiled execution failed ({type(e).__name__}: {e}); "
            "falling back to eager execution for this call",
            RuntimeWarning,
            stacklevel=2,
        )
        return op(*args, **kwargs)
    _C["dispatches"].inc()
    if hit:
        # roofline observatory: every warm call is a measurement
        out = _noted(key, lambda: op(*args, **kwargs))
    else:
        t0 = time.perf_counter()
        out = _counted_apply(key, op, args, kwargs) if _COST_ENABLED else op(*args, **kwargs)
        _COMPILE_MS.observe((time.perf_counter() - t0) * 1e3)
    if _METER_TLS.meter is not None:
        _meter_note(key)
    return out


def kernel_launch(key: tuple, flops: float, nbytes: float, launch):
    """``launch()``: one launch of a hand-written kernel (its wrapper and
    what the wrapper adds, such as the all-reduce of a Lloyd step), counted
    as an external dispatch.  ``key`` names the kernel, its route, its
    shape and its type; ``flops`` and ``nbytes`` are its cost (the
    operations and the bytes of its bound), kept in the cost table under
    ``key`` so ``/rooflinez`` joins them with the launch's measured time.
    With the observatory armed the launch is timed and noted under
    ``key`` (every ``HEAT_TPU_PERF_SYNC_EVERY``-th launch a fenced sample
    of its device time)."""
    record_external_dispatch()
    with _CACHE_LOCK:
        _tsan.note_access("dispatch.cache", write=False)
        known = key in _cost_records
    if not known:
        _record_cost(key, flops, nbytes)
    if _METER_TLS.meter is not None:
        _meter_note(key)
    return _noted(key, launch)


def _noted(key, fn):
    """``fn()``; with the roofline observatory armed, timed and noted
    under ``key``, its fenced samples opened just before the call."""
    if not _obsv.armed():
        return fn()
    start = _obsv.fence_start(key)
    t0 = time.perf_counter()
    out = fn()
    _obsv.note(key, time.perf_counter() - t0, out, start)
    return out


def dispatched(op):
    """``op`` as a function whose every application goes through
    :func:`eager_apply` (how the wrappers of ``core/_operations.py`` issue
    their ops); ``None`` stays ``None``."""
    if op is None or not _CACHE_ENABLED:
        return op

    def apply(*args, **kwargs):
        return eager_apply(op, args, kwargs)

    return apply
