"""Kernel roofline observatory: every production dispatch is a measurement
(counterpart of heat_tpu/telemetry/observatory.py).

The paper's promise is "as fast as the hardware allows", yet until this
module nothing in the runtime could *say* how fast that is: cost
accounting (PR 6) records static FLOPs/bytes per executable but never
pairs them with measured wall time, and the static HBM estimator (PR 12)
predicts peaks nothing checks against reality.  The observatory closes
both loops, always on, at production overhead:

* **Execution ledger** — ``core/dispatch.py`` notes the monotonic wall
  time of every warm keyed op application and of every launch of a
  hand-written kernel the port counts as an external dispatch (K1's
  Lloyd step, keyed by kernel, route, shape and type) into a bounded
  per-key table.  Plain timings measure the *enqueue* (CUDA launches
  are asynchronous); every Nth call per key (``HEAT_TPU_PERF_SYNC_EVERY``)
  is additionally fenced so the sample measures **device time**.  On a
  card the fence is a pair of CUDA events recorded on the current stream
  just before and just after the call, read at report time once the
  second has completed: the host never waits and the launch queue stays
  full, and the sample covers the call's own device work, not the work
  queued before it (the reference's ``block_until_ready`` does both).  On
  the CPU the call itself is synchronous and its wall time is the sample.
  A kernel's wrapper puts its own cost
  into the dispatch layer's cost table (no ``FlopCounterMode`` record
  exists for a hand-written kernel).
  The ledger joins each key's fenced time with its cost-accounting
  FLOPs/bytes to report achieved GFLOP/s, GB/s, arithmetic intensity
  and a compute-vs-bandwidth-bound verdict against the device peaks.
* **Device peaks** — ``HEAT_TPU_PEAK_FLOPS`` / ``HEAT_TPU_PEAK_GBPS``
  knobs (FLOP/s and bytes/s), with a one-shot matmul/copy
  micro-calibration fallback whose result can persist across processes
  (``HEAT_TPU_PEAK_CACHE``: atomic + CRC32 sidecar, invalidated on a
  torch/CUDA/device fingerprint change — the AOT-cache discipline).  On
  a card the calibration is one float32 8192^2 ``torch.matmul`` (TF32
  off) and one read-plus-write stream of 1 GiB; on the CPU the
  reference's sizes (512^2, 2^22).
* **Live HBM watermarks** — ``torch.cuda.memory_stats()``
  (``allocated_bytes.all.current`` and ``.peak``, summed over the local
  cards; the host RSS where ``torch.cuda`` is absent, as the reference
  falls back on a CPU backend; ``source`` says which answered),
  continuously cross-checked against the static estimator's predicted
  peak (0 until ROADMAP item 18 ports ``analysis.memory_model``, so only
  the budget verdict can fire): measured exceeding the armed
  ``HEAT_TPU_HBM_BUDGET_BYTES`` or the prediction by
  ``HEAT_TPU_HBM_ALERT_MARGIN`` fires the deduplicated ``hbm:watermark``
  alert — the runtime companion to the static J301 diagnostic.
* **On-demand profiler capture** — ``/profilez`` starts/stops a bounded
  ``torch.profiler`` trace (CUDA activity on a card; single in-flight,
  duration capped at
  ``HEAT_TPU_PROFILE_MAX_S``, artifacts listed and downloadable).

Surfaces: the ``/rooflinez`` route (HTML table + ``?format=json``),
``/statusz`` + crash flight-recorder bundles + the
``HEAT_TPU_METRICS_DUMP`` atexit JSON (all carry the ``observatory``
section, rendered by the inspect CLI), and the fleet router's
``/fleetz`` rollup (each replica's observatory snapshot merged into one
fleet-wide per-kernel utilization table with the slowest replica per
key highlighted).  See docs/observability.md.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..core import _env
from ..analysis import tsan as _tsan
from . import alerts as _alerts
from . import metrics as _metrics

__all__ = [
    "armed",
    "capture_status",
    "device_peaks",
    "fence_start",
    "ledger_report",
    "note",
    "render_profilez_html",
    "render_rooflinez_html",
    "reset",
    "reset_peaks",
    "rooflinez_report",
    "set_enabled",
    "set_memory_stats_provider",
    "set_peaks",
    "set_sync_every",
    "snapshot",
    "start_capture",
    "stop_capture",
    "watermark",
    "watermark_tick",
]

_ENABLED = _env.env_flag("HEAT_TPU_OBSERVATORY")
_SYNC_EVERY = _env.env_int("HEAT_TPU_PERF_SYNC_EVERY")

_LEDGER_MAX = 1024
#: a key's event-fenced samples whose end has not completed yet; a sample
#: due while as many are pending is not taken (the device is that far
#: behind the host, and the queue is kept, not waited on)
_PENDING_MAX = 64
_CAPTURES_KEPT = 16
_WATERMARK_MIN_PERIOD_S = 0.5

#: ledger + calibration + watermark state: written by whichever thread
#: dispatches (fit thread, coalescer batcher), read by /rooflinez and
#: /statusz handler threads, the crash excepthook, and the atexit dump
_LEDGER_LOCK = _tsan.register_lock("telemetry.observatory")
#: profiler capture state: /profilez handler threads + the auto-stop timer
_PROF_LOCK = _tsan.register_lock("telemetry.observatory.profiler")


class _KeyStats:
    """Per-dispatch-key measurement accumulator (guarded by the ledger
    lock)."""

    __slots__ = ("calls", "total_s", "sync_samples", "sync_total_s", "sync_min_s", "pending")

    def __init__(self):
        self.calls = 0
        self.total_s = 0.0
        self.sync_samples = 0
        self.sync_total_s = 0.0
        self.sync_min_s = float("inf")
        #: (start, end) CUDA event pairs of fenced samples not read yet
        self.pending = []

    def add_sample(self, dt: float) -> None:
        self.sync_samples += 1
        self.sync_total_s += dt
        if dt < self.sync_min_s:
            self.sync_min_s = dt

    def drain(self) -> int:
        """Move the completed event pairs, oldest first, into the fenced
        statistics; returns how many moved.  Never waits."""
        done = 0
        while self.pending and self.pending[0][1].query():
            start, end = self.pending.pop(0)
            self.add_sample(start.elapsed_time(end) / 1e3)
            done += 1
        return done


_LEDGER: "Dict[Any, _KeyStats]" = {}

#: calibrated/derived device peaks (FLOP/s, bytes/s) + provenance
_PEAKS: Optional[Dict[str, Any]] = None
#: single-flight guard: exactly one thread runs the calibration kernels;
#: concurrent /rooflinez scrapes degrade to peaks-unknown instead of
#: each launching their own matmul storm on a serving replica
_CALIBRATING = False

#: watermark bookkeeping: last sample + peak-seen + throttle stamp
_WM: Dict[str, Any] = {"last": None, "peak_seen": 0.0, "ts": 0.0}

#: test hook: () -> (bytes_in_use, peak_bytes, source) or None
_MEM_PROVIDER: Optional[Callable[[], Optional[Tuple[float, float, str]]]] = None

_SYNC_C = _metrics.counter(
    "observatory.sync_samples", "synchronize-fenced ledger samples"
)
_WM_CHECKS_C = _metrics.counter(
    "observatory.watermark_checks", "HBM watermark cross-checks run"
)
_HBM_ALERTS_C = _metrics.counter(
    "observatory.hbm_alerts", "measured-vs-predicted/budget HBM alert firings"
)
_CAPTURES_C = _metrics.counter(
    "observatory.profiler_captures", "torch.profiler captures completed via /profilez"
)
_metrics.gauge(
    "observatory.ledger_size", "dispatch keys currently tracked by the ledger",
    fn=lambda: len(_LEDGER),
)
_metrics.gauge(
    "observatory.hbm_bytes_in_use", "last sampled device/host memory in use",
    fn=lambda: float((_WM["last"] or {}).get("bytes_in_use", 0.0)),
)
_metrics.gauge(
    "observatory.hbm_peak_bytes", "highest watermark sampled this process",
    fn=lambda: float(_WM["peak_seen"]),
)
_PEAK_FLOPS_G = _metrics.gauge(
    "observatory.peak_flops", "device peak FLOP/s in effect (env or calibrated)"
)
_PEAK_GBPS_G = _metrics.gauge(
    "observatory.peak_bytes_per_s", "device peak bytes/s in effect (env or calibrated)"
)


def armed() -> bool:
    """Whether the execution ledger records dispatches (the one check
    ``core/dispatch.py`` pays per call when off)."""
    return _ENABLED


def set_enabled(enabled: bool) -> bool:
    """Arm/disarm the ledger at runtime (overrides the env knob);
    returns the previous state.  Bench/gate hook."""
    global _ENABLED
    prev = _ENABLED
    _ENABLED = bool(enabled)
    return prev


def set_sync_every(n: int) -> int:
    """Set the fenced-sample period (0 = never fence); returns the
    previous period."""
    global _SYNC_EVERY
    prev = _SYNC_EVERY
    _SYNC_EVERY = max(0, int(n))
    return prev


def sync_every() -> int:
    return _SYNC_EVERY


#: ``fence_start``'s mark of a due sample that no card times: the call's
#: own wall time is the sample (a CPU call is synchronous)
_HOST = "host"
#: ``note``'s default: decide here whether the call is a sample and fence
#: it with a synchronize (callers that did not call :func:`fence_start`)
_DECIDE = object()


def fence_start(key):
    """Called just before a call of ``key`` the ledger will note: for the
    call that is a fenced sample (every ``HEAT_TPU_PERF_SYNC_EVERY``-th),
    ``(card, CUDA event)`` recorded on the current stream when a card is
    in use, else ``"host"``; None for every other call.  Hand the result to
    :func:`note`.  The count is read without the ledger lock: a racing
    thread can only move which call of the key is the sample."""
    if not _SYNC_EVERY:
        return None
    st = _LEDGER.get(key)
    if ((st.calls if st is not None else 0) + 1) % _SYNC_EVERY:
        return None
    import torch

    if not torch.cuda.is_initialized():
        return _HOST
    start = torch.cuda.Event(enable_timing=True)
    start.record()
    return torch.device("cuda", torch.cuda.current_device()), start


def note(key, duration_s: float, out, start=_DECIDE) -> None:
    """Record one cached-executable call (dispatch hot path).

    ``duration_s`` is the unfenced wall time of the call (enqueue on an
    async backend).  ``start`` is what :func:`fence_start` returned
    before the call.  A card's event makes the call a device-timed sample:
    an end event is recorded on the same stream and the pair is read once
    it has completed (at the key's next sample or at report time), so
    nothing here waits for the card.  ``"host"`` makes ``duration_s`` the
    sample.  Without ``start`` the call is a sample when it is the key's
    ``HEAT_TPU_PERF_SYNC_EVERY``-th, fenced as the reference fences it: a
    synchronize on every card ``out`` lives on, OUTSIDE the ledger lock (a
    blocked dispatch must not block /rooflinez scrapes); so is a sample
    whose output is not where its start event was recorded.  A sample
    piggybacks a throttled HBM watermark cross-check (the "continuous"
    half of the measured-vs-predicted alert)."""
    end = None
    if start is _DECIDE or start is None:
        kind = start
    else:
        from .profiling import _cuda_devices

        devs = _cuda_devices(out)
        if start is _HOST:
            kind = "sync" if devs else _HOST
        elif devs == {start[0]}:
            import torch

            kind, end = "event", torch.cuda.Event(enable_timing=True)
            end.record()
        else:
            kind = "sync"
    with _LEDGER_LOCK:
        _tsan.note_access("telemetry.observatory.ledger")
        st = _LEDGER.get(key)
        if st is None:
            if len(_LEDGER) >= _LEDGER_MAX:
                _LEDGER.clear()  # bounded like the dispatch _aval_cache
            st = _LEDGER[key] = _KeyStats()
        st.calls += 1
        st.total_s += duration_s
        if kind is _DECIDE:
            kind = "sync" if _SYNC_EVERY and st.calls % _SYNC_EVERY == 0 else None
        if kind is None:
            return
        samples = 0
        if kind is _HOST:
            st.add_sample(duration_s)
            samples = 1
        elif kind == "event":
            samples = st.drain()
            if len(st.pending) < _PENDING_MAX:
                st.pending.append((start[1], end))
        t0 = time.perf_counter()
    if kind == "sync":
        import torch

        from .profiling import _cuda_devices

        for dev in _cuda_devices(out):
            torch.cuda.synchronize(dev)
        dt = duration_s + (time.perf_counter() - t0)
        samples = 1
        with _LEDGER_LOCK:
            _tsan.note_access("telemetry.observatory.ledger")
            st = _LEDGER.get(key)
            if st is not None:
                st.add_sample(dt)
    if samples:
        _SYNC_C.inc(samples)
    watermark_tick()


def reset() -> None:
    """Drop every ledger entry and the watermark peak (tests/bench)."""
    with _LEDGER_LOCK:
        _tsan.note_access("telemetry.observatory.ledger")
        _LEDGER.clear()
        _WM["last"] = None
        _WM["peak_seen"] = 0.0
        _WM["ts"] = 0.0


def reset_peaks() -> None:
    """Forget the resolved device peaks so the next
    :func:`device_peaks` re-resolves env/cache/calibration (tests)."""
    global _PEAKS
    with _LEDGER_LOCK:
        _tsan.note_access("telemetry.observatory.ledger")
        _PEAKS = None


# ----------------------------------------------------------------------
# device peaks: env knobs -> on-disk cache -> one-shot micro-calibration
# ----------------------------------------------------------------------
def _calibration_device():
    """The device the peaks are for: the port's default device."""
    from ..core import devices

    return devices.get_device().torch_device


def _device_fingerprint() -> str:
    """torch version | CUDA version | device name | device count of the
    default device (a card, or the CPU)."""
    try:
        import torch

        dev = _calibration_device()
        if dev.type == "cuda":
            kind, n = torch.cuda.get_device_name(dev), torch.cuda.device_count()
        else:
            kind, n = "cpu", 1
        return f"torch={torch.__version__}|cuda={torch.version.cuda}|kind={kind}|n={n}"
    except Exception:  # no usable device: fingerprint degrades, cache misses
        return "no-backend"


#: calibration sizes by device type: (matmul side, stream elements); the
#: card's fill it (an 8192^2 float32 product, a 1 GiB stream), the CPU's
#: are the reference's
_CAL_SIZES = {"cuda": (8192, 1 << 28), "cpu": (512, 1 << 22)}


def _calibrate() -> Dict[str, float]:
    """One-shot matmul/copy micro-calibration of the device peaks.

    The matmul is one float32 ``torch.matmul`` with TF32 off (the
    port's kernels hold float32 exactness, so their roof is float32's);
    the stream kernel reads one float32 vector and writes another (8
    bytes moved per element, one kernel).  Min over three fenced
    repeats after a warm-up — calibration noise is one-sided."""
    import torch

    dev = _calibration_device()
    n, m = _CAL_SIZES["cuda" if dev.type == "cuda" else "cpu"]
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        a = torch.ones((n, n), dtype=torch.float32, device=dev)
        c = torch.empty_like(a)
        mm = lambda: torch.matmul(a, a, out=c)  # noqa: E731
        mm()  # warm-up outside the sample
        t_mm = min(_timed(mm, dev) for _ in range(3))
        del a, c
        v = torch.ones((m,), dtype=torch.float32, device=dev)
        w = torch.empty_like(v)
        st = lambda: torch.mul(v, 1.000001, out=w)  # noqa: E731
        st()
        t_st = min(_timed(st, dev) for _ in range(3))
        del v, w
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev_tf32
    return {
        "flops": 2.0 * n**3 / max(t_mm, 1e-9),
        "bytes_per_s": 8.0 * m / max(t_st, 1e-9),
    }


def _timed(fn, dev) -> float:
    """Wall time of ``fn()`` fenced before and after on ``dev``."""
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter() - t0


def _peak_cache_path() -> str:
    return _env.env_str("HEAT_TPU_PEAK_CACHE")


def _load_peak_cache(path: str, fingerprint: str) -> Optional[Dict[str, float]]:
    """Checksum-verified calibration artifact, or None (missing, torn,
    or recorded under a different torch/CUDA/device fingerprint)."""
    try:
        from ..resilience.atomic import verify_checksum

        verify_checksum(path)
        with open(path) as f:
            doc = json.load(f)
        if doc.get("fingerprint") != fingerprint:
            return None
        return {"flops": float(doc["flops"]), "bytes_per_s": float(doc["bytes_per_s"])}
    except Exception:  # bad/missing cache artifact -> recalibrate, never crash
        return None


def _save_peak_cache(path: str, fingerprint: str, peaks: Dict[str, float]) -> None:
    try:
        from ..resilience.atomic import atomic_write

        with atomic_write(path) as tmp:
            with open(tmp, "w") as f:
                json.dump(
                    {
                        "fingerprint": fingerprint,
                        "flops": peaks["flops"],
                        "bytes_per_s": peaks["bytes_per_s"],
                        "calibrated_at": time.time(),
                    },
                    f,
                    indent=1,
                )
    except Exception:  # a read-only cache dir must not break calibration
        pass


def set_peaks(flops: float, bytes_per_s: float, source: str = "manual") -> None:
    """Install explicit device peaks (tests, operators with spec sheets)."""
    global _PEAKS
    doc = {
        "flops": float(flops),
        "bytes_per_s": float(bytes_per_s),
        "source": source,
        "fingerprint": _device_fingerprint(),
    }
    with _LEDGER_LOCK:
        _tsan.note_access("telemetry.observatory.ledger")
        _PEAKS = doc
    _PEAK_FLOPS_G.set(doc["flops"])
    _PEAK_GBPS_G.set(doc["bytes_per_s"])


def device_peaks(calibrate: bool = True) -> Optional[Dict[str, Any]]:
    """The device peaks in effect: ``{"flops", "bytes_per_s", "source",
    "fingerprint"}`` (FLOP/s and bytes/s).

    Resolution order: the already-resolved value, the
    ``HEAT_TPU_PEAK_FLOPS``/``HEAT_TPU_PEAK_GBPS`` knobs (FLOP/s and
    GB/s respectively, both must be set), a fingerprint-matched
    ``HEAT_TPU_PEAK_CACHE`` artifact, then — only when
    ``calibrate=True`` — the one-shot micro-calibration (persisted back
    to the cache path when configured).  ``calibrate=False`` (the
    /statusz embed, crash bundles) never runs device work and returns
    None when no cheap source resolves."""
    with _LEDGER_LOCK:
        _tsan.note_access("telemetry.observatory.ledger", write=False)
        if _PEAKS is not None:
            return dict(_PEAKS)
    try:
        env_flops = float(_env.env_str("HEAT_TPU_PEAK_FLOPS") or 0.0)
        env_gbps = float(_env.env_str("HEAT_TPU_PEAK_GBPS") or 0.0)
    except ValueError:
        env_flops = env_gbps = 0.0
    if env_flops > 0.0 and env_gbps > 0.0:
        set_peaks(env_flops, env_gbps * 1e9, source="env")
        return device_peaks(calibrate=False)
    fingerprint = _device_fingerprint()
    cache = _peak_cache_path()
    if cache:
        cached = _load_peak_cache(cache, fingerprint)
        if cached is not None:
            set_peaks(cached["flops"], cached["bytes_per_s"], source="cache")
            return device_peaks(calibrate=False)
    if not calibrate:
        return None
    global _CALIBRATING
    with _LEDGER_LOCK:
        _tsan.note_access("telemetry.observatory.ledger")
        if _CALIBRATING:
            # another thread is already running the calibration kernels;
            # this caller reports peaks-unknown rather than doubling the
            # device work (the kernels run OUTSIDE the lock, so waiting
            # here would stall /rooflinez scrapes behind device time)
            return None
        _CALIBRATING = True
    try:
        peaks = _calibrate()
    except Exception:  # no usable backend: roofline reports peaks unknown
        return None
    finally:
        with _LEDGER_LOCK:
            _tsan.note_access("telemetry.observatory.ledger")
            _CALIBRATING = False
    set_peaks(peaks["flops"], peaks["bytes_per_s"], source="calibrated")
    if cache:
        _save_peak_cache(cache, fingerprint, peaks)
    return device_peaks(calibrate=False)


# ----------------------------------------------------------------------
# HBM watermarks + the measured-vs-predicted cross-check
# ----------------------------------------------------------------------
def set_memory_stats_provider(provider) -> None:
    """Install a memory-stats source for tests: ``() ->
    (bytes_in_use, peak_bytes, source)`` or None; pass ``None`` to
    restore the device/host probe."""
    global _MEM_PROVIDER
    _MEM_PROVIDER = provider


def _probe_memory() -> Optional[Tuple[float, float, str]]:
    """(bytes_in_use, peak_bytes, source) from the best available
    source: ``torch.cuda.memory_stats()`` (``allocated_bytes.all.current``
    and ``.peak``) summed over the local cards where ``torch.cuda`` is
    available, else the host RSS (without a card the port's "device
    memory" IS host memory), else None."""
    if _MEM_PROVIDER is not None:
        return _MEM_PROVIDER()
    import torch

    if torch.cuda.is_available():
        in_use = peak = 0.0
        for i in range(torch.cuda.device_count()):
            stats = torch.cuda.memory_stats(i)
            in_use += float(stats.get("allocated_bytes.all.current", 0) or 0)
            peak += float(stats.get("allocated_bytes.all.peak", 0) or 0)
        return in_use, peak, "device"
    try:
        import resource

        with open("/proc/self/statm") as f:
            rss_pages = int(f.read().split()[1])
        in_use = float(rss_pages * os.sysconf("SC_PAGE_SIZE"))
        peak = float(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024)
        return in_use, peak, "host_rss"
    except Exception:  # non-linux host: watermarks report nothing
        return None


def watermark() -> Dict[str, Any]:
    """The last watermark sample (sampling one fresh if none yet)."""
    with _LEDGER_LOCK:
        _tsan.note_access("telemetry.observatory.ledger", write=False)
        last = _WM["last"]
    if last is None:
        watermark_tick(force=True)
        with _LEDGER_LOCK:
            _tsan.note_access("telemetry.observatory.ledger", write=False)
            last = _WM["last"]
    return dict(last or {"source": None})


def _predicted_peak_bytes() -> float:
    """The static estimator's worst recorded per-device peak (0 until
    ROADMAP item 18 ports ``analysis.memory_model``)."""
    try:
        from ..analysis import memory_model as _mm

        return float(_mm.predicted_peak_bytes())
    except Exception:  # analysis layer unavailable: no prediction to check
        return 0.0


def _hbm_budget_bytes() -> float:
    try:
        return float(_env.env_str("HEAT_TPU_HBM_BUDGET_BYTES") or 0)
    except ValueError:
        return 0.0


def watermark_tick(force: bool = False) -> Optional[Dict[str, Any]]:
    """One watermark sample + cross-check (throttled to one per
    ``_WATERMARK_MIN_PERIOD_S`` unless forced).

    With ``HEAT_TPU_HBM_BUDGET_BYTES`` armed (> 0), fires the
    ``hbm:watermark`` alert when the measured in-use bytes exceed the
    budget (cause ``budget`` — the runtime companion to the static J301
    verdict) or the static estimator's predicted per-device peak by
    ``HEAT_TPU_HBM_ALERT_MARGIN`` (cause ``predicted`` — the prediction
    was wrong, trust it less); resolves the alert when the measurement
    drops back under.  Unarmed (budget 0, the default) the sample is
    recorded but no verdicts fire: a process-wide in-use number always
    dwarfs any single program's predicted peak, so the predicted
    cross-check is only meaningful against an operator-stated budget
    ceiling.  Returns the sample doc, or None when throttled / no
    memory source exists."""
    now = time.monotonic()
    with _LEDGER_LOCK:
        _tsan.note_access("telemetry.observatory.ledger", write=False)
        if not force and now - _WM["ts"] < _WATERMARK_MIN_PERIOD_S:
            return None
    probe = _probe_memory()
    if probe is None:
        return None
    in_use, peak, source = probe
    _WM_CHECKS_C.inc()
    predicted = _predicted_peak_bytes()
    budget = _hbm_budget_bytes()
    try:
        margin = float(_env.env_str("HEAT_TPU_HBM_ALERT_MARGIN") or 1.25)
    except ValueError:
        margin = 1.25
    doc = {
        "bytes_in_use": in_use,
        "peak_bytes": peak,
        "source": source,
        "predicted_peak_bytes": predicted,
        "budget_bytes": budget,
        "margin": margin,
        "sampled_at": time.time(),
    }
    with _LEDGER_LOCK:
        _tsan.note_access("telemetry.observatory.ledger")
        _WM["last"] = doc
        _WM["ts"] = now
        if in_use > _WM["peak_seen"]:
            _WM["peak_seen"] = in_use
    armed_check = budget > 0
    over_budget = armed_check and in_use > budget
    over_predicted = armed_check and predicted > 0 and in_use > predicted * margin
    for cause, over, bound in (
        ("budget", over_budget, budget),
        ("predicted", over_predicted, predicted * margin),
    ):
        if over:
            if _alerts.fire(
                "hbm:watermark",
                severity="page",
                message=(
                    f"measured memory in use {in_use:,.0f} B ({source}) exceeds the "
                    + (
                        f"armed HBM budget {budget:,.0f} B"
                        if cause == "budget"
                        else f"statically predicted peak {predicted:,.0f} B x "
                        f"margin {margin:g}"
                    )
                    + " — the runtime companion to J301"
                ),
                value=in_use,
                threshold=bound,
                labels={"cause": cause},
            ):
                _HBM_ALERTS_C.inc()
        else:
            _alerts.resolve("hbm:watermark", labels={"cause": cause})
    return doc


# ----------------------------------------------------------------------
# the roofline join
# ----------------------------------------------------------------------
def _ledger_rows() -> List[Tuple[str, Dict[str, Any]]]:
    """(key_repr, raw timing doc) per tracked key, under one lock hold."""
    from ..core import dispatch as _dispatch

    with _LEDGER_LOCK:
        _tsan.note_access("telemetry.observatory.ledger")
        drained = sum(s.drain() for s in _LEDGER.values() if s.pending)
        items = [(k, (s.calls, s.total_s, s.sync_samples, s.sync_total_s, s.sync_min_s))
                 for k, s in _LEDGER.items()]
    if drained:
        _SYNC_C.inc(drained)
    rows = []
    for key, (calls, total_s, n_sync, sync_total_s, sync_min_s) in items:
        fenced = n_sync > 0
        mean_s = (sync_total_s / n_sync) if fenced else (total_s / calls if calls else 0.0)
        rows.append(
            (
                _dispatch._key_repr(key),
                {
                    "calls": calls,
                    "total_ms": round(total_s * 1e3, 6),
                    "mean_ms": round(mean_s * 1e3, 6),
                    "enqueue_mean_ms": round(total_s / calls * 1e3, 6) if calls else 0.0,
                    "sync_samples": n_sync,
                    "sync_min_ms": round(sync_min_s * 1e3, 6) if fenced else None,
                    "timing": "fenced" if fenced else "enqueue",
                    "_mean_s": mean_s,
                },
            )
        )
    return rows


def _sig(x: float) -> float:
    """4 significant digits: a 231-FLOP bucket program's 2.3e-4 GFLOP/s
    must not round to a falsy 0.0 the way fixed decimals would."""
    return float(f"{x:.4g}")


def ledger_report(peaks: Optional[Dict[str, Any]] = None) -> List[Dict[str, Any]]:
    """Per-executable roofline rows, slowest total time first.

    Each row joins the ledger's measured time with the key's
    cost-accounting record (when one exists): achieved GFLOP/s and GB/s
    from the fenced mean, arithmetic intensity (FLOPs/byte), the
    roofline ceiling at that intensity, the utilization against it, and
    the bound-class verdict (``compute``/``bandwidth``; ``unknown``
    without peaks or cost data)."""
    from ..core import dispatch as _dispatch

    per_key_cost = _dispatch.cost_summary()["per_key"]
    peak_flops = float(peaks["flops"]) if peaks else 0.0
    peak_bps = float(peaks["bytes_per_s"]) if peaks else 0.0
    out = []
    for key_repr, doc in _ledger_rows():
        mean_s = doc.pop("_mean_s")
        cost = per_key_cost.get(key_repr)
        row = dict(doc, key=key_repr, flops=None, bytes=None,
                   gflops_per_s=None, gbytes_per_s=None, intensity=None,
                   utilization=None, bound="unknown")
        if cost and mean_s > 0:
            flops = float(cost.get("flops", 0.0) or 0.0)
            nbytes = float(cost.get("bytes_accessed", 0.0) or 0.0)
            row["flops"] = flops
            row["bytes"] = nbytes
            if flops > 0:
                row["gflops_per_s"] = _sig(flops / mean_s / 1e9)
            if nbytes > 0:
                row["gbytes_per_s"] = _sig(nbytes / mean_s / 1e9)
                if flops > 0:
                    row["intensity"] = _sig(flops / nbytes)
            if peak_flops > 0 and peak_bps > 0 and nbytes > 0:
                if flops > 0:
                    intensity = flops / nbytes
                    ridge = peak_flops / peak_bps
                    roof = min(peak_flops, intensity * peak_bps)
                    row["bound"] = "compute" if intensity >= ridge else "bandwidth"
                    row["utilization"] = _sig(flops / mean_s / roof)
                else:
                    row["bound"] = "bandwidth"
                    row["utilization"] = _sig(nbytes / mean_s / peak_bps)
        out.append(row)
    out.sort(key=lambda r: r["total_ms"], reverse=True)
    return out


def snapshot(calibrate: bool = False, max_rows: int = 50) -> Dict[str, Any]:
    """The ``observatory`` section /statusz, crash bundles and the
    metrics-dump atexit JSON embed: ledger rows (capped), the last
    watermark sample, and the calibration provenance.  Never runs
    device work unless ``calibrate=True``."""
    peaks = device_peaks(calibrate=calibrate)
    with _LEDGER_LOCK:
        _tsan.note_access("telemetry.observatory.ledger", write=False)
        wm = dict(_WM["last"] or {})
        peak_seen = _WM["peak_seen"]
    return {
        "enabled": _ENABLED,
        "sync_every": _SYNC_EVERY,
        "peaks": peaks,
        "watermark": dict(wm, peak_seen_bytes=peak_seen) if wm else None,
        "ledger": ledger_report(peaks)[:max_rows],
    }


def rooflinez_report(calibrate: bool = True, limit: Optional[int] = None) -> Dict[str, Any]:
    """The machine form of ``/rooflinez`` (``?format=json``).

    ``limit`` caps the ledger rows (slowest first) — the fleet router's
    health poller scrapes with a limit so a replica with a thousand
    tracked keys cannot bloat every poll."""
    peaks = device_peaks(calibrate=calibrate)
    ledger = ledger_report(peaks)
    truncated = limit is not None and len(ledger) > int(limit)
    return {
        "timestamp": time.time(),
        "pid": os.getpid(),
        "enabled": _ENABLED,
        "sync_every": _SYNC_EVERY,
        "peaks": peaks,
        "watermark": watermark(),
        "ledger": ledger[: int(limit)] if limit is not None else ledger,
        "ledger_total": len(ledger),
        "truncated": truncated,
        "profiler": capture_status(),
    }


def render_rooflinez_html() -> str:
    """The human form of ``/rooflinez``: peaks + watermark header and
    the per-executable roofline table."""
    import html as _html

    doc = rooflinez_report()
    peaks = doc["peaks"]
    wm = doc["watermark"] or {}
    head = "<h1>/rooflinez — kernel roofline observatory</h1>"
    if peaks:
        head += (
            f"<p>device peaks ({_html.escape(str(peaks['source']))}): "
            f"{peaks['flops'] / 1e9:.1f} GFLOP/s · "
            f"{peaks['bytes_per_s'] / 1e9:.1f} GB/s · ridge "
            f"{peaks['flops'] / max(peaks['bytes_per_s'], 1e-9):.2f} FLOP/B</p>"
        )
    else:
        head += "<p>device peaks: unknown (set HEAT_TPU_PEAK_FLOPS/GBPS or allow calibration)</p>"
    if wm.get("source"):
        head += (
            f"<p>memory watermark ({_html.escape(str(wm['source']))}): "
            f"{wm.get('bytes_in_use', 0) / 2**20:.1f} MiB in use · "
            f"predicted peak {wm.get('predicted_peak_bytes', 0) / 2**20:.1f} MiB · "
            f"budget {wm.get('budget_bytes', 0) / 2**20:.1f} MiB</p>"
        )
    cols = (
        "executable", "calls", "mean ms", "timing", "GFLOP/s", "GB/s",
        "intensity", "util", "bound",
    )
    rows = []
    for r in doc["ledger"]:
        rows.append(
            "<tr>"
            + "".join(
                f"<td>{_html.escape(str(v)) if v is not None else '—'}</td>"
                for v in (
                    r["key"], r["calls"], r["mean_ms"], r["timing"],
                    r["gflops_per_s"], r["gbytes_per_s"], r["intensity"],
                    r["utilization"], r["bound"],
                )
            )
            + "</tr>"
        )
    table = (
        "<table border=1 cellpadding=3><tr>"
        + "".join(f"<th>{c}</th>" for c in cols)
        + "</tr>"
        + "".join(rows)
        + "</table>"
    )
    if not rows:
        table = "<p>no dispatches recorded yet</p>"
    prof = doc["profiler"]
    prof_html = (
        f"<p>profiler: {'capture in flight' if prof['active'] else 'idle'} · "
        f"{len(prof['captures'])} completed capture(s) — POST /profilez/start "
        "to begin one (see /profilez)</p>"
    )
    return (
        "<html><head><title>/rooflinez</title></head><body>"
        + head + table + prof_html + "</body></html>"
    )


# ----------------------------------------------------------------------
# on-demand bounded profiler capture (/profilez)
# ----------------------------------------------------------------------
_PROF: Dict[str, Any] = {
    "active": False,
    "dir": None,
    "started_ts": 0.0,
    "duration_s": 0.0,
    "timer": None,
    "base_dir": None,
    "seq": 0,
    "captures": [],  # bounded history of completed captures
}


def _profile_base_dir() -> str:
    base = _env.env_str("HEAT_TPU_PROFILE_DIR")
    if not base:
        import tempfile

        base = os.path.join(tempfile.gettempdir(), f"heat_tpu_profilez_{os.getpid()}")
    os.makedirs(base, exist_ok=True)
    return base


def _profile_max_s() -> float:
    try:
        return max(0.1, float(_env.env_str("HEAT_TPU_PROFILE_MAX_S") or 30))
    except ValueError:
        return 30.0


def start_capture(duration_s: Optional[float] = None) -> Dict[str, Any]:
    """Start one bounded ``torch.profiler`` capture (CUDA activity on a
    card; the artifact is Chrome-trace JSON).

    Single in-flight: a second start while one runs raises
    ``RuntimeError`` (the /profilez route maps it to 409).  The duration
    is capped at ``HEAT_TPU_PROFILE_MAX_S``; an auto-stop timer fires at
    the deadline so a forgotten capture can never trace forever."""
    cap = _profile_max_s()
    duration = cap if duration_s is None else max(0.05, min(float(duration_s), cap))
    with _PROF_LOCK:
        _tsan.note_access("telemetry.observatory.profiler")
        if _PROF["active"]:
            raise RuntimeError(
                f"a profiler capture is already in flight (dir {_PROF['dir']!r}); "
                "stop it first (POST /profilez/stop)"
            )
        if _PROF["base_dir"] is None:
            _PROF["base_dir"] = _profile_base_dir()
        _PROF["seq"] += 1
        cap_dir = os.path.join(_PROF["base_dir"], f"capture_{_PROF['seq']:03d}")
        _PROF["active"] = True
        _PROF["dir"] = cap_dir
        _PROF["started_ts"] = time.time()
        _PROF["duration_s"] = duration
    try:
        from . import profiling as _profiling

        _profiling.start_trace(cap_dir)
    except Exception as e:  # profiler unavailable: release the slot and report
        with _PROF_LOCK:
            _tsan.note_access("telemetry.observatory.profiler")
            _PROF["active"] = False
            _PROF["dir"] = None
        raise RuntimeError(f"torch.profiler trace failed to start: {e}") from None
    timer = threading.Timer(duration, _auto_stop, args=(cap_dir,))
    timer.daemon = True
    with _PROF_LOCK:
        _tsan.note_access("telemetry.observatory.profiler")
        _PROF["timer"] = timer
    timer.start()
    return {"dir": cap_dir, "duration_s": duration, "started_ts": _PROF["started_ts"]}


def _auto_stop(cap_dir: str) -> None:
    """Deadline auto-stop (only if the same capture is still active)."""
    with _PROF_LOCK:
        _tsan.note_access("telemetry.observatory.profiler", write=False)
        if not (_PROF["active"] and _PROF["dir"] == cap_dir):
            return
    try:
        stop_capture(reason="deadline")
    except Exception:  # racing a manual stop is fine; exactly one wins
        pass


def _artifact_list(cap_dir: str) -> List[Dict[str, Any]]:
    files = []
    for root, _dirs, names in os.walk(cap_dir):
        for name in sorted(names):
            p = os.path.join(root, name)
            try:
                files.append(
                    {
                        "name": os.path.relpath(p, _PROF["base_dir"] or cap_dir),
                        "bytes": os.path.getsize(p),
                    }
                )
            except OSError:
                continue
    return files


def stop_capture(reason: str = "manual") -> Dict[str, Any]:
    """Stop the in-flight capture; returns its record (dir + artifact
    list).  Raises ``RuntimeError`` when none is running."""
    with _PROF_LOCK:
        _tsan.note_access("telemetry.observatory.profiler")
        if not _PROF["active"]:
            raise RuntimeError("no profiler capture in flight")
        cap_dir = _PROF["dir"]
        timer = _PROF["timer"]
        _PROF["active"] = False
        _PROF["dir"] = None
        _PROF["timer"] = None
    if timer is not None:
        timer.cancel()
    err = None
    try:
        from . import profiling as _profiling

        _profiling.stop_trace()
    except Exception as e:  # stop after a failed start must still free the slot
        err = f"{type(e).__name__}: {e}"
    rec = {
        "dir": cap_dir,
        "stopped_ts": time.time(),
        "reason": reason,
        "artifacts": _artifact_list(cap_dir),
        "error": err,
    }
    with _PROF_LOCK:
        _tsan.note_access("telemetry.observatory.profiler")
        _PROF["captures"].append(rec)
        del _PROF["captures"][:-_CAPTURES_KEPT]
    _CAPTURES_C.inc()
    return rec


def capture_status() -> Dict[str, Any]:
    """The /profilez status doc: in-flight state + completed captures."""
    with _PROF_LOCK:
        _tsan.note_access("telemetry.observatory.profiler", write=False)
        return {
            "active": _PROF["active"],
            "dir": _PROF["dir"],
            "started_ts": _PROF["started_ts"] if _PROF["active"] else None,
            "duration_s": _PROF["duration_s"] if _PROF["active"] else None,
            "max_duration_s": _profile_max_s(),
            "captures": [dict(c) for c in _PROF["captures"]],
        }


def artifact_path(name: str) -> str:
    """Absolute path of a capture artifact by its listed relative name;
    refuses anything escaping the capture base directory (the /profilez
    download route's traversal guard)."""
    with _PROF_LOCK:
        _tsan.note_access("telemetry.observatory.profiler", write=False)
        base = _PROF["base_dir"]
    if not base:
        raise FileNotFoundError("no captures have been taken")
    base_real = os.path.realpath(base)
    p = os.path.realpath(os.path.join(base_real, name))
    if not (p == base_real or p.startswith(base_real + os.sep)):
        raise PermissionError(f"artifact {name!r} escapes the capture directory")
    if not os.path.isfile(p):
        raise FileNotFoundError(f"no capture artifact {name!r}")
    return p


def render_profilez_html() -> str:
    """The human form of ``/profilez``."""
    import html as _html

    doc = capture_status()
    lines = ["<html><head><title>/profilez</title></head><body>",
             "<h1>/profilez — on-demand profiler capture</h1>"]
    if doc["active"]:
        lines.append(
            f"<p>capture IN FLIGHT in {_html.escape(str(doc['dir']))} "
            f"(auto-stops after {doc['duration_s']:g}s) — "
            "POST /profilez/stop to finish early</p>"
        )
    else:
        lines.append(
            "<p>idle — <code>curl -X POST "
            f"'http://.../profilez/start?duration_s=5'</code> begins a capture "
            f"(cap {doc['max_duration_s']:g}s)</p>"
        )
    for c in doc["captures"]:
        lines.append(
            f"<h3>{_html.escape(str(c['dir']))} ({_html.escape(str(c['reason']))})</h3><ul>"
        )
        for a in c["artifacts"]:
            name = _html.escape(str(a["name"]))
            lines.append(
                f"<li><a href=\"/profilez/artifact?name={name}\">{name}</a> "
                f"({a['bytes']} B)</li>"
            )
        lines.append("</ul>")
    lines.append("</body></html>")
    return "".join(lines)


# the observatory section rides in the HEAT_TPU_METRICS_DUMP atexit JSON
# (and crash bundles / statusz add it explicitly)
_metrics.register_dump_section("observatory", lambda: snapshot(calibrate=False))
