"""Central environment-knob registry and shared env parsing (counterpart of
heat_tpu/core/_env.py).

Every ``HEAT_TPU_*`` knob the port reads is declared ONCE in the
:data:`KNOBS` table below: name, type, default and a one-line doc.  Each
entry carries the reference's name, type, default and doc, except the
port's own knobs, whose doc says so (``HEAT_TPU_TORCH_BUILD_DIR``).  The
table holds only the knobs the port reads; a knob of the reference with no
reader in the port is not registered here.

The typed accessors (:func:`env_flag`, :func:`env_int`, :func:`env_float`,
:func:`env_str`) parse as the reference's do, and refuse an unregistered
name with the reference's ``KeyError``, set or not, so a typo'd knob read
fails loudly instead of silently returning a default forever.  Every
read of a ``HEAT_TPU_*`` variable in the port goes through them; each
reader keeps its own timing (a module constant read at import, or a read
per call).

The table is a **pure literal** (no computed values), so a linter can
read it with ``ast.literal_eval`` without importing the package.  This
module imports nothing but ``os``: the lowest layers (the sanitizer,
telemetry) read their knobs through it while they are imported.

Not ported: ``precision_from_env`` and ``precision_name_from_env`` (no
reader in the port; the hSVD and FFT precision knobs are ROADMAP work).
"""

from __future__ import annotations

import os
from typing import Dict, Optional

__all__ = [
    "KNOBS",
    "env_flag",
    "env_float",
    "env_int",
    "env_str",
    "knob_default",
    "registered_knobs",
]

#: Every HEAT_TPU_* knob the port reads: name -> (type, default, doc).
#: ``type`` is one of "bool" (0/false/no/off = off), "int", "float",
#: "str", "path" or "choice"; ``default`` is the value used when the
#: variable is unset (as a string, "" meaning "unset").  PURE LITERAL.
KNOBS = {
    # -- dispatch (core/dispatch.py) ------------------------------------
    "HEAT_TPU_DISPATCH_CACHE": ("bool", "1", "executable cache under the generic op wrappers (0 = plain eager jnp calls, fusion off too)"),
    "HEAT_TPU_DISPATCH_CACHE_SIZE": ("int", "1024", "LRU capacity of the compiled-executable cache"),
    "HEAT_TPU_COST_ANALYSIS": ("bool", "0", "record per-executable XLA cost/memory analysis at dispatch compile time (/statusz cost accounting)"),
    # -- static analysis (analysis/) ------------------------------------
    "HEAT_TPU_ANALYZE": ("choice", "0", "SPMD program analyzer on the dispatch compile path: 0 = off, 1 = warn, raise = error on any diagnostic"),
    "HEAT_TPU_ANALYZE_RING": ("int", "256", "capacity of the recent-diagnostics ring buffer"),
    "HEAT_TPU_TSAN": ("choice", "0", "concurrency sanitizer over the registered locks: 0 = off, 1 = armed (record tsan.* diagnostics), raise = armed + ProgramLintError at the finding site"),
    "HEAT_TPU_TSAN_DUMP": ("path", "", "write the sanitizer's findings as JSON to this path at process exit (the sanitized CI lane's audit artifact)"),
    "HEAT_TPU_TSAN_STACK_DEPTH": ("int", "10", "frames captured per lock-acquisition/access stack while the sanitizer is armed"),
    "HEAT_TPU_PREDICT_DTYPE": ("choice", "", "low-precision predict compute dtype for tolerance-policy estimators (bfloat16; empty = native float32); kinds whose POLICIES entry is bitwise or does not list the dtype keep serving native and emit one J204"),
    "HEAT_TPU_PROTOCOL_CHECK": ("choice", "0", "runtime conformance of journal events against the declared control-plane protocols (analysis/protocols.py): 0 = off (one global read per emit), 1 = warn (H805 diagnostic + protocol:<actor> alert per illegal transition), raise = ProgramLintError at the offending emit site"),
    # -- telemetry (telemetry/) -----------------------------------------
    "HEAT_TPU_TRACE": ("bool", "1", "host-side span recording (0 = span() costs two attribute reads and records nothing)"),
    "HEAT_TPU_TRACE_RING": ("int", "4096", "span ring-buffer capacity (newest spans win)"),
    "HEAT_TPU_TRACE_KEEP": ("int", "32", "tail-sampled trace store: complete span trees retained per class (recent / slowest / shed+errored) after the span ring rotates (/tracez)"),
    "HEAT_TPU_TRACE_MAX_SPANS": ("int", "256", "span cap per retained trace in the tail store (extra spans are counted as dropped, never unbounded)"),
    "HEAT_TPU_TRACE_EXEMPLARS": ("bool", "1", "histogram exemplars: stage/latency histogram buckets remember the most recent trace_id that landed in them (OpenMetrics exemplar syntax on /metrics)"),
    "HEAT_TPU_METRICS_DUMP": ("path", "", "write the final metrics snapshot as JSON to this path at process exit"),
    "HEAT_TPU_HTTP_PORT": ("int", "0", "serve the runtime-introspection HTTP endpoint (/metrics /varz /healthz /trace /statusz) on this port (0 = off)"),
    "HEAT_TPU_HEALTH_MAX_AGE_S": ("float", "0", "/healthz flips unhealthy when the fit heartbeat is older than this many seconds (0 = staleness check off)"),
    "HEAT_TPU_FLIGHT_RECORDER": ("path", "", "crash flight recorder: write atomic crash bundles into this directory on unhandled exceptions (empty = off)"),
    # -- roofline observatory (telemetry/observatory.py, /rooflinez) ----
    "HEAT_TPU_OBSERVATORY": ("bool", "1", "kernel roofline observatory: the dispatch layer notes every cached-executable call's wall time into the per-key execution ledger /rooflinez reports (0 = the dispatch hot path pays one flag check and records nothing)"),
    "HEAT_TPU_PERF_SYNC_EVERY": ("int", "16", "fenced-sample period of the execution ledger: every Nth call per dispatch key is a fenced sample that measures device time instead of async enqueue (on a card a pair of CUDA events around the call, read at report time; the host never waits), and piggybacks a throttled HBM watermark cross-check (0 = never fence)"),
    "HEAT_TPU_PEAK_FLOPS": ("float", "0", "device peak FLOP/s the roofline verdicts compare against (with HEAT_TPU_PEAK_GBPS; 0 = resolve from the calibration cache or the one-shot matmul/copy micro-calibration)"),
    "HEAT_TPU_PEAK_GBPS": ("float", "0", "device peak memory bandwidth in GB/s for the roofline verdicts (with HEAT_TPU_PEAK_FLOPS; 0 = resolve from the calibration cache or micro-calibration)"),
    "HEAT_TPU_PEAK_CACHE": ("path", "", "persist the micro-calibrated device peaks to this file (atomic + CRC32 sidecar, invalidated on a jax/backend/device fingerprint change) so fresh processes skip the calibration kernels (empty = in-process only)"),
    "HEAT_TPU_HBM_BUDGET_BYTES": ("int", "0", "per-device HBM budget for the static peak-memory estimator: a freshly compiled program whose predicted per-device peak exceeds this many bytes emits J301 (0 = budget check off)"),
    "HEAT_TPU_HBM_ALERT_MARGIN": ("float", "1.25", "measured-vs-predicted watermark margin: the hbm:watermark alert fires when measured memory in use exceeds the static estimator's predicted per-device peak by this factor (or the armed HEAT_TPU_HBM_BUDGET_BYTES at any margin)"),
    "HEAT_TPU_PROFILE_DIR": ("path", "", "base directory of /profilez on-demand jax.profiler captures (empty = a per-pid directory under the system temp dir)"),
    "HEAT_TPU_PROFILE_MAX_S": ("float", "30", "hard duration cap of one /profilez capture: every capture auto-stops at min(requested, this) seconds so a forgotten capture can never trace forever"),
    # -- quality signals: SLOs, drift, alerts, metric history ----------
    "HEAT_TPU_SLO_TICK_S": ("float", "0", "background SLO-monitor evaluation interval in seconds (0 = manual evaluate() only, except a serving process, which defaults its monitor to 1s when the /v1 routes mount)"),
    "HEAT_TPU_SLO_FAST_WINDOW_S": ("float", "60", "fast burn-rate window of the SLO monitors (page-latency window)"),
    "HEAT_TPU_SLO_SLOW_WINDOW_S": ("float", "300", "slow burn-rate window of the SLO monitors (flap suppressor)"),
    "HEAT_TPU_SLO_FAST_BURN": ("float", "14", "fast-window burn-rate factor an SLO must exceed to fire (error budget consumed 14x faster than allowed)"),
    "HEAT_TPU_SLO_SLOW_BURN": ("float", "2", "slow-window burn-rate factor an SLO must also exceed to fire (both windows must burn)"),
    "HEAT_TPU_SLO_LATENCY_MS": ("float", "25", "default serving latency objective: serving.latency_ms p99 must stay under this many milliseconds"),
    "HEAT_TPU_SLO_SHED_PCT": ("float", "1", "default serving shed objective: shed requests (quota + queue) must stay under this percent of admitted+shed"),
    "HEAT_TPU_SLO_HEARTBEAT_S": ("float", "0", "fit.heartbeat_ts freshness objective in seconds (0 = heartbeat SLO not installed; serving-only processes have no fit heartbeat)"),
    "HEAT_TPU_ALERT_RING": ("int", "256", "capacity of the alert fired/resolved transition ring (/sloz, /statusz, crash bundles)"),
    "HEAT_TPU_TSDB_INTERVAL_S": ("float", "1.0", "embedded metric-history sampler interval: seconds between registry scrapes into the /queryz ring buffers"),
    "HEAT_TPU_TSDB_RETENTION": ("int", "512", "points retained per metric-history series (memory is series x retention x two floats, strictly bounded)"),
    "HEAT_TPU_TSDB_SERIES": ("str", "", "comma-separated allowlist of registry series the TSDB sampler scrapes (trailing * = prefix match); empty = the curated control-plane default set (slo.*, serve.*, drift.*, canary.*, fleet.*, qos.*, stream.*, journal.*, alerts.*, dispatch.compile_fallbacks)"),
    "HEAT_TPU_SKETCH": ("bool", "1", "input-drift sketches on the /v1/predict path: per-feature moments + log-bucket histograms folded per coalesced batch off the caller's latency path"),
    "HEAT_TPU_DRIFT_THRESHOLD": ("float", "0.25", "PSI score above which a served model's input distribution counts as drifted (fires the drift:<model> alert and flips its /healthz status)"),
    "HEAT_TPU_DRIFT_MIN_ROWS": ("int", "200", "rows the live sketch must hold before a drift score is reported (small-sample PSI is noise: ~0.2 at 100 in-distribution rows against a 0.25 threshold)"),
    "HEAT_TPU_JOURNAL_RING": ("int", "256", "capacity of the control-plane decision-journal hot ring (/decisionz, cross-worker snapshots, crash bundles)"),
    "HEAT_TPU_JOURNAL_DIR": ("str", "", "durable decision-journal directory: every journal event also commits as an immutable atomic+CRC jsonl segment there, replayable after the process dies via python -m heat_tpu.telemetry.replay (empty = hot ring only)"),
    # -- resilience (resilience/) ---------------------------------------
    "HEAT_TPU_FAULT_PLAN": ("str", "", "fault-injection plan: inline JSON or a path to a JSON file"),
    "HEAT_TPU_RETRY_NO_SLEEP": ("bool", "0", "record retry backoff delays without sleeping (deterministic failure tests)"),
    "HEAT_TPU_IO_RETRY_ATTEMPTS": ("int", "3", "max attempts of the io load/save retry policy"),
    "HEAT_TPU_IO_RETRY_BASE_DELAY": ("float", "0.05", "first backoff delay (s) of the io retry policy"),
    "HEAT_TPU_IO_RETRY_MAX_DELAY": ("float", "2.0", "backoff delay cap (s) of the io retry policy"),
    "HEAT_TPU_INIT_RETRY_ATTEMPTS": ("int", "3", "max attempts of the parallel.init() bootstrap retry policy"),
    "HEAT_TPU_INIT_RETRY_BASE_DELAY": ("float", "0.5", "first backoff delay (s) of the init retry policy"),
    "HEAT_TPU_INIT_RETRY_MAX_DELAY": ("float", "10.0", "backoff delay cap (s) of the init retry policy"),
    "HEAT_TPU_IO_CHECKSUM": ("bool", "1", "CRC32 sidecar writing + load-side verification on every io path"),
    # -- elastic (elastic/) ---------------------------------------------
    "HEAT_TPU_ELASTIC_MAX_RECOVERIES": ("int", "2", "how many worker-loss recoveries (reshape + resume) the elastic supervisor attempts before re-raising"),
    "HEAT_TPU_ELASTIC_MIN_WORLD": ("int", "1", "smallest world size the elastic supervisor may reshape down to"),
    "HEAT_TPU_ELASTIC_HEARTBEAT_TIMEOUT_S": ("float", "0", "declare a worker lost when its fit heartbeat is older than this many seconds (0 = liveness detection off, exit-code detection only)"),
    "HEAT_TPU_ELASTIC_POLL_S": ("float", "0.5", "polling interval of the elastic supervisor's heartbeat monitor"),
    "HEAT_TPU_HEARTBEAT_FILE": ("path", "", "touch this file at every resumable-fit chunk boundary (the cross-process liveness signal the elastic process supervisor watches)"),
    # -- artifact cache (core/aot_cache.py) -----------------------------
    "HEAT_TPU_AOT_CACHE": ("path", "", "persistent on-disk AOT executable cache directory: dispatch cache misses load serialized compiled artifacts instead of compiling, and fresh compiles are persisted for the next process (empty = off)"),
    "HEAT_TPU_AOT_SAVE": ("bool", "1", "whether an armed AOT cache may write artifacts (0 = read-only: replicas load the fleet's artifacts, only a designated writer populates them)"),
    # -- overlap / nn ---------------------------------------------------
    "HEAT_TPU_ASYNC_CKPT": ("bool", "1", "asynchronous checkpoint writes in resumable fits (0 = fully synchronous saves)"),
    "HEAT_TPU_GRAD_BUCKET_MB": ("float", "4", "byte bound (MiB) of one bucketed gradient-reduction psum"),
    # -- sparse ---------------------------------------------------------
    "HEAT_TPU_SPGEMM_DENSE_DENSITY": ("float", "0.5", "estimated-output-density threshold at which sparse@sparse matmul falls back from the output-sparse triplet ring to the GEMM-style dense route (estimate: 1 - exp(-nnz_A*nnz_B/(m*k*n)); 1.0 = always ring, 0.0 = always dense)"),
    # -- the port's own knobs (no entry in the reference's table) -------
    "HEAT_TPU_TORCH_BUILD_DIR": ("path", "", "the port's own knob (no reference entry): directory the CUDA kernels of heat_tpu_torch/csrc are built into and loaded from (empty = build/heat_tpu_torch in a checkout, else the per-user cache)"),
}

_FALSE_WORDS = ("0", "false", "no", "off")


def registered_knobs() -> Dict[str, tuple]:
    """Copy of the knob table (name -> (type, default, doc))."""
    return dict(KNOBS)


def _lookup(name: str) -> tuple:
    try:
        return KNOBS[name]
    except KeyError:
        raise KeyError(
            f"{name!r} is not a registered HEAT_TPU knob; add it to "
            "heat_tpu_torch.core._env.KNOBS (name, type, default, doc)"
        ) from None


def knob_default(name: str) -> str:
    """The registered default (string form) of ``name``."""
    return _lookup(name)[1]


def env_str(name: str, default: Optional[str] = None) -> str:
    """Raw string value of a registered knob (default from the table)."""
    d = _lookup(name)[1] if default is None else default
    return os.environ.get(name, d)


def env_flag(name: str, default: Optional[bool] = None) -> bool:
    """Boolean knob: unset -> registered default; ``0/false/no/off``
    (any case) -> False; anything else -> True."""
    registered = _lookup(name)[1]
    v = os.environ.get(name)
    if v is None:
        if default is not None:
            return default
        v = registered
    return str(v).strip().lower() not in _FALSE_WORDS


def env_int(name: str, default: Optional[int] = None) -> int:
    """Integer knob (registered default when unset)."""
    registered = _lookup(name)[1]
    v = os.environ.get(name)
    if v is None:
        return int(registered) if default is None else default
    return int(v)


def env_float(name: str, default: Optional[float] = None) -> float:
    """Float knob (registered default when unset)."""
    registered = _lookup(name)[1]
    v = os.environ.get(name)
    if v is None:
        return float(registered) if default is None else default
    return float(v)
