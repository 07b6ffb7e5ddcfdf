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
