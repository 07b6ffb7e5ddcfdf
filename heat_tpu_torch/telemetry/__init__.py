"""Observability (counterpart of heat_tpu/telemetry): the metrics
registry, structured spans, request tracing, the decision journal, and
the quality, roofline and forensics layers built on them.

* :mod:`~heat_tpu_torch.telemetry.metrics` — process-global named
  counters, gauges and bounded histograms; :func:`snapshot` returns
  everything in one document and :func:`expose` emits Prometheus /
  OpenMetrics text, the reference's text for the same calls.
* :mod:`~heat_tpu_torch.telemetry.spans` — nestable host-side spans in
  a bounded ring buffer (``HEAT_TPU_TRACE=0`` disables), each doubling
  as a ``torch.profiler.record_function`` so a ``torch.profiler`` trace
  of the card attributes its kernels to the port's operations;
  :func:`export_chrome_trace` writes ``chrome://tracing``-loadable JSON.
* :mod:`~heat_tpu_torch.telemetry.tracing` — request trace contexts
  carried across threads and the tail-sampled trace store.
* :mod:`~heat_tpu_torch.telemetry.journal` — the control-plane decision
  journal (hot ring, durable CRC32-checked segments, causal links);
  :mod:`~heat_tpu_torch.telemetry.replay` replays a durable journal.
* :mod:`~heat_tpu_torch.telemetry.profiling` — ``start_trace``/
  ``stop_trace``/``trace``/``annotate``/``monitor`` on ``torch.profiler``
  (also ``utils.profiling``).
* :mod:`~heat_tpu_torch.telemetry.observatory` — the roofline
  observatory: every warm dispatch and every hand-written kernel launch
  timed into a per-key ledger (fenced every ``HEAT_TPU_PERF_SYNC_EVERY``-th
  call), joined with its cost against peaks calibrated on the device;
  watermarks from ``torch.cuda.memory_stats``; ``/profilez`` captures.
* :mod:`~heat_tpu_torch.telemetry.server` — the runtime-introspection
  HTTP endpoint (``HEAT_TPU_HTTP_PORT``; ``/metrics`` ``/varz``
  ``/healthz`` ``/rooflinez`` ``/queryz`` ``/sloz`` ``/statusz`` and the
  rest of the reference's routes, on a daemon thread, off by default).
* :mod:`~heat_tpu_torch.telemetry.slo`, :mod:`~.alerts`, :mod:`~.sketch`,
  :mod:`~.tsdb`, :mod:`~.tenants` — SLO burn rates, deduplicated alerts,
  drift sketches, the embedded metric history and per-tenant cost.
* :mod:`~heat_tpu_torch.telemetry.aggregate` — cross-worker snapshot
  tagging/merging with straggler/skew gauges (``all_gather_object`` over
  a joined process group, else per-worker JSON files).
* :mod:`~heat_tpu_torch.telemetry.flight_recorder` — crash bundles
  (``HEAT_TPU_FLIGHT_RECORDER``), rendered by
  ``python -m heat_tpu_torch.telemetry.inspect``.

Instrumentation wired through the stack: every collective of
``parallel.comm`` accounts payload bytes x participants into
``comm.bytes.{op}`` / ``comm.calls.{op}`` under a ``comm.{op}`` span, per
call issued; the dispatch layer records first-application wall time into
``dispatch.compile_ms`` and notes warm calls and kernel launches into the
observatory; ``core.base.resumable_fit_loop`` emits heartbeat spans and
the ``fit.iter_rate`` gauge.

``HEAT_TPU_METRICS_DUMP=<path>`` writes the final snapshot (with the
observatory section) as JSON at process exit.
"""

from __future__ import annotations

import atexit
import time as _time
from typing import Dict, Optional

from ..core import _env
from . import metrics
from . import journal
from . import tsdb
from . import tracing
from . import spans
from . import profiling
from . import alerts
from . import slo
from . import sketch
from . import aggregate
from . import flight_recorder
from . import observatory
from . import server
from . import tenants
from .metrics import (
    Counter,
    Gauge,
    Histogram,
    Info,
    MetricsRegistry,
    REGISTRY,
    counter,
    dump_json,
    expose,
    gauge,
    histogram,
    snapshot,
)
from .spans import (
    SpanRecord,
    chrome_trace_doc,
    clear_spans,
    export_chrome_trace,
    get_spans,
    record_span,
    set_tracing,
    span,
    tracing_enabled,
)
from .tracing import (
    TraceContext,
    bind_context,
    current_context,
    current_trace_id,
    request_span,
    tracez_report,
    use_context,
)
from .profiling import annotate, monitor, start_trace, stop_trace, trace
from .aggregate import (
    gather_snapshots,
    merge_snapshots,
    tag_snapshot,
    write_worker_snapshot,
)
from .flight_recorder import dump_bundle
from .observatory import (
    device_peaks,
    rooflinez_report,
    start_capture,
    stop_capture,
    watermark_tick,
)
from .server import start_server, stop_server
from .alerts import active_alerts, alert_events, alerts_snapshot
from .journal import (
    DecisionEvent,
    causal_chain,
    decisionz_report,
    emit,
    journal_events,
    read_journal,
)
from .tsdb import (
    query,
    queryz_report,
    record,
    sample_once,
    start_sampler,
    stop_sampler,
    window_stats,
)
from .slo import (
    SLO,
    install_default_slos,
    parse_slo,
    register_slo,
    slo_report,
    start_monitor,
    stop_monitor,
)
from .sketch import SKETCHES, check_drift, drift_report, record_batch

__all__ = [
    "Counter",
    "DecisionEvent",
    "Gauge",
    "Histogram",
    "Info",
    "MetricsRegistry",
    "REGISTRY",
    "SKETCHES",
    "SLO",
    "SpanRecord",
    "TraceContext",
    "active_alerts",
    "alert_events",
    "alerts_snapshot",
    "annotate",
    "bind_context",
    "causal_chain",
    "check_drift",
    "chrome_trace_doc",
    "clear_spans",
    "counter",
    "current_context",
    "current_trace_id",
    "decisionz_report",
    "device_peaks",
    "drift_report",
    "dump_bundle",
    "dump_json",
    "emit",
    "export_chrome_trace",
    "expose",
    "gather_snapshots",
    "gauge",
    "get_spans",
    "histogram",
    "install_default_slos",
    "journal_events",
    "merge_snapshots",
    "monitor",
    "parse_slo",
    "query",
    "queryz_report",
    "read_journal",
    "record",
    "record_batch",
    "record_span",
    "register_slo",
    "request_span",
    "reset_all",
    "rooflinez_report",
    "sample_once",
    "set_tracing",
    "slo_report",
    "snapshot",
    "span",
    "start_capture",
    "start_monitor",
    "start_sampler",
    "start_server",
    "start_trace",
    "stop_capture",
    "stop_monitor",
    "stop_sampler",
    "stop_server",
    "stop_trace",
    "summary_line",
    "tag_snapshot",
    "trace",
    "tracez_report",
    "tracing_enabled",
    "use_context",
    "watermark_tick",
    "window_stats",
    "write_worker_snapshot",
]

#: per-domain reset functions delegate here with these names; a domain
#: maps to the registry prefixes it owns (the reference's names, for the
#: domains the port has)
_DOMAIN_PREFIXES = {
    "dispatch": ("dispatch.",),
    "faults": ("fault.",),
    "retry": ("retry.",),
    "resilience": ("fault.", "retry."),
    "overlap": ("overlap.",),
    "comm": ("comm.",),
    "fit": ("fit.",),
    "spans": ("spans.",),
    "tracing": ("tracing.",),
    "flight": ("flight.",),
    "checkpoint": ("checkpoint.",),
    "alerts": ("alerts.",),
    "slo": ("slo.",),
    "drift": ("drift.",),
    "observatory": ("observatory.",),
    "journal": ("journal.",),
    "tsdb": ("tsdb.",),
    "telemetry": ("spans.", "tracing.", "fit.", "telemetry.", "flight.",
                  "checkpoint.", "alerts.", "slo.", "drift.", "observatory.",
                  "journal.", "tsdb."),
}


def reset_all(domain: Optional[str] = None) -> None:
    """Zero telemetry state in one call.

    With no argument: every registered metric AND the span ring buffer
    AND the tail-sampled trace store AND the alerts, SLO monitors, drift
    sketches, observatory ledger, decision journal and metric history.
    With a domain name (``"dispatch"``, ``"faults"``, ``"retry"``,
    ``"resilience"``, ``"comm"``, ``"spans"``, ``"observatory"``, ...),
    only that domain's metrics (and its ring, store or table);
    ``reset_fault_stats`` / ``reset_retry_stats`` delegate here."""
    if domain is None:
        metrics.reset(None)
        spans.clear_spans()
        tracing.reset_store()
        alerts.clear_alerts()
        slo.reset_monitors()
        sketch.SKETCHES.clear()
        observatory.reset()
        journal.reset_journal()
        tsdb.reset_tsdb()
        return
    prefixes = _DOMAIN_PREFIXES.get(domain)
    if prefixes is None:
        raise ValueError(
            f"unknown telemetry domain {domain!r}; known: {sorted(_DOMAIN_PREFIXES)}"
        )
    for p in prefixes:
        metrics.reset(p)
    if domain in ("spans", "telemetry"):
        spans.clear_spans()
    if domain in ("tracing", "telemetry"):
        tracing.reset_store()
    if domain in ("alerts", "telemetry"):
        alerts.clear_alerts()
    if domain in ("slo", "telemetry"):
        slo.reset_monitors()
    if domain in ("drift", "telemetry"):
        sketch.SKETCHES.clear()
    if domain in ("observatory", "telemetry"):
        observatory.reset()
    if domain in ("journal", "telemetry"):
        journal.reset_journal()
    if domain in ("tsdb", "telemetry"):
        tsdb.reset_tsdb()


def summary_line(iter_rate: Optional[float] = None) -> str:
    """One-line human summary of the headline metrics — the string the
    example scripts print after a fit: cumulative collective traffic
    (bytes x participants of the collectives issued), total
    first-application wall time (``dispatch.compile_ms``), and the last
    fit iteration rate (``fit.iter_rate`` gauge, or the explicit
    ``iter_rate`` argument)."""
    snap = metrics.snapshot()
    comm_bytes = sum(
        v for k, v in snap.items()
        if k.startswith("comm.bytes.") and isinstance(v, (int, float))
    )
    compile_doc = snap.get("dispatch.compile_ms") or {}
    compile_ms = float(compile_doc.get("sum") or 0.0)
    if iter_rate is None:
        rate = snap.get("fit.iter_rate") or 0.0
    else:
        rate = iter_rate
    rate_s = f"{rate:.1f} iter/s" if rate else "n/a"
    return (
        f"telemetry: comm {comm_bytes / 2**30:.4f} GiB · "
        f"compile {compile_ms:.0f} ms · iter rate {rate_s}"
    )


@atexit.register
def _dump_at_exit() -> None:  # pragma: no cover - exercised via subprocess
    """``HEAT_TPU_METRICS_DUMP=<path>``: write the final metrics snapshot
    as JSON at interpreter exit (checked at exit time, so setting the
    variable after import still works), through the atomic+CRC32 writer."""
    path = _env.env_str("HEAT_TPU_METRICS_DUMP")
    if not path:
        return
    try:
        metrics.dump_json(path)
    except Exception:  # best effort at interpreter exit
        pass


def build_info_labels() -> Dict[str, str]:
    """The binary's identity labels: heat_tpu_torch's version, torch's and
    CUDA's versions, the backend and the card's name.  Resolved lazily by
    the ``build_info`` metric on its first read (asking for the card's
    name initializes CUDA; an import must not)."""
    from ..version import __version__ as _v

    labels: Dict[str, str] = {"version": str(_v)}
    try:
        import torch

        labels["torch"] = str(torch.__version__)
        labels["cuda"] = str(torch.version.cuda)
        on_card = torch.cuda.is_available()
        labels["backend"] = "cuda" if on_card else "cpu"
        labels["device_kind"] = torch.cuda.get_device_name(0) if on_card else "cpu"
    except Exception:  # no working backend: identity degrades to the version labels
        labels.setdefault("backend", "unavailable")
    return labels


#: identity metrics on every scrape: which binary produced these numbers,
#: and since when.  The start timestamp is a callback gauge so
#: ``reset_all()`` cannot zero the process's birth time.
_PROCESS_START_TS = _time.time()
metrics.info(
    "build_info",
    "binary identity: heat_tpu_torch/torch/CUDA versions, backend, device kind",
    fn=build_info_labels,
)
metrics.gauge(
    "process.start_ts",
    "unix timestamp this process imported heat_tpu_torch.telemetry",
    fn=lambda: _PROCESS_START_TS,
)

# runtime introspection: HEAT_TPU_HTTP_PORT starts the HTTP endpoint,
# HEAT_TPU_FLIGHT_RECORDER arms the crash recorder — both off by
# default, both zero-cost when off
server.maybe_start_from_env()
flight_recorder.maybe_install_from_env()
