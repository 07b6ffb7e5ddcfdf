"""Observability (counterpart of heat_tpu/telemetry): the metrics
registry, structured spans, request tracing and the decision journal.

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
  journal (hot ring, durable CRC32-checked segments, causal links).

The rest of the reference's telemetry (the time-series store, alerts,
SLOs, drift sketches, cross-worker aggregation, the flight recorder,
the roofline observatory, the introspection server, profiling hooks and
the inspect CLI) is ROADMAP item 17a.

``HEAT_TPU_METRICS_DUMP=<path>`` writes the final snapshot as JSON at
process exit.
"""

from __future__ import annotations

import atexit
import os
import time as _time
from typing import Dict, Optional

from . import metrics
from . import journal
from . import tracing
from . import spans
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
from .journal import (
    DecisionEvent,
    causal_chain,
    decisionz_report,
    emit,
    journal_events,
    read_journal,
)

__all__ = [
    "Counter",
    "DecisionEvent",
    "Gauge",
    "Histogram",
    "Info",
    "MetricsRegistry",
    "REGISTRY",
    "SpanRecord",
    "TraceContext",
    "bind_context",
    "causal_chain",
    "chrome_trace_doc",
    "clear_spans",
    "counter",
    "current_context",
    "current_trace_id",
    "decisionz_report",
    "dump_json",
    "emit",
    "export_chrome_trace",
    "expose",
    "gauge",
    "get_spans",
    "histogram",
    "journal_events",
    "read_journal",
    "record_span",
    "request_span",
    "reset_all",
    "set_tracing",
    "snapshot",
    "span",
    "tracez_report",
    "tracing_enabled",
    "use_context",
]

#: per-domain reset functions delegate here with these names; a domain
#: maps to the registry prefixes it owns (the reference's names, for the
#: domains the port has)
_DOMAIN_PREFIXES = {
    "faults": ("fault.",),
    "retry": ("retry.",),
    "resilience": ("fault.", "retry."),
    "comm": ("comm.",),
    "fit": ("fit.",),
    "spans": ("spans.",),
    "tracing": ("tracing.",),
    "journal": ("journal.",),
    "telemetry": ("spans.", "tracing.", "fit.", "telemetry.", "journal."),
}


def reset_all(domain: Optional[str] = None) -> None:
    """Zero telemetry state in one call.

    With no argument: every registered metric AND the span ring buffer
    AND the tail-sampled trace store AND the decision journal.  With a
    domain name (``"faults"``, ``"retry"``, ``"resilience"``, ``"spans"``,
    ...), only that domain's metrics (and its ring, store or journal);
    ``reset_fault_stats`` / ``reset_retry_stats`` delegate here."""
    if domain is None:
        metrics.reset(None)
        spans.clear_spans()
        tracing.reset_store()
        journal.reset_journal()
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
    if domain in ("journal", "telemetry"):
        journal.reset_journal()


@atexit.register
def _dump_at_exit() -> None:  # pragma: no cover - exercised via subprocess
    """``HEAT_TPU_METRICS_DUMP=<path>``: write the final metrics snapshot
    as JSON at interpreter exit (checked at exit time, so setting the
    variable after import still works), through the atomic+CRC32 writer."""
    path = os.environ.get("HEAT_TPU_METRICS_DUMP")
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
