"""Structured host-side span tracer with Chrome-trace export
(counterpart of heat_tpu/telemetry/spans.py).

``span("name", **attrs)`` is a nestable context manager (and decorator)
recording wall-time spans into a bounded ring buffer — monotonic clocks,
thread-safe, ~no-op when disabled (``HEAT_TPU_TRACE=0``).  Each span
also opens a :func:`torch.profiler.record_function` of the same name
(where the reference opens a ``jax.profiler.TraceAnnotation``), so the
port's operations show up *attributed* in a ``torch.profiler`` trace of
the card: the kernels a span launches sit under its label.

:func:`export_chrome_trace` writes the ring buffer in Chrome
trace-event format — one JSON file viewable in ``chrome://tracing`` or
https://ui.perfetto.dev with **zero extra dependencies**.

Environment knobs:

* ``HEAT_TPU_TRACE=0`` — disable recording (span() costs one attribute
  read and records nothing: no ring write, no registry write).
* ``HEAT_TPU_TRACE_RING`` — ring capacity in spans (default 4096); the
  newest spans win, so a long fit keeps its tail.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque, namedtuple
from typing import Any, Callable, Dict, List, Optional

from ..analysis import tsan as _tsan
from ..core import _env
from . import metrics as _metrics
from . import tracing as _tracing

__all__ = [
    "SpanRecord",
    "span",
    "record_span",
    "stage_note",
    "flush_notes",
    "clear_notes",
    "tracing_enabled",
    "set_tracing",
    "get_spans",
    "clear_spans",
    "chrome_trace_doc",
    "export_chrome_trace",
]


_ENABLED = _env.env_flag("HEAT_TPU_TRACE")
_RING_SIZE = _env.env_int("HEAT_TPU_TRACE_RING")
_RING: "deque[SpanRecord]" = deque(maxlen=max(1, _RING_SIZE))
#: spans complete on any thread (async writer, loader workers) while the
#: introspection server's /trace handler iterates the ring from its own
#: thread — iterating a deque during an append raises RuntimeError, so
#: both sides hold the registered ring lock
_RING_LOCK = _tsan.register_lock("telemetry.spans.ring")
_TLS = threading.local()

#: completed-span counter in the shared registry; the ONLY registry
#: write the tracer makes, so disabled mode provably writes nothing
_RECORDED = _metrics.counter(
    "spans.recorded", "host-side spans recorded into the ring buffer"
)

try:  # record_function attributes spans in torch.profiler traces
    from torch.profiler import record_function as _ANNOTATION
except Exception:  # a torch without the profiler: spans still record
    _ANNOTATION = None

#: one completed span: monotonic start, duration, owning thread, nesting
#: depth at entry, the user attrs (payload bytes, step ids, ...), and —
#: when a request trace context was active — the trace identity
#: (``trace_id``/``span_id``/``parent_id``, else all None) that lets
#: ``/tracez`` and the Chrome flow export reassemble one request's spans
#: across threads (see :mod:`heat_tpu_torch.telemetry.tracing`)
SpanRecord = namedtuple(
    "SpanRecord",
    ["name", "start_ns", "duration_ns", "thread_id", "depth", "attrs",
     "trace_id", "span_id", "parent_id"],
    defaults=(None, None, None),
)


def tracing_enabled() -> bool:
    """Whether spans are being recorded."""
    return _ENABLED


def set_tracing(enabled: bool) -> bool:
    """Enable/disable span recording at runtime (overrides the env var);
    returns the previous state."""
    global _ENABLED
    prev = _ENABLED
    _ENABLED = bool(enabled)
    return prev


def refresh_env() -> bool:
    """Re-read ``HEAT_TPU_TRACE`` (tests that flip the env mid-process)."""
    global _ENABLED
    _ENABLED = _env.env_flag("HEAT_TPU_TRACE")
    return _ENABLED


def get_spans() -> List[SpanRecord]:
    """Completed spans currently in the ring buffer, oldest first."""
    with _RING_LOCK:
        _tsan.note_access("telemetry.spans.ring", write=False)
        return list(_RING)


def clear_spans() -> None:
    """Drop every recorded span."""
    with _RING_LOCK:
        _tsan.note_access("telemetry.spans.ring")
        _RING.clear()


class span:
    """Record one named wall-time span; context manager and decorator.

    ::

        with span("checkpoint.save", step=7):
            ...
        @span("fit.chunk")
        def run_chunk(...): ...

    Nesting is tracked per thread (``depth`` in the record); the
    enclosed region also runs under a ``torch.profiler.record_function``
    of the same name, so an active ``torch.profiler`` trace attributes
    its ops to this span.  When tracing is disabled the whole protocol is two
    attribute reads — nothing is recorded anywhere.
    """

    __slots__ = ("name", "attrs", "record", "_t0", "_depth", "_ann", "_live",
                 "_ctx", "_sid", "_token")

    def __init__(self, name: str, **attrs):
        self.name = name
        self.attrs = attrs
        self.record: Optional[SpanRecord] = None
        self._live = False

    def __enter__(self) -> "span":
        if not _ENABLED:
            return self
        self._live = True
        depth = getattr(_TLS, "depth", 0)
        _TLS.depth = depth + 1
        self._depth = depth
        # request-trace stamping: inside an active trace context this
        # span becomes the context's current span for anything it
        # encloses (child spans, nested dispatch/comm spans inherit)
        ctx = _tracing._CTX.get()
        if ctx is not None:
            self._ctx = ctx
            self._sid = _tracing.next_span_id()
            self._token = _tracing._CTX.set(
                _tracing.TraceContext(ctx.trace_id, self._sid)
            )
        else:
            self._ctx = None
            self._token = None
        if _ANNOTATION is not None:
            self._ann = _ANNOTATION(self.name)
            self._ann.__enter__()
        else:  # pragma: no cover
            self._ann = None
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if not self._live:
            return False
        dur = time.perf_counter_ns() - self._t0
        self._live = False
        if self._ann is not None:
            self._ann.__exit__(exc_type, exc, tb)
        _TLS.depth = self._depth
        if self._token is not None:
            _tracing._CTX.reset(self._token)
            self._token = None
        ctx = self._ctx
        rec = SpanRecord(
            self.name,
            self._t0,
            dur,
            threading.get_ident(),
            self._depth,
            self.attrs,
            ctx.trace_id if ctx is not None else None,
            self._sid if ctx is not None else None,
            ctx.span_id if ctx is not None else None,
        )
        self.record = rec
        _append_record(rec)
        if ctx is not None:
            _tracing._on_span(rec)
        return False

    def __call__(self, fn: Callable) -> Callable:
        import functools

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with span(self.name, **self.attrs):
                return fn(*args, **kwargs)

        return wrapped


def _append_record(rec: SpanRecord) -> None:
    """Land one completed record in the ring (shared by the span
    protocol, :func:`record_span`, and the trace root synthesis)."""
    with _RING_LOCK:
        _tsan.note_access("telemetry.spans.ring")
        _RING.append(rec)
    _RECORDED.inc()


def stage_note(name: str, start_ns: int, duration_ns: int, **attrs) -> None:
    """Buffer one explicitly-timed stage interval in thread-local scratch
    — the serving hot path's cheap alternative to :func:`record_span`.

    A note is a plain tuple append: no locks, no record construction,
    no ring write.  :func:`flush_notes` materializes the buffered notes
    into stamped :class:`SpanRecord`\\ s in ONE batch (one ring-lock
    acquisition for all of them) — the serving layer flushes once per
    request on the caller thread and once per coalesced batch on the
    batcher thread, so per-stage instrumentation stays under the
    ``tracing_overhead`` perf gate.  No-op while tracing is disabled."""
    if not _ENABLED:
        return
    buf = getattr(_TLS, "notes", None)
    if buf is None:
        buf = _TLS.notes = []
    buf.append((name, start_ns, duration_ns, attrs))


def clear_notes() -> None:
    """Drop this thread's buffered stage notes unrecorded (error paths:
    a failed batch must not leak its partial notes into the next one)."""
    buf = getattr(_TLS, "notes", None)
    if buf:
        buf.clear()


def flush_notes(extra: Optional[SpanRecord] = None) -> Optional[tuple]:
    """Hand this thread's buffered stage notes over — the buffer is
    always cleared.

    Inside a trace context the notes are NOT materialized at all: one
    raw batch tuple ``(thread_id, depth, parent_id, notes)`` is
    appended to the in-flight trace (a single lock-free append for
    every stage of a request or coalesced batch), and views materialize
    records later, off the request path.  The returned batch handle can
    be mirrored into co-batched traces with
    :func:`heat_tpu_torch.telemetry.tracing.link_batch`.  ``extra`` is an
    already-built record (the request root) written to the ring here.
    Outside a trace context the notes materialize into the ring
    directly (unstamped), as plain explicit-timing spans."""
    buf = getattr(_TLS, "notes", None)
    if not buf and extra is None:
        return None
    if not _ENABLED:
        if buf:
            buf.clear()
        return None
    ctx = _tracing._CTX.get()
    if ctx is not None:
        batch = None
        if buf:
            batch = (
                threading.get_ident(), getattr(_TLS, "depth", 0),
                ctx.span_id, tuple(buf),
            )
            buf.clear()
            _tracing._on_notes(ctx.trace_id, batch)
        if extra is not None:
            _append_record(extra)
        return batch
    ident = threading.get_ident()
    depth = getattr(_TLS, "depth", 0)
    recs = [
        SpanRecord(name, int(t0), int(dur), ident, depth, attrs)
        for name, t0, dur, attrs in (buf or ())
    ]
    if buf:
        buf.clear()
    if extra is not None:
        recs.append(extra)
    with _RING_LOCK:
        _tsan.note_access("telemetry.spans.ring")
        _RING.extend(recs)
    _RECORDED.inc(len(recs))
    return None


def record_span(name: str, start_ns: int, duration_ns: int, **attrs) -> Optional[SpanRecord]:
    """Record one span with *explicit* timing — for intervals no single
    ``with span(...)`` block can enclose (measured across threads, or
    reconstructed after the fact).  Stamped with the caller's active
    trace context exactly like a live span and recorded immediately;
    hot paths that record several stages per request should prefer
    :func:`stage_note` + :func:`flush_notes`, which batch the ring
    traffic.  Returns the record (None when tracing is disabled)."""
    if not _ENABLED:
        return None
    ctx = _tracing._CTX.get()
    rec = SpanRecord(
        name,
        int(start_ns),
        int(duration_ns),
        threading.get_ident(),
        getattr(_TLS, "depth", 0),
        attrs,
        ctx.trace_id if ctx is not None else None,
        _tracing.next_span_id() if ctx is not None else None,
        ctx.span_id if ctx is not None else None,
    )
    _append_record(rec)
    if ctx is not None:
        _tracing._on_span(rec)
    return rec


def _json_safe(v: Any) -> Any:
    if isinstance(v, (bool, int, float, str)) or v is None:
        return v
    return str(v)


def chrome_trace_doc() -> Dict[str, Any]:
    """The ring buffer as an in-memory Chrome trace-event document.

    The format is the ``traceEvents`` list of complete ("ph": "X")
    events — microsecond timestamps relative to the process's monotonic
    clock — that ``chrome://tracing`` and Perfetto load directly.  Span
    attrs land in each event's ``args``.  Spans that carry a request
    ``trace_id`` additionally emit **flow events** ("ph": "s"/"t"/"f",
    one flow per trace_id), so a request coalesced across threads draws
    as connected arrows from its caller-side spans through the batcher
    thread's batch spans.  The tail store's deferred stage records
    (never written to the ring on the hot path) are merged in here, so
    a retained request renders its full stage tree."""
    events: List[Dict[str, Any]] = []
    pid = os.getpid()
    by_trace: Dict[str, List[SpanRecord]] = {}
    for rec in list(get_spans()) + _tracing.note_records():
        args = {k: _json_safe(v) for k, v in rec.attrs.items()}
        if rec.trace_id is not None:
            args["trace_id"] = rec.trace_id
            by_trace.setdefault(rec.trace_id, []).append(rec)
        events.append(
            {
                "name": rec.name,
                "ph": "X",
                "ts": rec.start_ns / 1e3,
                "dur": rec.duration_ns / 1e3,
                "pid": pid,
                "tid": rec.thread_id,
                "args": args,
            }
        )
    # one flow per trace: start on its earliest span, step through the
    # middle ones, finish on the last — Chrome/Perfetto draw the arrows
    for trace_id, recs in by_trace.items():
        if len(recs) < 2:
            continue
        recs.sort(key=lambda r: r.start_ns)
        for i, rec in enumerate(recs):
            ph = "s" if i == 0 else ("f" if i == len(recs) - 1 else "t")
            ev = {
                "name": "request",
                "cat": "trace",
                "ph": ph,
                "id": trace_id,
                "ts": rec.start_ns / 1e3 + 0.001,
                "pid": pid,
                "tid": rec.thread_id,
            }
            if ph == "f":
                ev["bp"] = "e"
            events.append(ev)
    events.sort(key=lambda e: e["ts"])
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def export_chrome_trace(path: str, clear: bool = False) -> int:
    """Write the ring buffer as Chrome trace-event JSON (atomic
    write-temp-fsync-rename); returns the number of events written.
    See :func:`chrome_trace_doc` for the format."""
    # lazy import: resilience.faults imports telemetry.metrics at its top
    from ..resilience.atomic import atomic_write

    doc = chrome_trace_doc()
    # no CRC sidecar: the artifact is consumed by chrome://tracing /
    # perfetto, which would not know what a .crc32 neighbor means
    with atomic_write(path, checksum=False) as tmp:
        with open(tmp, "w") as f:
            json.dump(doc, f)
    if clear:
        clear_spans()
    return len(doc["traceEvents"])
