"""Request-scoped tracing: one trace_id from a request to its spans
(counterpart of heat_tpu/telemetry/tracing.py).

* a **trace context** (:class:`TraceContext`: ``trace_id`` + current
  span id) carried in a :mod:`contextvars` variable — every
  :class:`~heat_tpu_torch.telemetry.spans.span` opened while a context
  is active stamps ``trace_id`` / ``span_id`` / ``parent_id`` into its
  :class:`~heat_tpu_torch.telemetry.spans.SpanRecord`, so nested spans
  inherit the request that triggered them with no change at their call
  sites;
* **handoff helpers** (:func:`current_context`, :func:`use_context`,
  :func:`bind_context`) so the context survives thread hops (a worker
  pool, a loader thread);
* a **tail-sampled trace store**: the span ring is a bounded window, so
  the slow request you want to debug has usually rotated out by the time
  you look.  The store keeps *complete span trees* — its own copies,
  immune to ring rotation — for the ``HEAT_TPU_TRACE_KEEP`` most recent
  requests per route, the slowest-k requests overall, and **every**
  shed or errored request, bounded in every dimension
  (``HEAT_TPU_TRACE_MAX_SPANS`` spans per trace).
  :func:`tracez_report` renders it, and :func:`trace_digest` gives a
  compact form for cross-worker snapshots.

The knobs, the store's retention rules and its documents are the
reference's.  The tracer stays ~free when idle: with no active context a
span pays one ``ContextVar.get``, and with ``HEAT_TPU_TRACE=0`` this
module records **nothing** — no store entry, no registry write.
"""

from __future__ import annotations

import bisect
import contextvars
import itertools
import os
import threading
import time
from collections import deque, namedtuple
from typing import Any, Callable, Dict, List, Optional, Sequence

from ..analysis import tsan as _tsan
from . import metrics as _metrics

__all__ = [
    "TraceContext",
    "bind_context",
    "current_context",
    "current_trace_id",
    "exemplars_enabled",
    "get_trace",
    "link_spans",
    "new_trace_id",
    "next_span_id",
    "request_span",
    "reset_store",
    "retained_traces",
    "set_exemplars",
    "trace_digest",
    "traces_snapshot",
    "tracez_report",
    "use_context",
]


def _env_on(name: str, default: bool = True) -> bool:
    v = os.environ.get(name)
    if v is None:
        return default
    return v.strip().lower() not in ("0", "false", "no", "off")


# knobs read from the environment directly, with the reference's defaults
_KEEP = int(os.environ.get("HEAT_TPU_TRACE_KEEP", "32"))
_MAX_SPANS = int(os.environ.get("HEAT_TPU_TRACE_MAX_SPANS", "256"))
_EXEMPLARS = _env_on("HEAT_TPU_TRACE_EXEMPLARS", True)

#: the ambient trace context of the current thread/task.  ``None`` means
#: "not inside a traced request" — the state every untraced code path
#: stays in, paying one ContextVar read per span.
TraceContext = namedtuple("TraceContext", ["trace_id", "span_id"])
_CTX: "contextvars.ContextVar[Optional[TraceContext]]" = contextvars.ContextVar(
    "heat_tpu_torch_trace_context", default=None
)

#: process-unique span ids (CPython's count.__next__ is atomic)
_SPAN_IDS = itertools.count(1)
_TRACE_SEQ = itertools.count(1)


#: per-process 64-bit base; trace ids are base+counter so allocation is
#: one atomic counter step, while ids stay unique across pod workers
#: (urandom base) — a clock-seeded base would collide on same-tick starts
_TRACE_ID_BASE = int.from_bytes(os.urandom(8), "big")


def new_trace_id() -> str:
    """A fresh 64-bit trace id (16 hex chars, urandom-based — unique
    across pod workers, unlike a clock)."""
    return f"{(_TRACE_ID_BASE + next(_TRACE_SEQ)) & 0xFFFFFFFFFFFFFFFF:016x}"


def next_span_id() -> int:
    """Allocate a process-unique span id."""
    return next(_SPAN_IDS)


def current_context() -> Optional[TraceContext]:
    """The active :class:`TraceContext` of this thread (None outside a
    traced request) — capture it before handing work to another thread."""
    return _CTX.get()


def current_trace_id() -> Optional[str]:
    """The active trace id, or None outside a traced request."""
    ctx = _CTX.get()
    return ctx.trace_id if ctx is not None else None


class use_context:
    """Attach a captured context on *this* thread for the enclosed block
    — the explicit handoff helper for thread hops (a worker pool, a
    loader thread).  ``None`` is a no-op
    so call sites need no branching.  A plain slotted context manager
    (not a generator) — it sits on the serving batcher's per-batch path."""

    __slots__ = ("ctx", "_token")

    def __init__(self, ctx: Optional[TraceContext]):
        self.ctx = ctx
        self._token = None

    def __enter__(self) -> Optional[TraceContext]:
        if self.ctx is not None:
            self._token = _CTX.set(self.ctx)
        return self.ctx

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self._token is not None:
            _CTX.reset(self._token)
            self._token = None
        return False


def bind_context(fn: Callable, ctx: Optional[TraceContext] = None) -> Callable:
    """Wrap ``fn`` so it runs under the given (default: current) trace
    context wherever it is later called — the handoff helper for thread
    targets and callbacks."""
    bound = current_context() if ctx is None else ctx

    def wrapped(*args, **kwargs):
        with use_context(bound):
            return fn(*args, **kwargs)

    return wrapped


def exemplars_enabled() -> bool:
    """Whether histogram exemplars are being recorded
    (``HEAT_TPU_TRACE_EXEMPLARS``, default on; meaningful only while a
    trace context is active anyway)."""
    return _EXEMPLARS


def set_exemplars(enabled: bool) -> bool:
    """Enable/disable exemplar recording at runtime; returns the
    previous state (the ``tracing_overhead`` perf gate's toggle)."""
    global _EXEMPLARS
    prev = _EXEMPLARS
    _EXEMPLARS = bool(enabled)
    return prev


def refresh_env() -> None:
    """Re-read the tracing knobs (tests that flip the env mid-process);
    resizes the retention deques, keeping the newest entries."""
    global _KEEP, _MAX_SPANS, _EXEMPLARS, _RECENT, _ERRORS
    _KEEP = int(os.environ.get("HEAT_TPU_TRACE_KEEP", "32"))
    _MAX_SPANS = int(os.environ.get("HEAT_TPU_TRACE_MAX_SPANS", "256"))
    _EXEMPLARS = _env_on("HEAT_TPU_TRACE_EXEMPLARS", True)
    with _STORE_LOCK:
        _tsan.note_access("telemetry.tracing.store")
        _RECENT = deque(_RECENT, maxlen=max(1, _KEEP))
        _ERRORS = deque(_ERRORS, maxlen=max(1, _KEEP))
        # ascending by duration: drop from the fast end down to keep
        n_drop = max(0, len(_SLOWEST) - max(1, _KEEP))
        del _SLOWEST[:n_drop]
        del _SLOWEST_DURS[:n_drop]


# ----------------------------------------------------------------------
# the tail-sampled trace store
# ----------------------------------------------------------------------
class _Trace:
    """One request's span tree while in flight and after retention.

    Two collection forms, both appended lock-free on hot paths:
    ``spans`` holds full :class:`SpanRecord`\\ s (from ``span()`` /
    ``record_span``), ``batches`` holds *raw note batches* —
    ``(thread_id, depth, parent_id, notes)`` tuples handed over by
    ``flush_notes`` — that are materialized into records only when a
    view asks (``/tracez``, digests, crash bundles).  A co-batched
    request's trace shares the SAME batch tuple as the primary
    (zero-copy mirroring); materialization stamps each consumer's own
    trace_id.  ``n_spans`` tracks the combined count for the span cap."""

    __slots__ = (
        "trace_id", "route", "start_ts", "start_pc",
        "duration_ms", "status", "spans", "batches", "n_spans",
        "dropped", "seq",
    )

    def __init__(self, trace_id: str, route: str):
        self.trace_id = trace_id
        self.route = route
        self.start_ts = time.time()
        self.start_pc = time.perf_counter()
        self.duration_ms: Optional[float] = None
        self.status = "active"
        self.spans: List[Any] = []
        self.batches: List[tuple] = []
        self.n_spans = 0
        self.dropped = 0
        self.seq = next(_TRACE_SEQ)


#: in-flight traces + the three retention classes; every structure below
#: is only touched under the registered store lock
_STORE_LOCK = _tsan.register_lock("telemetry.tracing.store")
_ACTIVE: Dict[str, _Trace] = {}
_RECENT: "deque[_Trace]" = deque(maxlen=max(1, _KEEP))
#: slowest-k kept sorted ascending by duration; index 0 is the eviction
#: candidate (the *fastest* of the retained slow set).  _SLOWEST_DURS
#: mirrors the durations so the per-request insertion bisects a plain
#: float list instead of rebuilding one from the trace objects
_SLOWEST: List[_Trace] = []
_SLOWEST_DURS: List[float] = []
_ERRORS: "deque[_Trace]" = deque(maxlen=max(1, _KEEP))

_TRACES_C = _metrics.counter(
    "tracing.traces", "request traces finished through the tail store"
)
_SHED_ERR_C = _metrics.counter(
    "tracing.traces_shed_or_error", "finished traces retained as shed/errored"
)
_SPAN_DROP_C = _metrics.counter(
    "tracing.spans_dropped", "spans dropped by the per-trace span cap"
)


def _on_span(rec) -> None:
    """Collect one completed SpanRecord into its in-flight trace (called
    by the span tracer only when ``rec.trace_id`` is set).

    Deliberately lock-free: this sits on the serving hot path once per
    stamped span, from every traced thread at once.  The ``_ACTIVE``
    dict is only *read* here (``dict.get`` is atomic under the GIL, and
    the begin/finish mutations hold the store lock), and each trace's
    ``spans`` list is a per-trace leaf structure appended with the
    GIL-atomic ``list.append`` — the same leaf-structure carve-out the
    per-metric value locks use (LOCK_REGISTRY notes).  The span cap is
    enforced approximately under a race (bounded overshoot of at most
    one record per concurrent thread); a record landing just as its
    trace finishes is either retained with it or dropped — both fine."""
    tr = _ACTIVE.get(rec.trace_id)
    if tr is None:
        return
    if tr.n_spans < _MAX_SPANS:
        tr.spans.append(rec)
        tr.n_spans += 1
    else:
        tr.dropped += 1
        _SPAN_DROP_C.inc()


def _on_notes(trace_id: str, batch: tuple) -> None:
    """Hand one raw note batch (``(thread_id, depth, parent_id,
    notes)``) to an in-flight trace: a single lock-free append covers
    every stage in the batch — record materialization is deferred to
    view time, off the request path entirely."""
    tr = _ACTIVE.get(trace_id)
    if tr is None:
        return
    n = len(batch[3])
    if tr.n_spans + n <= _MAX_SPANS:
        tr.batches.append(batch)
        tr.n_spans += n
    else:
        tr.dropped += n
        _SPAN_DROP_C.inc(n)


def link_batch(trace_ids: Sequence[str], batch: Optional[tuple]) -> None:
    """Mirror a flushed note batch into other in-flight traces by
    reference (zero copy) — how a co-batched request's trace acquires
    the batch-level stages the primary context recorded."""
    if not batch:
        return
    for tid in trace_ids:
        _on_notes(tid, batch)


def link_spans(trace_ids: Sequence[str], records: Sequence[Any]) -> None:
    """Attach already-materialized span records to every listed
    in-flight trace, re-stamped per trace (hot paths use
    :func:`link_batch` with a raw note batch instead)."""
    if not trace_ids or not records:
        return
    with _STORE_LOCK:
        _tsan.note_access("telemetry.tracing.store")
        for tid in trace_ids:
            tr = _ACTIVE.get(tid)
            if tr is None:
                continue
            for rec in records:
                if rec is None or rec.trace_id == tid:
                    continue  # the primary trace got it via _on_span
                if tr.n_spans < _MAX_SPANS:
                    tr.spans.append(rec._replace(trace_id=tid))
                    tr.n_spans += 1
                else:
                    tr.dropped += 1
                    _SPAN_DROP_C.inc()


def _begin(trace_id: str, route: str) -> _Trace:
    tr = _Trace(trace_id, route)
    with _STORE_LOCK:
        _tsan.note_access("telemetry.tracing.store")
        _ACTIVE[trace_id] = tr
    return tr


def _finish(tr: _Trace, status: str, duration_ms: float) -> None:
    tr.status = status
    tr.duration_ms = duration_ms
    keep = max(1, _KEEP)
    with _STORE_LOCK:
        _tsan.note_access("telemetry.tracing.store")
        _ACTIVE.pop(tr.trace_id, None)
        _RECENT.append(tr)
        # slowest-k: insert sorted by duration, evict the fastest
        ix = bisect.bisect_left(_SLOWEST_DURS, duration_ms)
        _SLOWEST.insert(ix, tr)
        _SLOWEST_DURS.insert(ix, duration_ms)
        if len(_SLOWEST) > keep:
            _SLOWEST.pop(0)
            _SLOWEST_DURS.pop(0)
        if status != "ok":
            _ERRORS.append(tr)
    _TRACES_C.inc()
    if status != "ok":
        _SHED_ERR_C.inc()


def reset_store() -> None:
    """Drop every retained and in-flight trace (tests, ``reset_all``)."""
    with _STORE_LOCK:
        _tsan.note_access("telemetry.tracing.store")
        _ACTIVE.clear()
        _RECENT.clear()
        _SLOWEST.clear()
        _SLOWEST_DURS.clear()
        _ERRORS.clear()


# ----------------------------------------------------------------------
# the request root: one trace per request
# ----------------------------------------------------------------------
class request_span:
    """Open (or join) a request trace for the enclosed block.

    The serving layer's entry points wrap each request in one of these::

        with tracing.request_span("/v1/predict/km") as req:
            ...admission, coalesce, dispatch...
        latency_ms = req.duration_ms        # the ONE timing source

    * outermost use creates a fresh ``trace_id``, registers the trace as
      in-flight in the tail store, opens a ``serve.request`` root span,
      and — on exit — finishes the trace with a status derived from the
      exception (`ok`; :class:`OverloadedError` → ``shed``; anything
      else → ``error``), so shed and errored requests are *always*
      retained;
    * nested use (an HTTP handler calling the Python API) joins the
      active trace with a child span instead of starting a second trace;
    * with tracing disabled the block is still *timed* — callers keep
      one timing source — but nothing is recorded anywhere.

    ``duration_ms`` and ``trace_id`` stay readable after exit."""

    __slots__ = ("route", "attrs", "trace_id", "duration_ms", "status",
                 "_t0", "_trace", "_token", "_root", "_sid", "_depth")

    def __init__(self, route: str, trace_id: Optional[str] = None, **attrs):
        self.route = route
        self.attrs = attrs
        self.trace_id = trace_id
        self.duration_ms: Optional[float] = None
        self.status: Optional[str] = None
        self._trace: Optional[_Trace] = None
        self._token = None
        self._root = None

    def __enter__(self) -> "request_span":
        from . import spans as _spans  # lazy: spans imports this module

        self._t0 = time.perf_counter_ns()
        if not _spans.tracing_enabled():
            self.trace_id = None
            return self
        existing = _CTX.get()
        if existing is not None:
            # nested: join the active trace with a child span only
            self.trace_id = existing.trace_id
            self._root = _spans.span("serve.request", route=self.route, **self.attrs)
            self._root.__enter__()
            return self
        if self.trace_id is None:
            self.trace_id = new_trace_id()
        self._trace = _begin(self.trace_id, self.route)
        # the root span is synthesized at exit (one ring append instead
        # of the full span protocol — the serving hot path pays this per
        # request); the context carries its id so children parent to it
        self._sid = next_span_id()
        self._token = _CTX.set(TraceContext(self.trace_id, self._sid))
        tls = _spans._TLS
        self._depth = getattr(tls, "depth", 0)
        tls.depth = self._depth + 1
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        dur_ns = time.perf_counter_ns() - self._t0
        self.duration_ms = dur_ns / 1e6
        if exc_type is None:
            self.status = "ok"
        elif any(c.__name__ == "OverloadedError" for c in exc_type.__mro__):
            self.status = "shed"
        else:
            self.status = "error"
        if self._root is not None:  # joined a pre-existing trace
            self._root.__exit__(exc_type, exc, tb)
            return False
        if self._token is None:  # disabled mode: timing only
            return False
        from . import spans as _spans

        rec = _spans.SpanRecord(
            "serve.request", self._t0, dur_ns, threading.get_ident(),
            self._depth, dict(self.attrs, route=self.route),
            self.trace_id, self._sid, 0,
        )
        # caller-side stage notes + the root land in ONE ring acquisition
        _spans.flush_notes(extra=rec)
        _on_span(rec)
        _spans._TLS.depth = self._depth
        _CTX.reset(self._token)
        self._token = None
        if self._trace is not None:
            _finish(self._trace, self.status, self.duration_ms)
            self._trace = None
        return False


# ----------------------------------------------------------------------
# views: /tracez, cross-worker digests, crash bundles
# ----------------------------------------------------------------------
def _span_doc(rec) -> Dict[str, Any]:
    return {
        "name": rec.name,
        "start_ns": rec.start_ns,
        "duration_ms": round(rec.duration_ns / 1e6, 6),
        "thread_id": rec.thread_id,
        "depth": rec.depth,
        "span_id": rec.span_id,
        "parent_id": rec.parent_id,
        "attrs": {k: str(v) for k, v in rec.attrs.items()},
    }


def _materialize(tr: _Trace) -> List[Any]:
    """One record list for a trace: the collected SpanRecords plus the
    raw note batches materialized NOW (view time), each note stamped
    with THIS trace's id — the deferred half of the hot-path design."""
    from . import spans as _spans

    recs = list(tr.spans)
    for ident, depth, parent, notes in tr.batches:
        for name, t0, dur, attrs in notes:
            recs.append(
                _spans.SpanRecord(
                    name, int(t0), int(dur), ident, depth, attrs,
                    tr.trace_id, None, parent,
                )
            )
    return recs


def _stage_breakdown(tr: _Trace) -> Dict[str, Dict[str, float]]:
    out: Dict[str, Dict[str, float]] = {}

    def add(name: str, dur_ns: int) -> None:
        d = out.get(name)
        ms = dur_ns / 1e6
        if d is None:
            out[name] = {"count": 1, "total_ms": round(ms, 6)}
        else:
            d["count"] += 1
            d["total_ms"] = round(d["total_ms"] + ms, 6)

    for rec in tr.spans:
        add(rec.name, rec.duration_ns)
    for _ident, _depth, _parent, notes in tr.batches:
        for name, _t0, dur, _attrs in notes:
            add(name, dur)
    return dict(sorted(out.items()))


def _digest(tr: _Trace) -> Dict[str, Any]:
    threads = {r.thread_id for r in tr.spans} | {b[0] for b in tr.batches}
    return {
        "trace_id": tr.trace_id,
        "route": tr.route,
        "status": tr.status,
        "start_ts": tr.start_ts,
        "duration_ms": round(tr.duration_ms, 3) if tr.duration_ms is not None else None,
        "n_spans": tr.n_spans,
        "n_threads": len(threads),
        "dropped_spans": tr.dropped,
        "stages": _stage_breakdown(tr),
    }


def _full_doc(tr: _Trace) -> Dict[str, Any]:
    doc = _digest(tr)
    doc["spans"] = [
        _span_doc(r) for r in sorted(_materialize(tr), key=lambda r: r.start_ns)
    ]
    return doc


def note_records() -> List[Any]:
    """Materialized records of every retained + in-flight trace's note
    batches (NOT the full-span records — those live in the ring).  The
    Chrome export merges these so stage spans draw even though the hot
    path never wrote them to the ring; a batch mirrored into several
    co-batched traces materializes once per trace, each under its own
    trace_id."""
    active, recent, slowest, errors = _store_view()
    seen: Dict[str, _Trace] = {}
    for tr in active + list(recent) + slowest + list(errors):
        seen.setdefault(tr.trace_id, tr)
    out: List[Any] = []
    for tid in sorted(seen):
        tr = seen[tid]
        recs = _materialize(tr)
        out.extend(recs[len(tr.spans):])  # note-batch records only
    return out


def _store_view():
    with _STORE_LOCK:
        _tsan.note_access("telemetry.tracing.store", write=False)
        return (
            list(_ACTIVE.values()),
            list(_RECENT),
            list(reversed(_SLOWEST)),  # slowest first
            list(_ERRORS),
        )


def get_trace(trace_id: str) -> Optional[Dict[str, Any]]:
    """Full span tree of one retained or in-flight trace (None when the
    store never saw it or has evicted it everywhere)."""
    active, recent, slowest, errors = _store_view()
    for tr in active + list(recent) + slowest + list(errors):
        if tr.trace_id == trace_id:
            return _full_doc(tr)
    return None


def retained_traces() -> Dict[str, List[Dict[str, Any]]]:
    """The tail store's current contents as digests:
    ``{"active", "recent", "slowest", "errors"}`` (newest last in
    ``recent``/``errors``, slowest first in ``slowest``)."""
    active, recent, slowest, errors = _store_view()
    return {
        "active": [_digest(t) for t in active],
        "recent": [_digest(t) for t in recent],
        "slowest": [_digest(t) for t in slowest],
        "errors": [_digest(t) for t in errors],
    }


def trace_digest() -> List[Dict[str, Any]]:
    """Compact digests of every retained + in-flight trace, deduplicated
    by trace_id — the form that travels in a cross-worker snapshot so
    a cross-worker merge of snapshots can stitch one
    request across processes."""
    active, recent, slowest, errors = _store_view()
    seen: Dict[str, _Trace] = {}
    for tr in active + list(recent) + slowest + list(errors):
        seen.setdefault(tr.trace_id, tr)
    return [_digest(seen[tid]) for tid in sorted(seen)]


def traces_snapshot(max_spans: int = 2000) -> Dict[str, Any]:
    """The store as one JSON-safe document for crash bundles: in-flight
    traces with FULL span trees (what the process was serving when it
    died), retained classes as digests; ``max_spans`` bounds the bundle
    size."""
    active, recent, slowest, errors = _store_view()
    budget = max_spans

    def full_or_digest(tr: _Trace) -> Dict[str, Any]:
        nonlocal budget
        if budget - tr.n_spans >= 0:
            budget -= tr.n_spans
            return _full_doc(tr)
        return _digest(tr)

    return {
        "keep": _KEEP,
        "active": [full_or_digest(t) for t in active],
        "recent": [_digest(t) for t in recent],
        "slowest": [_digest(t) for t in slowest],
        "errors": [full_or_digest(t) for t in errors],
    }


def tracez_report() -> Dict[str, Any]:
    """The ``/tracez`` payload: retained traces grouped per route with a
    stage-breakdown digest each, plus the in-flight set."""
    active, recent, slowest, errors = _store_view()
    routes: Dict[str, Dict[str, Any]] = {}

    def bucket(name: str, traces: Sequence[_Trace]):
        for tr in traces:
            r = routes.setdefault(
                tr.route,
                {"recent": [], "slowest": [], "errors": [], "count": 0, "error_count": 0},
            )
            r[name].append(_digest(tr))

    bucket("recent", recent)
    bucket("slowest", slowest)
    bucket("errors", errors)
    for r in routes.values():
        r["count"] = len(r["recent"])
        r["error_count"] = len(r["errors"])
    return {
        "timestamp": time.time(),
        "keep": _KEEP,
        "max_spans_per_trace": _MAX_SPANS,
        "active": [_digest(t) for t in active],
        "routes": dict(sorted(routes.items())),
    }


#: the stage columns the /tracez HTML table shows, in pipeline order
_TRACEZ_STAGES = (
    "serve.admission",
    "serve.coalesce_wait",
    "serve.pad",
    "serve.dispatch",
    "serve.execute",
    "serve.scatter",
)


def render_tracez_html() -> str:
    """``/tracez`` as a small dependency-free HTML page: per route, the
    recent / slowest / shed+errored traces with a per-stage latency
    table (the columns are the serving pipeline's stages, in order)."""
    import html as _html

    rep = tracez_report()
    # EVERY user-influenced string (model/route names arrive verbatim
    # from request bodies; tenant/status/attrs ride along) goes through
    # html.escape — quote=True included, since several land inside
    # attribute values.  A hand-rolled &/</> replacement is not enough.
    esc = lambda s: _html.escape(str(s), quote=True)
    head = (
        "<!doctype html><html><head><title>heat_tpu_torch /tracez</title><style>"
        "body{font-family:monospace;margin:1.5em}table{border-collapse:collapse;margin:.5em 0 1.5em}"
        "td,th{border:1px solid #999;padding:2px 8px;text-align:right}"
        "th{background:#eee}td.l,th.l{text-align:left}"
        ".shed{background:#ffe9c6}.error{background:#ffd6d6}</style></head><body>"
    )
    parts = [head, "<h1>/tracez — tail-sampled request traces</h1>"]
    parts.append(
        f"<p>keep={rep['keep']} per class · max {rep['max_spans_per_trace']} spans/trace · "
        f"{len(rep['active'])} in flight · generated {time.strftime('%H:%M:%S')}</p>"
    )

    def table(title: str, digests: List[Dict[str, Any]]) -> None:
        if not digests:
            return
        parts.append(f"<h3>{esc(title)}</h3><table><tr><th class=l>trace_id</th>"
                     "<th>status</th><th>total ms</th><th>spans</th><th>threads</th>")
        for st in _TRACEZ_STAGES:
            parts.append(f"<th>{esc(st.split('.', 1)[1])} ms</th>")
        parts.append("</tr>")
        for d in digests:
            cls = d["status"] if d["status"] in ("shed", "error") else ""
            parts.append(
                f'<tr class="{esc(cls)}"><td class=l>{esc(d["trace_id"])}</td>'
                f'<td>{esc(d["status"])}</td><td>{esc(d["duration_ms"])}</td>'
                f'<td>{esc(d["n_spans"])}</td><td>{esc(d["n_threads"])}</td>'
            )
            for st in _TRACEZ_STAGES:
                cell = d["stages"].get(st)
                parts.append(f"<td>{esc(cell['total_ms']) if cell else '·'}</td>")
            parts.append("</tr>")
        parts.append("</table>")

    table("in flight", rep["active"])
    for route, r in rep["routes"].items():
        parts.append(f"<h2>{esc(route)}</h2>")
        table("slowest", r["slowest"])
        table("shed / errored", r["errors"])
        table("recent", list(reversed(r["recent"])))
    if not rep["routes"] and not rep["active"]:
        parts.append("<p>(no traces retained yet — issue a traced request)</p>")
    parts.append("<p>JSON form: <a href='/tracez?format=json'>/tracez?format=json</a> · "
                 "span ring Chrome trace: <a href='/trace'>/trace</a></p></body></html>")
    return "".join(parts)
