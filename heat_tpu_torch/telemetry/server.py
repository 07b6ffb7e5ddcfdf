"""Runtime-introspection HTTP endpoint: watch a live fit from a browser.

A stdlib-only (``http.server``) daemon-thread endpoint serving the
telemetry layer's state over HTTP (counterpart of
heat_tpu/telemetry/server.py) — the scrape target of Prometheus-based
serving observability, and the liveness probe an elastic resume needs
before any reshape decision:

========  ============================================================
route     payload
========  ============================================================
/metrics  Prometheus text exposition (:func:`metrics.expose`)
/varz     full registry snapshot as JSON (:func:`metrics.snapshot`)
/healthz  liveness: fit-heartbeat age + last checkpoint step; HTTP 503
          when the heartbeat is stale (``HEAT_TPU_HEALTH_MAX_AGE_S``)
/readyz   readiness: should a router send this process traffic?  503
          with a ``state`` field ("warming"/"draining") while the
          serving layer is pre-warming or draining — liveness and
          readiness are distinct verdicts (:func:`set_readiness`)
/trace    Chrome trace-event JSON of the span ring (load the response
          body in chrome://tracing or https://ui.perfetto.dev) — spans
          carrying a request trace_id draw as connected flow arrows
/tracez   tail-sampled request traces per route (recent / slowest /
          shed+errored) with a per-stage latency table; HTML by
          default, ``?format=json`` for the machine form, and
          ``?trace_id=<id>`` for one trace's full span tree
/sloz     SLO burn-rate monitors: every registered objective's fast/
          slow-window burn verdict plus the active alert table; HTML
          by default, ``?format=json`` for the machine form
/driftz   input-drift sketches: per served model, the live-vs-baseline
          PSI score and per-feature breakdown; HTML by default,
          ``?format=json`` for the machine form
/canaryz  canary decision plane: per served model, the shadow-traffic
          evidence window (rows compared, mismatch rate, latency ratio),
          the verdict + veto reasons, and the retained comparison/
          decision event timeline with exemplar trace_ids; HTML by
          default, ``?format=json`` for the machine form
/rooflinez  kernel roofline observatory: per-executable measured time
          joined with cost-accounting FLOPs/bytes — achieved GFLOP/s,
          GB/s, intensity and bound-class vs the device peaks, plus the
          live HBM watermark; HTML by default, ``?format=json``
/tenantz  per-tenant cost accounts (QoS scheduling): rows, analyzed
          FLOPs/bytes and device-ms per serving tenant, pro-rata split
          of every coalesced batch, summing to the process total; HTML
          by default, ``?format=json`` for the machine form
/profilez on-demand bounded ``torch.profiler`` capture: POST
          ``/profilez/start[?duration_s=]`` / ``/profilez/stop``
          (single in-flight, 409 on conflict), GET lists completed
          captures with downloadable artifacts
/decisionz  control-plane decision journal: every autonomous action
          (autoscaler, canary, refresh driver, preemption, circuit
          breakers, reshape, reshard, alert transitions) as a typed
          event with actor/action/evidence and cause links; HTML
          timeline by default, ``?format=json`` for the machine form,
          ``?event_id=<id>`` for the causal-chain explain view
/queryz   embedded metric history: range queries over the in-process
          TSDB ring buffers (``?series=<name>&window=<seconds>``) —
          the very samples journal evidence references; HTML by
          default, ``?format=json`` for the machine form
/statusz  build/runtime info: every registered env knob's effective
          value, dispatch cache keys + hit rate + per-executable cost
          accounting, torch/CUDA/device/version info, active alerts
========  ============================================================

Other subsystems mount additional routes on this same server through
:func:`register_route` (the serving layer's ``/v1/models`` /
``/v1/predict`` / per-model ``/healthz`` endpoints do) — one process,
one port, however many route owners; ``close()`` stays idempotent and
routes survive a server stop/start cycle.

Off by default.  ``HEAT_TPU_HTTP_PORT=<port>`` starts the server when
``heat_tpu_torch.telemetry`` is imported; :func:`start_server` starts it
programmatically (``port=0`` binds an ephemeral port — the test
harness's path).  The server runs on a daemon thread and every handler
only *reads* telemetry state, so it can never block or corrupt a fit;
request logging is routed to nowhere (a scraper polling /metrics every
few seconds must not spam stderr).
"""

from __future__ import annotations

import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional, Tuple

from ..core import _env
from ..analysis import tsan as _tsan
from . import alerts as _alerts
from . import journal as _journal
from . import metrics as _metrics
from . import observatory as _observatory
from . import sketch as _sketch
from . import slo as _slo
from . import spans as _spans
from . import tracing as _tracing
from . import tsdb as _tsdb

#: /metrics content type: the payload carries OpenMetrics exemplar
#: syntax and the ``# EOF`` terminator, so it must be declared as
#: OpenMetrics — a Prometheus-text 0.0.4 label on exemplar'd buckets is
#: a spec violation scrapers reject (exposition hygiene, PR 14)
OPENMETRICS_CONTENT_TYPE = "application/openmetrics-text; version=1.0.0; charset=utf-8"

#: the declarative route registry: one row per HTTP route a process can
#: serve, the single source the docs generator renders the endpoint
#: index from (``scripts/build_api_docs.py`` — the hand-maintained
#: table in docs/observability.md drifted silently as routes grew).
#: PURE LITERAL, like KNOBS and LOCK_REGISTRY: ``owner`` is the module
#: that serves the route ("server" = this introspection endpoint;
#: the fleet router and the serving layer mount/serve the rest);
#: ``html`` marks routes whose default rendering takes ``?format=json``.
BUILTIN_ROUTES = (
    {"route": "/metrics", "owner": "server", "html": False,
     "purpose": "OpenMetrics exposition of the whole registry (exemplar'd histograms, `# EOF`-terminated, `application/openmetrics-text`)",
     "knobs": ("HEAT_TPU_TRACE_EXEMPLARS",)},
    {"route": "/varz", "owner": "server", "html": False,
     "purpose": "full registry snapshot as JSON",
     "knobs": ()},
    {"route": "/healthz", "owner": "server", "html": False,
     "purpose": "liveness: fit-heartbeat age + last durable checkpoint step; 503 when stale",
     "knobs": ("HEAT_TPU_HEALTH_MAX_AGE_S",)},
    {"route": "/readyz", "owner": "server", "html": False,
     "purpose": "readiness: should a router send traffic (warming/ready/draining state machine)",
     "knobs": ()},
    {"route": "/trace", "owner": "server", "html": False,
     "purpose": "Chrome trace-event JSON of the span ring (perfetto-loadable)",
     "knobs": ("HEAT_TPU_TRACE", "HEAT_TPU_TRACE_RING")},
    {"route": "/tracez", "owner": "server", "html": True,
     "purpose": "tail-sampled request traces per route; `?trace_id=` for one span tree",
     "knobs": ("HEAT_TPU_TRACE_KEEP", "HEAT_TPU_TRACE_MAX_SPANS")},
    {"route": "/statusz", "owner": "server", "html": False,
     "purpose": "every knob's effective value, dispatch cache + cost accounting, analysis + observatory + elastic sections, runtime/build info",
     "knobs": ()},
    {"route": "/sloz", "owner": "server", "html": True,
     "purpose": "SLO burn-rate monitors + active alert table",
     "knobs": ("HEAT_TPU_SLO_*", "HEAT_TPU_ALERT_RING")},
    {"route": "/driftz", "owner": "server", "html": True,
     "purpose": "per-model input-drift PSI vs baseline",
     "knobs": ("HEAT_TPU_SKETCH", "HEAT_TPU_DRIFT_*")},
    {"route": "/canaryz", "owner": "server", "html": True,
     "purpose": "canary decision plane: per-model shadow evidence window (rows compared, mismatch rate, latency ratio), verdict + veto reasons, retained comparison/decision events with exemplar trace_ids",
     "knobs": ("HEAT_TPU_SHADOW_*", "HEAT_TPU_CANARY_*")},
    {"route": "/rooflinez", "owner": "server", "html": True,
     "purpose": "kernel roofline observatory: per-executable measured GFLOP/s, GB/s, intensity, bound-class + HBM watermark",
     "knobs": ("HEAT_TPU_OBSERVATORY", "HEAT_TPU_PERF_SYNC_EVERY",
               "HEAT_TPU_PEAK_*", "HEAT_TPU_HBM_*")},
    {"route": "/profilez", "owner": "server", "html": True,
     "purpose": "on-demand bounded `torch.profiler` capture: `POST /profilez/start` / `/stop`, artifact download",
     "knobs": ("HEAT_TPU_PROFILE_DIR", "HEAT_TPU_PROFILE_MAX_S")},
    {"route": "/tenantz", "owner": "server", "html": True,
     "purpose": "per-tenant cost accounts: analyzed FLOPs/bytes + device-ms per tenant, pro-rata by rows over coalesced batches; accounts sum to the derived total (the fleet router serves the same route merged across replicas)",
     "knobs": ("HEAT_TPU_QOS_METER",)},
    {"route": "/decisionz", "owner": "server", "html": True,
     "purpose": "control-plane decision journal: every autonomous action (autoscaler, canary, refresh, preemption, circuit breakers, reshape, reshard, alerts) with actor/action/evidence; `?event_id=` walks the causal chain",
     "knobs": ("HEAT_TPU_JOURNAL_DIR", "HEAT_TPU_JOURNAL_RING")},
    {"route": "/queryz", "owner": "server", "html": True,
     "purpose": "embedded metric history: range queries over the in-process TSDB rings (`?series=<name>&window=<seconds>`); the samples journal evidence cites",
     "knobs": ("HEAT_TPU_TSDB_INTERVAL_S", "HEAT_TPU_TSDB_RETENTION",
               "HEAT_TPU_TSDB_SERIES")},
    {"route": "/fleetz", "owner": "fleet.router", "html": True,
     "purpose": "*(router)* fleet-wide per-kernel utilization + watermark rollup (slowest replica per key highlighted) + per-model canary verdicts across replicas (divergent replicas highlighted) + the merged tenant-account table + the interleaved cross-replica decision timeline",
     "knobs": ("HEAT_TPU_FLEET_HEALTH_PERIOD_S",)},
    {"route": "/v1/*", "owner": "serving.service", "html": False,
     "purpose": "serving: `/v1/models`, `POST /v1/predict`, per-model `/v1/models/<name>/healthz`",
     "knobs": ("HEAT_TPU_SERVE_*",)},
)

__all__ = [
    "BUILTIN_ROUTES",
    "IntrospectionServer",
    "clear_readiness",
    "health_report",
    "maybe_start_from_env",
    "readiness_report",
    "register_route",
    "registered_routes",
    "request_headers",
    "server_running",
    "set_readiness",
    "start_server",
    "statusz_report",
    "stop_server",
    "unregister_route",
]

#: the process's single running server (one port is plenty; tests stop
#: and restart on fresh ephemeral ports).  The registered lock guards
#: only the handle swap — the (blocking) socket close/join runs outside
#: it, so a wedged in-flight request can never wedge every later
#: start_server() behind a held module lock
_SERVER: Optional["IntrospectionServer"] = None
_LOCK = _tsan.register_lock("telemetry.server")

#: extra HTTP routes registered by other subsystems (the serving layer's
#: /v1/ endpoints): path prefix -> handler.  One process, one server,
#: many route owners — a subsystem that needs HTTP extends THIS endpoint
#: instead of binding a second socket.  Guarded by the same registered
#: lock as the server handle; handler threads take it only for the
#: (cheap) prefix lookup and call the handler outside it.
_ROUTES: Dict[str, Any] = {}


def register_route(prefix: str, handler) -> None:
    """Mount ``handler`` under ``prefix`` on the process's introspection
    server (running or future — routes survive server restarts).

    ``handler(method, path, body) -> (status, content_type, body_str)``
    — or a 4-tuple with an extra ``{header: value}`` dict.  ``method``
    is ``"GET"``/``"POST"``, ``path`` the full request path, ``body``
    the raw request bytes (None for GET).  The longest registered
    prefix wins; built-in routes (/metrics, /healthz, ...) cannot be
    shadowed.  A handler exception becomes a 500 on that request only.
    """
    if not prefix.startswith("/"):
        raise ValueError(f"route prefix must start with '/', got {prefix!r}")
    with _LOCK:
        _tsan.note_access("telemetry.server.routes")
        _ROUTES[prefix] = handler


def unregister_route(prefix: str) -> None:
    """Unmount a registered route prefix (no-op when absent)."""
    with _LOCK:
        _tsan.note_access("telemetry.server.routes")
        _ROUTES.pop(prefix, None)


def registered_routes() -> list:
    """The mounted route prefixes, longest first."""
    with _LOCK:
        _tsan.note_access("telemetry.server.routes", write=False)
        return sorted(_ROUTES, key=len, reverse=True)


#: ambient request headers for mounted route handlers.  The
#: ``register_route`` handler signature is (method, path, body) — too
#: narrow for header-carried request metadata (the QoS deadline header)
#: and widening it would break every mounted owner — so the server
#: parks the current request's headers in a thread-local around the
#: dispatch instead (one handler thread serves one request at a time).
_REQ_TLS = threading.local()


def request_headers() -> Dict[str, str]:
    """Headers of the HTTP request currently being dispatched to a
    mounted route handler, lowercase-keyed ({} outside a dispatch —
    direct calls into a service bypass HTTP and carry no headers)."""
    return getattr(_REQ_TLS, "headers", None) or {}


#: readiness provider the /readyz route consults: ``() -> (ready, doc)``.
#: Liveness (/healthz: is the process making progress) and readiness
#: (/readyz: should a router send this process traffic) are distinct
#: verdicts — a replica that is pre-warming its executable cache or
#: draining for shutdown is perfectly *live* but must not receive new
#: requests.  The serving layer installs its provider when the /v1
#: routes mount; without one the process reports ready ("idle": up, no
#: serving state to gate on).
_READINESS = None


def set_readiness(provider) -> None:
    """Install the process's readiness provider (``() -> (ready: bool,
    doc: dict)``); the doc must carry a ``state`` string ("warming" /
    "ready" / "draining" / ...).  One provider per process — the last
    installer wins (one serving surface per replica)."""
    global _READINESS
    with _LOCK:
        _tsan.note_access("telemetry.server.readiness")
        _READINESS = provider


def clear_readiness(provider=None) -> None:
    """Remove the readiness provider (``provider`` given: only if it is
    the installed one — a closed service must not clobber its
    successor's provider)."""
    global _READINESS
    with _LOCK:
        _tsan.note_access("telemetry.server.readiness")
        # equality, not identity: a bound method like ``svc.readiness``
        # is a fresh object on every attribute access
        if provider is None or _READINESS == provider:
            _READINESS = None


def readiness_report() -> Tuple[bool, Dict[str, Any]]:
    """``(ready, doc)`` from the installed provider, or the idle
    default.  A provider exception reports not-ready ("error") rather
    than raising — a broken readiness hook must read as unroutable, not
    crash the scrape."""
    with _LOCK:
        _tsan.note_access("telemetry.server.readiness", write=False)
        provider = _READINESS
    if provider is None:
        return True, {"ready": True, "state": "idle", "timestamp": time.time()}
    try:
        ready, doc = provider()
    except Exception as e:  # a readiness-hook bug must read as not-ready, never kill the scrape
        return False, {
            "ready": False,
            "state": "error",
            "error": f"{type(e).__name__}: {e}",
            "timestamp": time.time(),
        }
    doc = dict(doc)
    doc.setdefault("ready", bool(ready))
    doc.setdefault("timestamp", time.time())
    return bool(ready), doc


def _route_for(path: str):
    """The handler owning ``path`` (longest-prefix match), or None."""
    with _LOCK:
        _tsan.note_access("telemetry.server.routes", write=False)
        best = None
        for prefix, handler in _ROUTES.items():
            if path.startswith(prefix) and (best is None or len(prefix) > len(best[0])):
                best = (prefix, handler)
    return best[1] if best is not None else None


# ----------------------------------------------------------------------
# reports (plain functions, so tests and the flight recorder can use the
# same payloads without going through a socket)
# ----------------------------------------------------------------------
def health_report() -> Tuple[bool, Dict[str, Any]]:
    """``(healthy, doc)`` liveness derived from telemetry state.

    * ``fit.heartbeat_ts`` — unix time of the last ``resumable_fit_loop``
      chunk boundary (0.0 until a resumable fit runs);
    * ``checkpoint.last_step`` / ``checkpoint.last_step_ts`` — the most
      recent durable checkpoint commit;
    * ``HEAT_TPU_HEALTH_MAX_AGE_S`` — with a positive value, a process
      whose last heartbeat is older than this is UNHEALTHY (a hung
      device program, a dead worker); 0 (the default) disables the
      staleness verdict so idle/non-fit processes stay green.
    """
    env = _env
    now = time.time()
    hb_ts = float(_metrics.gauge("fit.heartbeat_ts").value or 0.0)
    ck_ts = float(_metrics.gauge("checkpoint.last_step_ts").value or 0.0)
    max_age = env.env_float("HEAT_TPU_HEALTH_MAX_AGE_S")
    heartbeat_age = (now - hb_ts) if hb_ts > 0.0 else None
    doc: Dict[str, Any] = {
        "status": "ok",
        "timestamp": now,
        "heartbeat_age_s": round(heartbeat_age, 3) if heartbeat_age is not None else None,
        "max_age_s": max_age,
        "fit": {
            "iter_rate": _metrics.gauge("fit.iter_rate").value,
            "shift": _metrics.gauge("fit.shift").value,
        },
        "checkpoint": {
            "last_step": int(_metrics.gauge("checkpoint.last_step").value)
            if ck_ts > 0.0
            else None,
            "age_s": round(now - ck_ts, 3) if ck_ts > 0.0 else None,
        },
    }
    healthy = True
    if hb_ts == 0.0:
        doc["status"] = "idle"  # no resumable fit has run; nothing to judge
    elif max_age > 0.0 and heartbeat_age is not None and heartbeat_age > max_age:
        healthy = False
        doc["status"] = "stale"
    return healthy, doc


def statusz_report() -> Dict[str, Any]:
    """Env-knob registry values, dispatch cache + cost accounting, and
    torch/CUDA/device/version info — the "what exactly is this process
    running" page."""
    env = _env
    knobs: Dict[str, Any] = {}
    for name in sorted(env.KNOBS):
        typ, default, _doc = env.KNOBS[name]
        raw = os.environ.get(name)
        knobs[name] = {
            "type": typ,
            "value": raw if raw is not None else default,
            "set": raw is not None,
        }
    doc: Dict[str, Any] = {
        "timestamp": time.time(),
        "pid": os.getpid(),
        "knobs": knobs,
        "runtime": _runtime_info(),
    }
    try:
        from ..core import dispatch

        from ..core import aot_cache

        stats = dispatch.cache_stats()
        doc["dispatch"] = {
            "hit_rate": stats["hit_rate"],
            "cache_size": stats["cache_size"],
            "compile_fallbacks": stats["compile_fallbacks"],
            "cache_keys": dispatch.cache_keys(),
            "cost": dispatch.cost_summary(),
            "aot": aot_cache.stats(),
        }
    except Exception:  # introspection page degrades, never breaks the process
        doc["dispatch"] = None
    try:
        from ..elastic.supervisor import elastic_state

        doc["elastic"] = elastic_state()
    except Exception:  # introspection page degrades, never breaks the process
        doc["elastic"] = None
    try:
        from ..analysis import diagnostics as _adiag
        from ..analysis import memory_model as _amem

        doc["analysis"] = {
            "mode": _adiag.analysis_mode(),
            "recent_diagnostics": [
                {"rule": d.rule, "location": d.location, "message": d.message}
                for d in _adiag.recent_diagnostics()[-20:]
            ],
            "hbm": _amem.peak_summary(),
        }
    except Exception:  # introspection page degrades, never breaks the process
        doc["analysis"] = None
    try:
        # compact embed: never calibrates or runs device work from a scrape
        doc["observatory"] = _observatory.snapshot(calibrate=False, max_rows=20)
    except Exception:  # introspection page degrades, never breaks the process
        doc["observatory"] = None
    try:
        doc["alerts"] = {
            "active": _alerts.active_alerts(),
            "recent_events": _alerts.alert_events(limit=10),
            "slos_registered": _slo.registered_slos(),
            "drift": _sketch.SKETCHES.digest(),
        }
    except Exception:  # introspection page degrades, never breaks the process
        doc["alerts"] = None
    try:
        # only when the serving layer is already resident: a fit-only
        # process's /statusz scrape must not import the serving stack
        import sys as _sys

        cmod = _sys.modules.get("heat_tpu_torch.serving.canary")
        doc["canary"] = cmod.canary_snapshot() if cmod is not None else None
    except Exception:  # introspection page degrades, never breaks the process
        doc["canary"] = None
    return doc


def _runtime_info() -> Dict[str, Any]:
    import platform

    info: Dict[str, Any] = {
        "python": platform.python_version(),
        "platform": platform.platform(),
    }
    try:
        import torch
        import torch.distributed as dist

        on_card = torch.cuda.is_available()
        joined = dist.is_available() and dist.is_initialized()
        info.update(
            torch=torch.__version__,
            cuda=torch.version.cuda,
            backend="cuda" if on_card else "cpu",
            device_count=torch.cuda.device_count() if on_card else 1,
            device_kind=torch.cuda.get_device_name(0) if on_card else "cpu",
            process_index=dist.get_rank() if joined else 0,
            process_count=dist.get_world_size() if joined else 1,
        )
    except Exception:  # introspection must work before/without a card
        info["torch"] = None
    try:
        from .. import version

        info["heat_tpu_torch"] = version.__version__
    except Exception:  # version probe is decorative
        pass
    # the identity satellites every scrape surface shares: which binary
    # produced these numbers, and since when
    try:
        binfo = _metrics.REGISTRY.get("build_info")
        info["build_info"] = binfo.labels() if binfo is not None else None
        start = _metrics.REGISTRY.get("process.start_ts")
        info["process_start_ts"] = start.value if start is not None else None
    except Exception:  # identity probe is decorative
        pass
    return info


class _IdleCanary:
    """``/canaryz`` of a process with no serving layer: the serving
    layer's own document for a process that serves no model (no
    canary observed, no shadow traffic, no events)."""

    _SHADOW = ("offered", "sampled", "sampled_rows", "dropped", "comparisons",
               "errors", "promotions", "rollbacks")

    @staticmethod
    def canaryz_report() -> Dict[str, Any]:
        return {"timestamp": time.time(), "shadow": {k: 0 for k in _IdleCanary._SHADOW},
                "models": {}, "events": []}

    @staticmethod
    def render_canaryz_html() -> str:
        return (
            "<html><head><title>/canaryz</title><style>"
            "table{border-collapse:collapse}td,th{border:1px solid #999;"
            "padding:3px 6px;font:12px monospace}</style></head><body>"
            "<h1>/canaryz — canary decision plane</h1>"
            "<p>shadow lane: 0 of 0 batches mirrored (0 rows), 0 dropped at the "
            "bounded queue, 0 comparisons, 0 canary errors — 0 promoted / 0 "
            "rolled back</p>"
            "<p>no canary has been observed yet (load one with activate=False and arm "
            "HEAT_TPU_SHADOW_FRACTION)</p>"
            "<h2>retained events</h2><p>(no events retained)</p></body></html>"
        )


# ----------------------------------------------------------------------
# the server
# ----------------------------------------------------------------------
class _Handler(BaseHTTPRequestHandler):
    server_version = "heat-tpu-introspection/1"

    def log_message(self, fmt, *args):  # scrapers poll; stay silent
        pass

    def _send(self, code: int, body: str, content_type: str) -> None:
        payload = body.encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)

    def _send_json(self, doc: Any, code: int = 200) -> None:
        self._send(code, json.dumps(doc, indent=1, default=str), "application/json")

    def _query_params(self) -> Dict[str, str]:
        query = self.path.split("?", 1)[1] if "?" in self.path else ""
        return dict(kv.split("=", 1) for kv in query.split("&") if "=" in kv)

    def _dispatch_route(self, method: str, path: str, body: Optional[bytes]) -> bool:
        """Try the registered extra routes; True when one handled it."""
        handler = _route_for(path)
        if handler is None:
            return False
        _REQ_TLS.headers = {k.lower(): v for k, v in self.headers.items()}  # threading.local: each thread mutates only its own slot
        try:
            result = handler(method, path, body)
        finally:
            _REQ_TLS.headers = None  # threading.local: each thread mutates only its own slot
        status, ctype, payload = result[0], result[1], result[2]
        headers = result[3] if len(result) > 3 else None
        data = payload.encode("utf-8") if isinstance(payload, str) else payload
        self.send_response(int(status))
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        for k, v in (headers or {}).items():
            self.send_header(k, str(v))
        self.end_headers()
        self.wfile.write(data)
        return True

    def do_GET(self) -> None:  # noqa: N802 - http.server API
        path = self.path.split("?", 1)[0].rstrip("/") or "/"
        try:
            if path == "/metrics":
                self._send(200, _metrics.expose(), OPENMETRICS_CONTENT_TYPE)
            elif path == "/varz":
                self._send_json(
                    {
                        "timestamp": time.time(),
                        "pid": os.getpid(),
                        "metrics": _metrics.snapshot(),
                    }
                )
            elif path == "/healthz":
                healthy, doc = health_report()
                self._send_json(doc, 200 if healthy else 503)
            elif path == "/readyz":
                ready, doc = readiness_report()
                self._send_json(doc, 200 if ready else 503)
            elif path == "/trace":
                self._send_json(_spans.chrome_trace_doc())
            elif path == "/tracez":
                params = self._query_params()
                if "trace_id" in params:
                    doc = _tracing.get_trace(params["trace_id"])
                    if doc is None:
                        self._send_json(
                            {"error": f"trace {params['trace_id']!r} not retained"},
                            404,
                        )
                    else:
                        self._send_json(doc)
                elif params.get("format") == "json":
                    self._send_json(_tracing.tracez_report())
                else:
                    self._send(200, _tracing.render_tracez_html(), "text/html")
            elif path == "/sloz":
                if self._query_params().get("format") == "json":
                    self._send_json(_slo.slo_report())
                else:
                    self._send(200, _slo.render_sloz_html(), "text/html")
            elif path == "/driftz":
                if self._query_params().get("format") == "json":
                    self._send_json(_sketch.drift_report())
                else:
                    self._send(200, _sketch.render_driftz_html(), "text/html")
            elif path == "/canaryz":
                # lazy: the canary decision plane lives in the serving
                # layer (ROADMAP item 17b); a process without it serves
                # the document of a process that serves no model
                try:
                    from ..serving import canary as _canary
                except ImportError:
                    _canary = _IdleCanary

                if self._query_params().get("format") == "json":
                    self._send_json(_canary.canaryz_report())
                else:
                    self._send(200, _canary.render_canaryz_html(), "text/html")
            elif path == "/rooflinez":
                params = self._query_params()
                if params.get("format") == "json":
                    try:
                        limit = int(params["limit"]) if "limit" in params else None
                    except ValueError:
                        limit = None
                    self._send_json(_observatory.rooflinez_report(limit=limit))
                else:
                    self._send(200, _observatory.render_rooflinez_html(), "text/html")
            elif path == "/tenantz":
                from . import tenants as _tenants

                params = self._query_params()
                if params.get("format") == "json":
                    try:
                        limit = int(params["limit"]) if "limit" in params else None
                    except ValueError:
                        limit = None
                    self._send_json(_tenants.tenantz_report(limit=limit))
                else:
                    self._send(200, _tenants.render_tenantz_html(), "text/html")
            elif path == "/profilez":
                if self._query_params().get("format") == "json":
                    self._send_json(_observatory.capture_status())
                else:
                    self._send(200, _observatory.render_profilez_html(), "text/html")
            elif path == "/profilez/artifact":
                name = self._query_params().get("name", "")
                try:
                    p = _observatory.artifact_path(name)
                except (FileNotFoundError, PermissionError) as e:
                    self._send_json({"error": str(e)}, 404)
                else:
                    with open(p, "rb") as f:
                        data = f.read()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/octet-stream")
                    self.send_header("Content-Length", str(len(data)))
                    self.send_header(
                        "Content-Disposition",
                        f'attachment; filename="{os.path.basename(p)}"',
                    )
                    self.end_headers()
                    self.wfile.write(data)
            elif path == "/decisionz":
                params = self._query_params()
                event_id = params.get("event_id")
                if params.get("format") == "json":
                    if event_id is not None:
                        self._send_json(_journal.causal_chain(event_id))
                    else:
                        try:
                            limit = int(params["limit"]) if "limit" in params else None
                        except ValueError:
                            limit = None
                        self._send_json(_journal.decisionz_report(limit=limit))
                else:
                    self._send(
                        200, _journal.render_decisionz_html(event_id), "text/html"
                    )
            elif path == "/queryz":
                params = self._query_params()
                series = [
                    s for s in params.get("series", "").split(",") if s
                ] or None
                try:
                    window = float(params["window"]) if "window" in params else None
                except ValueError:
                    window = None
                if params.get("format") == "json":
                    self._send_json(_tsdb.queryz_report(series, window))
                else:
                    self._send(
                        200, _tsdb.render_queryz_html(series, window), "text/html"
                    )
            elif path == "/statusz":
                self._send_json(statusz_report())
            elif path == "/":
                extra = " ".join(f"{p}..." for p in registered_routes())
                self._send(
                    200,
                    "heat_tpu_torch runtime introspection: "
                    "/metrics /varz /healthz /readyz /trace /tracez /sloz /driftz "
                    "/canaryz /rooflinez /tenantz /profilez /decisionz /queryz "
                    "/statusz"
                    + (f" | mounted: {extra}" if extra else "")
                    + "\n",
                    "text/plain",
                )
            elif self._dispatch_route("GET", self.path.split("?", 1)[0], None):
                pass
            else:
                self._send(404, f"unknown route {path!r}\n", "text/plain")
        except BrokenPipeError:  # scraper hung up mid-response; its problem
            pass
        except Exception as e:  # a handler bug must 500, never kill the serving thread
            try:
                self._send(500, f"{type(e).__name__}: {e}\n", "text/plain")
            except Exception:  # socket already gone
                pass

    def do_POST(self) -> None:  # noqa: N802 - http.server API
        try:
            path = self.path.split("?", 1)[0].rstrip("/")
            if path in ("/profilez/start", "/profilez/stop"):
                try:
                    if path.endswith("start"):
                        raw = self._query_params().get("duration_s")
                        doc = _observatory.start_capture(
                            float(raw) if raw is not None else None
                        )
                    else:
                        doc = _observatory.stop_capture()
                    self._send_json(doc)
                except RuntimeError as e:
                    # single in-flight / nothing running: a state
                    # conflict, not a server error
                    self._send_json({"error": str(e)}, 409)
                except ValueError as e:
                    self._send_json({"error": str(e)}, 400)
                return
            length = int(self.headers.get("Content-Length") or 0)
            body = self.rfile.read(length) if length else b""
            if not self._dispatch_route("POST", self.path.split("?", 1)[0], body):
                self._send(404, f"no POST route for {self.path!r}\n", "text/plain")
        except BrokenPipeError:  # client hung up mid-response; its problem
            pass
        except Exception as e:  # a handler bug must 500, never kill the serving thread
            try:
                self._send(500, f"{type(e).__name__}: {e}\n", "text/plain")
            except Exception:  # socket already gone
                pass


class IntrospectionServer:
    """A running introspection endpoint: bound socket + daemon thread."""

    def __init__(self, port: int = 0, host: str = "127.0.0.1"):
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        # the bound address outlives the socket so port/url stay
        # answerable after close() (repr in logs, test assertions)
        self._address = self._httpd.server_address
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="heat-tpu-introspection",
            daemon=True,
        )
        self._thread.start()

    @property
    def port(self) -> int:
        """The bound port (the OS's pick when constructed with 0)."""
        return self._address[1]

    @property
    def url(self) -> str:
        return f"http://{self._address[0]}:{self.port}"

    def close(self) -> None:
        """Stop serving; idempotent and safe to call concurrently.

        ``shutdown()`` only stops the accept loop — an in-flight request
        keeps its already-accepted connection socket and finishes (or
        dies on a ``BrokenPipeError`` its handler already swallows), so
        a scrape racing a ``stop_server()`` can never raise into either
        side.  Called from a handler thread itself, the serve-thread
        join is skipped (a thread cannot join itself)."""
        httpd, self._httpd = self._httpd, None
        if httpd is None:
            return
        httpd.shutdown()
        httpd.server_close()
        t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=5)

    def __repr__(self) -> str:
        return f"IntrospectionServer(url={self.url!r})"


def start_server(port: Optional[int] = None) -> IntrospectionServer:
    """Start (or return the already-running) introspection server.

    ``port=None`` reads ``HEAT_TPU_HTTP_PORT``; ``port=0`` binds an
    ephemeral port (tests).  Idempotent: a second call returns the live
    server rather than binding a second socket."""
    global _SERVER
    with _LOCK:
        _tsan.note_access("telemetry.server.singleton")
        if _SERVER is not None:
            return _SERVER
        if port is None:
            port = _env.env_int("HEAT_TPU_HTTP_PORT")
        _SERVER = IntrospectionServer(port=int(port))
        return _SERVER


def stop_server() -> None:
    """Shut the running server down (no-op when none is running; safe
    to call concurrently — exactly one caller closes the socket)."""
    global _SERVER
    with _LOCK:
        _tsan.note_access("telemetry.server.singleton")
        srv, _SERVER = _SERVER, None
    if srv is not None:
        srv.close()


def server_running() -> bool:
    """Whether an introspection server is currently serving."""
    return _SERVER is not None


def maybe_start_from_env() -> Optional[IntrospectionServer]:
    """Start the server iff ``HEAT_TPU_HTTP_PORT`` is a nonzero port
    (called once at ``heat_tpu_torch.telemetry`` import; a bind failure —
    port already taken by a neighbor process — warns instead of
    breaking the import)."""
    try:
        port = int(_env.env_str("HEAT_TPU_HTTP_PORT") or "0")
    except ValueError:
        import warnings

        warnings.warn(
            f"HEAT_TPU_HTTP_PORT={_env.env_str('HEAT_TPU_HTTP_PORT')!r} is not "
            "an integer; introspection server stays off",
            RuntimeWarning,
        )
        return None
    if not port:
        return None
    try:
        return start_server(port)
    except OSError as e:
        import warnings

        warnings.warn(
            f"HEAT_TPU_HTTP_PORT={port}: introspection server failed to "
            f"bind ({e}); continuing without it",
            RuntimeWarning,
        )
        return None
