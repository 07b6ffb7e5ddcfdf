"""Process-global metrics registry: counters, gauges, bounded histograms
(counterpart of heat_tpu/telemetry/metrics.py).

The single home for every named metric of the process:

* :class:`Counter` -- monotonically increasing int/float totals
  (``fault.faults_injected``, ``retry.retries``, ``spans.recorded``).
* :class:`Gauge` -- last-written values or live callbacks.
* :class:`Histogram` -- bounded geometric-bucket distributions: p50/p90/
  p99 estimates without storing samples (fixed ~12%-wide log-spaced
  buckets; memory is O(buckets touched), never O(observations)).
* :class:`Info` -- constant identity labels (``build_info``).

One :func:`snapshot` / :func:`reset` / :func:`dump_json` /
:func:`expose` surface covers them all.  Names, bucket ladder and
exposition text are the reference's, so a dashboard or scraper written
for one package reads the other: the same calls give the same
``expose()`` text.

All operations are thread-safe (per-metric locks).  The registry-level
name->metric map is guarded by a lock registered in
``analysis/concurrency.py LOCK_REGISTRY`` (``telemetry.metrics.registry``)
-- under ``HEAT_TPU_TSAN=1`` the concurrency sanitizer verifies every
cross-thread access holds it; the per-metric value locks stay
unregistered leaf locks (they guard one scalar each and are never held
across another acquire).
"""

from __future__ import annotations

import bisect
import json
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

from ..analysis import tsan as _tsan

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "Info",
    "MetricsRegistry",
    "REGISTRY",
    "counter",
    "gauge",
    "histogram",
    "info",
    "register_dump_section",
    "snapshot",
    "reset",
    "dump_json",
    "expose",
]

#: extra named sections embedded in the ``HEAT_TPU_METRICS_DUMP``
#: atexit JSON beside the metrics snapshot: name -> zero-arg provider.
#: Registered at import time on the main thread, read only at dump
#: time; a provider failure drops its section, never the dump.
_DUMP_SECTIONS: "Dict[str, Callable[[], Any]]" = {}


def register_dump_section(name: str, provider: Callable[[], Any]) -> None:
    """Attach a named section to every metrics dump (last wins)."""
    _DUMP_SECTIONS[str(name)] = provider

Number = Union[int, float]


def _escape_label(v: str) -> str:
    """OpenMetrics label-value escaping: backslash, double-quote, newline."""
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")

#: histogram bucket upper bounds: 10**(e/20) for e in [-120, 240] — a
#: geometric ladder from 1e-6 to 1e12 in ~12% steps.  Quantile estimates
#: interpolate inside one bucket, so the worst-case relative error of a
#: reported p50/p90/p99 is half a bucket (~6%) — plenty for wall-time
#: distributions, at a fixed worst-case memory of 361 ints.
_BOUNDS: List[float] = [10.0 ** (e / 20.0) for e in range(-120, 241)]


class Counter:
    """Monotonic named total (int or float increments)."""

    __slots__ = ("name", "doc", "_value", "_lock")

    def __init__(self, name: str, doc: str = ""):
        self.name = name
        self.doc = doc
        self._value: Number = 0
        self._lock = threading.Lock()

    def inc(self, n: Number = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> Number:
        with self._lock:
            return self._value

    def reset(self) -> None:
        with self._lock:
            self._value = 0


class Gauge:
    """Last-written value, or a live callback evaluated at read time."""

    __slots__ = ("name", "doc", "fn", "_value", "_lock")

    def __init__(self, name: str, doc: str = "", fn: Optional[Callable[[], Number]] = None):
        self.name = name
        self.doc = doc
        self.fn = fn
        self._value: Number = 0.0
        self._lock = threading.Lock()

    def set(self, v: Number) -> None:
        with self._lock:
            self._value = v

    @property
    def value(self) -> Number:
        if self.fn is not None:
            try:
                return self.fn()
            except Exception:
                return 0.0
        with self._lock:
            return self._value

    def reset(self) -> None:
        with self._lock:
            self._value = 0.0


class Histogram:
    """Bounded distribution: geometric buckets, exact count/sum/min/max.

    ``observe(v)`` is O(log buckets); quantiles come from a cumulative
    walk over the (sparse) bucket counts with geometric interpolation
    inside the crossing bucket, clamped to the exact observed [min, max].
    Non-positive observations land in a dedicated low bucket valued at
    the observed minimum (durations are the intended payload; zeros
    happen on sub-resolution clocks).

    ``observe(v, exemplar=trace_id)`` additionally makes the bucket ``v``
    lands in remember that trace id (most recent wins) — an OpenMetrics
    **exemplar**, the link from an aggregate latency bucket back to one
    concrete request retained in the tail-sampled trace store.  Exemplars
    cost one dict write per exemplared observation and nothing
    otherwise; :func:`MetricsRegistry.expose` renders histograms that
    carry them in OpenMetrics bucket syntax."""

    __slots__ = ("name", "doc", "_buckets", "_low", "_count", "_sum", "_min",
                 "_max", "_exemplars", "_lock")

    def __init__(self, name: str, doc: str = ""):
        self.name = name
        self.doc = doc
        self._buckets: Dict[int, int] = {}
        self._low = 0  # observations <= 0 (or under the first bound)
        self._count = 0
        self._sum = 0.0
        self._min = float("inf")
        self._max = float("-inf")
        # bucket index (-1 = low bucket) -> (value, trace_id, unix_ts)
        self._exemplars: Dict[int, Tuple[float, str, float]] = {}
        self._lock = threading.Lock()

    def observe(self, v: Number, exemplar: Optional[str] = None) -> None:
        v = float(v)
        with self._lock:
            self._count += 1
            self._sum += v
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v
            if v <= _BOUNDS[0]:
                ix = -1
                self._low += 1
            else:
                ix = bisect.bisect_left(_BOUNDS, v)
                self._buckets[ix] = self._buckets.get(ix, 0) + 1
            if exemplar is not None:
                self._exemplars[ix] = (v, str(exemplar), time.time())

    def exemplars(self) -> Dict[float, Dict[str, Any]]:
        """Per-bucket exemplars keyed by the bucket's upper bound:
        ``{le: {"value", "trace_id", "ts"}}`` (empty when none were
        recorded)."""
        with self._lock:
            items = dict(self._exemplars)
        return {
            (_BOUNDS[0] if ix < 0 else _BOUNDS[ix]): {
                "value": val, "trace_id": tid, "ts": ts
            }
            for ix, (val, tid, ts) in sorted(items.items())
        }

    def bucket_counts(self) -> Tuple[int, Dict[int, int], int, float]:
        """Cumulative bucket state ``(low, buckets, count, sum)`` under
        one lock acquisition (the sample a windowed burn-rate monitor
        diffs between ticks).  ``buckets`` maps ladder index -> count; ``low`` counts
        observations at or under the first bound."""
        with self._lock:
            return (self._low, dict(self._buckets), self._count, self._sum)

    def _bucket_rows(self) -> List[Tuple[float, int, Optional[Tuple[float, str, float]]]]:
        """Cumulative ``(le, count, exemplar)`` rows over the touched
        buckets (the OpenMetrics exposition shape)."""
        with self._lock:
            buckets = dict(self._buckets)
            low = self._low
            ex = dict(self._exemplars)
        rows: List[Tuple[float, int, Optional[Tuple[float, str, float]]]] = []
        cum = 0
        if low:
            cum += low
            rows.append((_BOUNDS[0], cum, ex.get(-1)))
        for ix in sorted(buckets):
            cum += buckets[ix]
            rows.append((_BOUNDS[ix], cum, ex.get(ix)))
        return rows

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    @property
    def min(self) -> Optional[float]:
        with self._lock:
            return self._min if self._count else None

    @property
    def max(self) -> Optional[float]:
        with self._lock:
            return self._max if self._count else None

    def quantile(self, q: float) -> Optional[float]:
        """Estimated q-quantile (q in [0, 1]); None when empty.

        The extremes are exact, not bucket estimates: q=0 returns the
        observed minimum and q=1 the observed maximum (the interpolated
        walk would otherwise report a bucket midpoint below the true
        max whenever the top bucket is wide, an edge a windowed monitor
        must not inherit)."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        with self._lock:
            if not self._count:
                return None
            if q == 0.0:
                return self._min
            if q == 1.0:
                return self._max
            target = q * self._count
            seen = self._low
            if seen >= target:
                return self._min
            val = self._max
            for ix in sorted(self._buckets):
                seen += self._buckets[ix]
                if seen >= target:
                    lo = _BOUNDS[ix - 1] if ix > 0 else _BOUNDS[0]
                    hi = _BOUNDS[ix]
                    val = (lo * hi) ** 0.5  # geometric bucket midpoint
                    break
            return min(max(val, self._min), self._max)

    def snapshot(self) -> Dict[str, Any]:
        doc = {
            "count": self.count,
            "sum": round(self.sum, 6),
            "min": self.min,
            "max": self.max,
            "p50": self.quantile(0.5),
            "p90": self.quantile(0.9),
            "p99": self.quantile(0.99),
        }
        ex = self.exemplars()
        if ex:
            doc["exemplars"] = {f"{le:g}": rec for le, rec in ex.items()}
        return doc

    def reset(self) -> None:
        with self._lock:
            self._buckets.clear()
            self._low = 0
            self._count = 0
            self._sum = 0.0
            self._min = float("inf")
            self._max = float("-inf")
            self._exemplars.clear()


class Info:
    """Constant build/runtime identity: the OpenMetrics *info* pattern.

    A metric whose payload is its **labels** (version strings, backend,
    device kind) with a constant sample value of 1 — ``build_info`` in
    the exposition joins any scraped series to the binary that produced
    it.  Labels come from a zero-arg provider resolved **lazily on first
    read and cached**: ``build_info`` asks torch for the card's name,
    and resolving that at registration time would initialize CUDA as an
    import side effect.  :meth:`reset` keeps the cache — identity is
    not a counter."""

    __slots__ = ("name", "doc", "fn", "_labels", "_lock")

    def __init__(self, name: str, doc: str = "",
                 fn: Optional[Callable[[], Dict[str, str]]] = None):
        self.name = name
        self.doc = doc
        self.fn = fn
        self._labels: Optional[Dict[str, str]] = None
        self._lock = threading.Lock()

    def labels(self) -> Dict[str, str]:
        with self._lock:
            if self._labels is None:
                resolved: Dict[str, str] = {}
                if self.fn is not None:
                    try:
                        resolved = {
                            str(k): str(v) for k, v in (self.fn() or {}).items()
                        }
                    except Exception:
                        resolved = {}
                self._labels = resolved
            return dict(self._labels)

    @property
    def value(self) -> int:
        return 1

    def reset(self) -> None:
        pass  # identity is constant; nothing to zero


class MetricsRegistry:
    """Name -> metric map with one snapshot/reset/export surface.

    Dotted names form domains (``fault.sites_evaluated``,
    ``retry.retries``); :meth:`reset` takes a prefix so a domain's reset
    function can clear exactly its own metrics."""

    def __init__(self):
        self._metrics: "Dict[str, Union[Counter, Gauge, Histogram]]" = {}
        # re-entrant: a sanitizer finding inside a locked section reports
        # through a telemetry counter, which re-enters this registry
        self._lock = _tsan.register_lock(
            "telemetry.metrics.registry", threading.RLock()
        )

    def _get_or_make(self, name: str, cls, **kwargs):
        with self._lock:
            _tsan.note_access("telemetry.metrics.registry")
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, **kwargs)
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {type(m).__name__}, "
                    f"not {cls.__name__}"
                )
            return m

    def counter(self, name: str, doc: str = "") -> Counter:
        return self._get_or_make(name, Counter, doc=doc)

    def gauge(self, name: str, doc: str = "", fn: Optional[Callable[[], Number]] = None) -> Gauge:
        g = self._get_or_make(name, Gauge, doc=doc)
        if fn is not None:
            g.fn = fn
        return g

    def histogram(self, name: str, doc: str = "") -> Histogram:
        return self._get_or_make(name, Histogram, doc=doc)

    def info(self, name: str, doc: str = "",
             fn: Optional[Callable[[], Dict[str, str]]] = None) -> Info:
        m = self._get_or_make(name, Info, doc=doc)
        if fn is not None and m.fn is None:
            m.fn = fn
        return m

    def get(self, name: str):
        with self._lock:
            _tsan.note_access("telemetry.metrics.registry", write=False)
            return self._metrics.get(name)

    def names(self) -> List[str]:
        with self._lock:
            _tsan.note_access("telemetry.metrics.registry", write=False)
            return sorted(self._metrics)

    def snapshot(self, include_zero: bool = True) -> Dict[str, Any]:
        """One document of every metric's current value.

        Counters/gauges report their numeric value; histograms report a
        ``{count, sum, min, max, p50, p90, p99}`` sub-document.
        ``include_zero=False`` drops zero counters and empty histograms
        (compact per-config embedding for bench artifacts)."""
        with self._lock:
            _tsan.note_access("telemetry.metrics.registry", write=False)
            items = sorted(self._metrics.items())
        out: Dict[str, Any] = {}
        for name, m in items:
            if isinstance(m, Histogram):
                if not include_zero and m.count == 0:
                    continue
                out[name] = m.snapshot()
            elif isinstance(m, Info):
                out[name] = m.labels()
            else:
                v = m.value
                if not include_zero and not v:
                    continue
                out[name] = v
        return out

    def reset(self, prefix: Optional[str] = None) -> None:
        """Zero every metric (or only names under ``prefix``).  Callback
        gauges are left alone — their value is derived live."""
        with self._lock:
            _tsan.note_access("telemetry.metrics.registry", write=False)
            items = list(self._metrics.items())
        for name, m in items:
            if prefix is not None and not name.startswith(prefix):
                continue
            if isinstance(m, Gauge) and m.fn is not None:
                continue
            m.reset()

    def dump_json(self, path: str) -> None:
        """Write the full snapshot as JSON through the resilience atomic
        writer (write-temp-fsync-rename + CRC32 sidecar) — the artifact
        the ``HEAT_TPU_METRICS_DUMP`` atexit hook produces for CI
        scraping.  A crash mid-dump can never leave a truncated file,
        and a reader can verify the payload against the sidecar."""
        # lazy import: resilience.faults imports this module at its top
        from ..resilience.atomic import atomic_write

        doc = {"timestamp": time.time(), "pid": os.getpid(), "metrics": self.snapshot()}
        for name, provider in _DUMP_SECTIONS.items():
            try:
                doc[name] = provider()
            except Exception:
                doc[name] = None
        with atomic_write(path) as tmp:
            with open(tmp, "w") as f:
                json.dump(doc, f, indent=1, default=str)

    def expose(self) -> str:
        """Prometheus text exposition of every metric.

        Counters/gauges emit one sample; histograms emit a summary
        (quantile-labeled samples plus ``_sum``/``_count``) — except
        histograms carrying **exemplars**, which emit OpenMetrics
        histogram syntax instead (cumulative ``_bucket{le=...}`` samples
        over the touched buckets, each annotated
        ``# {trace_id="..."} value timestamp`` with the most recent
        trace that landed in it), so a scraper can jump from a latency
        bucket straight to the retained trace.  Metric names are
        sanitized to the Prometheus charset with the reference's
        ``heat_tpu_`` namespace prefix (one dashboard reads both
        packages).

        The payload ends with the OpenMetrics ``# EOF`` terminator:
        exemplar syntax is OpenMetrics, not Prometheus-text 0.0.4, and a
        spec-compliant scraper treats a payload without the terminator
        as torn."""
        lines: List[str] = []
        with self._lock:
            _tsan.note_access("telemetry.metrics.registry", write=False)
            items = sorted(self._metrics.items())
        for name, m in items:
            pname = "heat_tpu_" + "".join(
                c if (c.isalnum() or c == "_") else "_" for c in name
            )
            if isinstance(m, Info):
                # the OpenMetrics info pattern: identity in the labels,
                # constant sample value 1
                lines.append(f"# TYPE {pname} gauge")
                labels = ",".join(
                    f'{k}="{_escape_label(v)}"'
                    for k, v in sorted(m.labels().items())
                )
                lines.append(f"{pname}{{{labels}}} 1" if labels else f"{pname} 1")
            elif isinstance(m, Counter):
                lines.append(f"# TYPE {pname} counter")
                lines.append(f"{pname} {m.value}")
            elif isinstance(m, Gauge):
                lines.append(f"# TYPE {pname} gauge")
                lines.append(f"{pname} {m.value}")
            elif m.exemplars():
                lines.append(f"# TYPE {pname} histogram")
                rows = m._bucket_rows()
                for le, cum, ex in rows:
                    sample = f'{pname}_bucket{{le="{le:g}"}} {cum}'
                    if ex is not None:
                        val, tid, ts = ex
                        sample += f' # {{trace_id="{tid}"}} {val:g} {ts:.3f}'
                    lines.append(sample)
                lines.append(f'{pname}_bucket{{le="+Inf"}} {m.count}')
                lines.append(f"{pname}_sum {m.sum}")
                lines.append(f"{pname}_count {m.count}")
            else:
                lines.append(f"# TYPE {pname} summary")
                for q in (0.5, 0.9, 0.99):
                    v = m.quantile(q)
                    if v is not None:
                        lines.append(f'{pname}{{quantile="{q}"}} {v}')
                lines.append(f"{pname}_sum {m.sum}")
                lines.append(f"{pname}_count {m.count}")
        lines.append("# EOF")
        return "\n".join(lines) + "\n"


#: the process-global registry every subsystem registers into
REGISTRY = MetricsRegistry()


def counter(name: str, doc: str = "") -> Counter:
    """Get-or-create a counter in the global registry."""
    return REGISTRY.counter(name, doc)


def gauge(name: str, doc: str = "", fn: Optional[Callable[[], Number]] = None) -> Gauge:
    """Get-or-create a gauge (optionally callback-backed) in the global registry."""
    return REGISTRY.gauge(name, doc, fn)


def histogram(name: str, doc: str = "") -> Histogram:
    """Get-or-create a bounded histogram in the global registry."""
    return REGISTRY.histogram(name, doc)


def info(name: str, doc: str = "",
         fn: Optional[Callable[[], Dict[str, str]]] = None) -> Info:
    """Get-or-create an info metric (lazy labeled identity) in the
    global registry."""
    return REGISTRY.info(name, doc, fn)


def snapshot(include_zero: bool = True) -> Dict[str, Any]:
    """Snapshot of every registered metric (see :meth:`MetricsRegistry.snapshot`)."""
    return REGISTRY.snapshot(include_zero)


def reset(prefix: Optional[str] = None) -> None:
    """Zero every registered metric, or only names under ``prefix``."""
    REGISTRY.reset(prefix)


def dump_json(path: str) -> None:
    """Write the global registry's snapshot as JSON."""
    REGISTRY.dump_json(path)


def expose() -> str:
    """Prometheus text exposition of the global registry."""
    return REGISTRY.expose()
