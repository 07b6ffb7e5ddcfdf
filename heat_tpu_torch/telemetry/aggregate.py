"""Cross-worker telemetry: merge per-process snapshots into one view
(counterpart of heat_tpu/telemetry/aggregate.py).

A multi-host fit runs one Python controller per host, each with its own
process-local metrics registry — so "is worker 3 slow?" cannot be
answered from any single registry.  This module makes it a queryable
number:

* :func:`tag_snapshot` stamps the local registry snapshot with
  ``process_index`` / ``process_count`` plus a per-span-name duration
  digest (:func:`span_stats` — the ``fit.chunk`` and ``comm.*`` wall
  times the skew math needs);
* :func:`write_worker_snapshot` / :func:`read_worker_snapshots` are the
  shared-filesystem transport (atomic JSON per worker — the fallback
  that always works);
* :func:`gather_snapshots` collects every worker's tagged snapshot —
  by ``torch.distributed.all_gather_object`` over the default
  communication's group when one is joined, else from per-host JSON
  files;
* :func:`merge_snapshots` folds them into ONE deterministic labeled
  view — counters summed, gauges per-worker with min/max/mean — and
  computes the skew gauges:

  - ``telemetry.straggler_score`` — relative excess of the slowest
    worker's mean ``fit.chunk`` duration over the median worker
    (``0`` = perfectly balanced; ``1`` = the slowest worker takes 2x
    the median; a dead worker with no heartbeat scores ``inf`` capped
    to ``1e9``).  The number an elastic reshape decision reads.
  - ``telemetry.chunk_spread`` — (max - min) / mean of the per-worker
    mean chunk durations.
  - ``telemetry.comm_imbalance`` — same spread over per-worker total
    ``comm.*`` span wall time (a worker waiting in collectives much
    longer than its peers is being dragged by a straggler even when
    its own compute is fine).

Merging is a pure function of the input snapshots (sorted by
``process_index``, no clocks, no RNG), so two hosts merging the same
set of snapshot files compute byte-identical views.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Sequence

from . import alerts as _alerts
from . import journal as _journal
from . import metrics as _metrics
from . import sketch as _sketch
from . import spans as _spans
from . import tracing as _tracing

__all__ = [
    "gather_snapshots",
    "merge_snapshots",
    "merge_tenant_accounts",
    "read_worker_snapshots",
    "span_stats",
    "stitch_traces",
    "straggler_score",
    "tag_snapshot",
    "write_worker_snapshot",
]

_SCORE_CAP = 1e9  # a dead worker's score: finite, JSON-safe, unmistakable


def _process_index() -> int:
    """This process's rank in the joined process group (0 without one)."""
    import torch.distributed as dist

    return int(dist.get_rank()) if dist.is_available() and dist.is_initialized() else 0


def _process_count() -> int:
    """The joined process group's size (1 without one)."""
    import torch.distributed as dist

    return int(dist.get_world_size()) if dist.is_available() and dist.is_initialized() else 1


def span_stats() -> Dict[str, Dict[str, float]]:
    """Per-span-name digest of the ring buffer: ``{name: {count,
    total_ms, mean_ms, max_ms}}`` — the fixed-size summary that travels
    in a worker snapshot instead of the raw ring."""
    out: Dict[str, Dict[str, float]] = {}
    for rec in _spans.get_spans():
        d = out.get(rec.name)
        ms = rec.duration_ns / 1e6
        if d is None:
            out[rec.name] = {"count": 1, "total_ms": ms, "max_ms": ms}
        else:
            d["count"] += 1
            d["total_ms"] += ms
            if ms > d["max_ms"]:
                d["max_ms"] = ms
    for d in out.values():
        d["mean_ms"] = d["total_ms"] / d["count"]
        d["total_ms"] = round(d["total_ms"], 6)
        d["mean_ms"] = round(d["mean_ms"], 6)
        d["max_ms"] = round(d["max_ms"], 6)
    return dict(sorted(out.items()))


def tag_snapshot() -> Dict[str, Any]:
    """The local registry snapshot tagged with this worker's identity.

    Carries, besides the metrics and the per-span-name digest, the tail
    store's compact **trace digests** (``tracing.trace_digest()``) — the
    per-worker half of cross-worker trace stitching: one global request
    fans out into per-process local work (PAPER.md L1/L5), and a merged
    view can reassemble it only if every worker ships its view of each
    ``trace_id``."""
    import time

    return {
        "process_index": _process_index(),
        "process_count": _process_count(),
        "pid": os.getpid(),
        "timestamp": time.time(),
        "metrics": _metrics.snapshot(),
        "span_stats": span_stats(),
        "traces": _tracing.trace_digest(),
        "alerts": _alerts.alerts_snapshot(),
        "drift": _sketch.SKETCHES.digest(),
        "canary": _canary_state(),
        "journal": _journal.journal_snapshot(),
    }


def _canary_state():
    """This worker's canary decision-plane snapshot, or None on a
    process that never imported the serving layer (a telemetry-only
    worker must not pull the serving stack in for a snapshot)."""
    import sys

    cmod = sys.modules.get("heat_tpu_torch.serving.canary")
    if cmod is None:
        return None
    try:
        return cmod.canary_snapshot()
    except Exception:  # snapshot section degrades, the gather must land
        return None


# ----------------------------------------------------------------------
# transport
# ----------------------------------------------------------------------
def _worker_path(directory: str, index: int) -> str:
    return os.path.join(directory, f"worker_{index:05d}.json")


def write_worker_snapshot(directory: str, snapshot: Optional[Dict] = None) -> str:
    """Write this worker's tagged snapshot into ``directory`` (atomic +
    CRC sidecar, one file per ``process_index``); returns the path."""
    from ..resilience.atomic import atomic_write

    snap = tag_snapshot() if snapshot is None else snapshot
    path = _worker_path(directory, int(snap["process_index"]))
    with atomic_write(path) as tmp:
        with open(tmp, "w") as f:
            json.dump(snap, f, indent=1, default=str)
    return path


def read_worker_snapshots(directory: str) -> List[Dict]:
    """Checksum-verified worker snapshots from ``directory``, sorted by
    ``process_index``."""
    from ..resilience.atomic import verify_checksum

    snaps = []
    if os.path.isdir(directory):
        for name in sorted(os.listdir(directory)):
            if not (name.startswith("worker_") and name.endswith(".json")):
                continue
            path = os.path.join(directory, name)
            verify_checksum(path)
            with open(path) as f:
                snaps.append(json.load(f))
    return sorted(snaps, key=lambda s: int(s.get("process_index", 0)))


def gather_snapshots(directory: Optional[str] = None) -> List[Dict]:
    """Every worker's tagged snapshot, one list on every caller.

    Transport preference: when a process group is joined and the
    default communication spans more than one rank, every rank's
    snapshot travels by one ``torch.distributed.all_gather_object`` over
    that communication's group (no shared filesystem needed; every rank
    must call); otherwise fall back to ``directory`` (each worker must
    have called :func:`write_worker_snapshot` there).  A single-process
    world returns ``[tag_snapshot()]`` directly."""
    nproc = _process_count()
    if nproc <= 1:
        return [tag_snapshot()]
    from ..parallel import comm as _comm

    c = _comm.get_comm()
    if c._joined():
        return _gather_via_comm(c)
    if directory is None:
        raise ValueError(
            "gather_snapshots on a multi-process world needs either a "
            "joined process group or a shared `directory` of "
            "write_worker_snapshot files"
        )
    write_worker_snapshot(directory)
    return read_worker_snapshots(directory)


def _gather_via_comm(c) -> List[Dict]:
    """Every rank's tagged snapshot (as its JSON text) by one
    ``all_gather_object`` over ``c``'s group, sorted by
    ``process_index``."""
    import torch.distributed as dist

    payload = json.dumps(tag_snapshot(), default=str)
    got: List[Optional[str]] = [None] * c.size
    dist.all_gather_object(got, payload, group=c.group)
    snaps = [json.loads(p) for p in got]
    return sorted(snaps, key=lambda s: int(s.get("process_index", 0)))


# ----------------------------------------------------------------------
# merge + skew
# ----------------------------------------------------------------------
def _spread(values: Sequence[float]) -> float:
    """(max - min) / mean, 0 for degenerate inputs."""
    vals = [float(v) for v in values]
    if len(vals) < 2:
        return 0.0
    mean = sum(vals) / len(vals)
    return (max(vals) - min(vals)) / mean if mean > 0 else 0.0


def straggler_score(chunk_means_ms: Sequence[float]) -> float:
    """Relative excess of the slowest worker over the median worker.

    ``(max - median) / median``: 0 when balanced, 1 when the slowest
    worker takes twice the median chunk time.  A worker reporting no
    ``fit.chunk`` spans at all (dead or hung before its first chunk)
    is treated as infinitely slow, capped to ``1e9``."""
    vals = sorted(float(v) for v in chunk_means_ms if v is not None)
    n_missing = sum(1 for v in chunk_means_ms if v is None)
    if n_missing and vals:
        return _SCORE_CAP
    if len(vals) < 2:
        return 0.0
    mid = vals[len(vals) // 2] if len(vals) % 2 else 0.5 * (
        vals[len(vals) // 2 - 1] + vals[len(vals) // 2]
    )
    if mid <= 0:
        return 0.0
    return (vals[-1] - mid) / mid


def stitch_traces(snapshots: Sequence[Dict]) -> Dict[str, Any]:
    """Reassemble request traces across workers by ``trace_id``.

    Pure and deterministic: for every trace_id any worker's snapshot
    carries, the stitched entry lists each worker's view (span count,
    duration, stage breakdown) keyed by ``process_index``, the union
    span/thread counts, the worst status (``error`` > ``shed`` > ``ok``
    > ``active``), and the max duration — one global operation's
    per-process local work folded back into one record."""
    rank = {"error": 3, "shed": 2, "ok": 1, "active": 0}
    stitched: Dict[str, Dict[str, Any]] = {}
    for s in sorted(snapshots, key=lambda s: int(s.get("process_index", 0))):
        ix = str(int(s.get("process_index", 0)))
        for d in s.get("traces") or []:
            tid = d.get("trace_id")
            if not tid:
                continue
            e = stitched.setdefault(
                tid,
                {
                    "trace_id": tid,
                    "route": d.get("route"),
                    "status": d.get("status"),
                    "workers": {},
                    "span_count": 0,
                    "thread_count": 0,
                    "duration_ms": None,
                },
            )
            e["workers"][ix] = {
                "status": d.get("status"),
                "duration_ms": d.get("duration_ms"),
                "n_spans": d.get("n_spans", 0),
                "n_threads": d.get("n_threads", 0),
                "stages": d.get("stages", {}),
            }
            if rank.get(d.get("status"), 0) > rank.get(e["status"], 0):
                e["status"] = d.get("status")
            e["span_count"] += int(d.get("n_spans", 0))
            e["thread_count"] += int(d.get("n_threads", 0))
            dur = d.get("duration_ms")
            if dur is not None and (e["duration_ms"] is None or dur > e["duration_ms"]):
                e["duration_ms"] = dur
    return dict(sorted(stitched.items()))


def _merge_drift(snaps: Sequence[Dict]) -> Dict[str, Any]:
    """Per-model drift digests folded across workers: every worker's
    score kept per model plus the fleet-worst score — a model drifting
    on ANY replica is a drifting model.  Deterministic like the rest of
    the merge (sorted keys, no clocks)."""
    models: Dict[str, Dict[str, Any]] = {}
    for s in sorted(snaps, key=lambda s: int(s.get("process_index", 0))):
        ix = str(int(s.get("process_index", 0)))
        for d in s.get("drift") or []:
            name = d.get("model")
            if not name:
                continue
            e = models.setdefault(
                name,
                {"model": name, "workers": {}, "worst_score": None,
                 "drifting": False},
            )
            e["workers"][ix] = {
                "score": d.get("score"),
                "drifting": bool(d.get("drifting")),
                "sketched_rows": d.get("sketched_rows", 0),
                "baseline": bool(d.get("baseline")),
            }
            score = d.get("score")
            if score is not None and (
                e["worst_score"] is None or score > e["worst_score"]
            ):
                e["worst_score"] = score
            e["drifting"] = e["drifting"] or bool(d.get("drifting"))
    return dict(sorted(models.items()))


def _merge_canary(snaps: Sequence[Dict]) -> Dict[str, Any]:
    """Per-model canary state folded across workers: every worker's
    verdict/version kept per model plus a ``divergent`` flag when the
    replicas disagree — two replicas judging the same canary
    differently (or shadowing different versions) is exactly the signal
    a fleet operator must see before trusting an auto-promotion.  Pure
    and deterministic like the rest of the merge."""
    models: Dict[str, Dict[str, Any]] = {}
    events: List[Dict[str, Any]] = []
    for s in sorted(snaps, key=lambda s: int(s.get("process_index", 0))):
        ix = str(int(s.get("process_index", 0)))
        c = s.get("canary") or {}
        for name in sorted(c.get("models") or {}):
            d = c["models"][name]
            e = models.setdefault(
                name,
                {"model": name, "workers": {}, "divergent": False,
                 "verdicts": [], "canary_versions": []},
            )
            e["workers"][ix] = {
                "canary_version": d.get("canary_version"),
                "verdict": d.get("verdict"),
                "rows": d.get("rows"),
                "mismatch_pct": d.get("mismatch_pct"),
                "decision": (d.get("decision") or {}).get("action"),
            }
            if d.get("verdict") not in e["verdicts"]:
                e["verdicts"].append(d.get("verdict"))
            if d.get("canary_version") not in e["canary_versions"]:
                e["canary_versions"].append(d.get("canary_version"))
        for ev in c.get("events") or []:
            events.append(dict(ev, worker=ix))
    for e in models.values():
        e["divergent"] = len(e["verdicts"]) > 1 or len(e["canary_versions"]) > 1
    events.sort(key=lambda ev: (ev.get("ts", 0.0), ev.get("worker", ""),
                                ev.get("model", "")))
    return {"models": dict(sorted(models.items())), "events": events}


def merge_tenant_accounts(reports: Sequence[Dict]) -> Dict[str, Any]:
    """Fold per-replica ``/tenantz`` reports into one fleet-wide ledger.

    Every account field is a lifetime *sum* on each replica, so the
    fleet view sums them per tenant across replicas; the fleet total is
    re-derived from the merged tenant rows, so "accounts sum to the
    fleet total" survives the rollup by construction.  Pure and
    deterministic like the rest of the merge (tenants sorted by FLOPs
    descending then name; no clocks)."""
    tenants: Dict[str, Dict[str, Any]] = {}
    sources = 0
    for rep in reports:
        if not rep:
            continue
        sources += 1
        for row in rep.get("tenants") or []:
            name = str(row.get("tenant", ""))
            e = tenants.setdefault(
                name,
                {"tenant": name, "class": row.get("class"), "requests": 0,
                 "rows": 0, "flops": 0.0, "bytes_accessed": 0.0,
                 "device_ms": 0.0, "batches": 0, "models": [],
                 "replicas": 0},
            )
            e["class"] = row.get("class", e["class"])
            e["requests"] += int(row.get("requests", 0) or 0)
            e["rows"] += int(row.get("rows", 0) or 0)
            e["flops"] += float(row.get("flops", 0.0) or 0.0)
            e["bytes_accessed"] += float(row.get("bytes_accessed", 0.0) or 0.0)
            e["device_ms"] += float(row.get("device_ms", 0.0) or 0.0)
            e["batches"] += int(row.get("batches", 0) or 0)
            e["replicas"] += 1
            for m in row.get("models") or []:
                if m not in e["models"]:
                    e["models"].append(m)
    rows = sorted(tenants.values(), key=lambda r: (-r["flops"], r["tenant"]))
    for r in rows:
        r["models"].sort()
        r["device_ms"] = round(r["device_ms"], 3)
    total = {
        "tenants": len(rows),
        "requests": sum(r["requests"] for r in rows),
        "rows": sum(r["rows"] for r in rows),
        "flops": sum(r["flops"] for r in rows),
        "bytes_accessed": sum(r["bytes_accessed"] for r in rows),
        "device_ms": round(sum(r["device_ms"] for r in rows), 3),
    }
    return {"tenants": rows, "total": total, "sources": sources}


def merge_snapshots(snapshots: Sequence[Dict], publish: bool = True) -> Dict[str, Any]:
    """Fold worker-tagged snapshots into one deterministic labeled view.

    * ``workers`` — each input's metrics keyed by ``process_index``;
    * ``merged`` — counters summed across workers; gauges and histogram
      sub-documents reported per worker plus a ``{min, max, mean}``
      digest (summing a gauge like ``fit.iter_rate`` would be a lie);
    * ``skew`` — the straggler/spread/imbalance gauges described in the
      module docstring, each also published into the local registry
      (``publish=False`` for a pure computation);
    * ``traces`` — request traces stitched across workers by trace_id
      (:func:`stitch_traces`);
    * ``alerts`` — every worker's active alerts + transition events in
      one timeline (:func:`heat_tpu_torch.telemetry.alerts.
      merge_alert_snapshots`: the same SLO firing on two replicas stays
      two rows — it IS two replicas burning budget);
    * ``drift`` — per-model drift scores per worker plus the
      fleet-worst score (:func:`_merge_drift`);
    * ``canary`` — per-model canary verdicts per worker with a
      ``divergent`` flag when replicas disagree, plus every worker's
      retained canary events in one timeline (:func:`_merge_canary`);
    * ``journal`` — every worker's retained control-plane decision
      events interleaved into one fleet timeline ordered by
      ``(ts, worker, event_id)`` (:func:`heat_tpu_torch.telemetry.journal.
      merge_journal_snapshots`) — the cross-replica half of "why did
      the canary roll back while worker 2 preempted a fit".

    Determinism: output depends only on the input snapshots; workers are
    ordered by ``process_index`` and every dict is key-sorted."""
    snaps = sorted(snapshots, key=lambda s: int(s.get("process_index", 0)))
    if not snaps:
        raise ValueError("merge_snapshots needs at least one snapshot")

    workers: Dict[str, Any] = {}
    merged_counters: Dict[str, float] = {}
    per_value: Dict[str, Dict[str, Any]] = {}
    for s in snaps:
        ix = str(int(s.get("process_index", 0)))
        workers[ix] = {
            "pid": s.get("pid"),
            "timestamp": s.get("timestamp"),
            "metrics": s.get("metrics", {}),
            "span_stats": s.get("span_stats", {}),
        }
        for name, val in (s.get("metrics") or {}).items():
            if isinstance(val, (int, float)) and not isinstance(val, bool):
                # counters AND plain gauges are numeric; summing is only
                # meaningful for counters, so both forms are kept: the
                # sum (counter semantics) and the per-worker spread
                merged_counters[name] = merged_counters.get(name, 0) + val
            per_value.setdefault(name, {})[ix] = val

    merged_values: Dict[str, Any] = {}
    for name in sorted(per_value):
        by_worker = per_value[name]
        numeric = [
            v for v in by_worker.values()
            if isinstance(v, (int, float)) and not isinstance(v, bool)
        ]
        entry: Dict[str, Any] = {"per_worker": dict(sorted(by_worker.items()))}
        if numeric:
            entry["sum"] = merged_counters.get(name, 0)
            entry["min"] = min(numeric)
            entry["max"] = max(numeric)
            entry["mean"] = sum(numeric) / len(numeric)
        merged_values[name] = entry

    # -- skew gauges ----------------------------------------------------
    chunk_means: List[Optional[float]] = []
    comm_totals: List[float] = []
    for s in snaps:
        ss = s.get("span_stats") or {}
        chunk = ss.get("fit.chunk")
        chunk_means.append(float(chunk["mean_ms"]) if chunk else None)
        comm_totals.append(
            sum(
                float(d.get("total_ms", 0.0))
                for nm, d in ss.items()
                if nm.startswith("comm.")
            )
        )
    known_chunks = [c for c in chunk_means if c is not None]
    skew = {
        "workers": len(snaps),
        "straggler_score": straggler_score(chunk_means)
        if any(c is not None for c in chunk_means)
        else 0.0,
        "chunk_spread": _spread(known_chunks),
        "comm_imbalance": _spread(comm_totals),
        "chunk_mean_ms": dict(
            sorted(
                (str(int(s.get("process_index", 0))), c)
                for s, c in zip(snaps, chunk_means)
            )
        ),
    }
    if publish:
        _metrics.gauge(
            "telemetry.straggler_score",
            "slowest worker's fit.chunk mean vs the median worker (merged view)",
        ).set(skew["straggler_score"])
        _metrics.gauge(
            "telemetry.chunk_spread",
            "(max-min)/mean of per-worker fit.chunk mean durations",
        ).set(skew["chunk_spread"])
        _metrics.gauge(
            "telemetry.comm_imbalance",
            "(max-min)/mean of per-worker total comm.* span wall time",
        ).set(skew["comm_imbalance"])
    return {
        "workers": dict(sorted(workers.items())),
        "merged": merged_values,
        "skew": skew,
        "traces": stitch_traces(snaps),
        "alerts": _alerts.merge_alert_snapshots(
            [
                (str(int(s.get("process_index", 0))), s.get("alerts") or {})
                for s in snaps
            ]
        ),
        "drift": _merge_drift(snaps),
        "canary": _merge_canary(snaps),
        "journal": _journal.merge_journal_snapshots(
            [
                (str(int(s.get("process_index", 0))), s.get("journal") or {})
                for s in snaps
            ]
        ),
    }
