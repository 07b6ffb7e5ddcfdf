"""Input-drift sketches: streaming per-feature distribution monitoring
(counterpart of heat_tpu/telemetry/sketch.py).

A served model keeps predicting whatever arrives — silently, even when
the serving distribution has left the distribution it was trained on
(the failure mode no latency metric can see).  This module makes drift
a *number* with the telemetry layer's bounded-memory discipline:

* a :class:`FeatureSketch` is a streaming **moment + log-bucket
  histogram** sketch of one feature: exact count/mean/variance (batch
  Welford merge) and min/max, plus a signed geometric bucket table
  (the registry histograms' ~12% ladder, mirrored for negative values
  with a dedicated zero bucket) — O(buckets touched) memory, never
  O(observations), updated **vectorized per batch**;
* a :class:`ModelSketch` holds one FeatureSketch per input column.
  The serving layer records the true (un-padded) rows of every
  coalesced ``/v1/predict`` batch AFTER the waiting callers have been
  woken — one numpy pass per batch on the batcher thread, never on any
  caller's latency path (the PR 10 stage-note principle applied to
  data);
* a **baseline** is a frozen sketch document: captured explicitly
  (:meth:`SketchRegistry.freeze_baseline`), or persisted at
  ``save_model`` time through the Checkpointer (the model version and
  its training-distribution fingerprint travel as one atomic
  artifact) and re-attached on registry hot-load;
* the online **divergence score** compares the live sketch against
  the baseline per feature: **PSI** (population stability index) over
  the smoothed bucket distributions — the industry drift score whose
  conventional readings (<0.1 stable, 0.1-0.25 moderate, >0.25
  shifted) give ``HEAT_TPU_DRIFT_THRESHOLD`` its 0.25 default — plus
  KL(live‖baseline) and the moment deltas; the model score is the
  worst feature's PSI;
* :func:`check_drift` (called by the SLO monitor tick) fires/resolves
  a deduplicated ``drift:<model>`` alert through
  :mod:`~heat_tpu_torch.telemetry.alerts` when a scored model crosses the
  threshold.

``/driftz`` renders :func:`drift_report`; per-model ``/healthz``
carries the model's score; cross-worker snapshots ship per-model
digests.  ``HEAT_TPU_SKETCH=0`` disables recording entirely (the
``quality_signals_overhead`` perf gate's toggle).

Thread-safety: the registry's model table is only touched under the
registered ``telemetry.sketch`` lock; each ModelSketch is updated by
exactly one batcher thread and snapshotted under the same lock.
"""

from __future__ import annotations

import math
import os
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np

from ..core import _env
from ..analysis import tsan as _tsan
from . import alerts as _alerts
from . import metrics as _metrics

__all__ = [
    "FeatureSketch",
    "ModelSketch",
    "SketchRegistry",
    "SKETCHES",
    "check_drift",
    "drift_report",
    "psi",
    "kl_divergence",
    "record_batch",
    "set_enabled",
    "sketch_enabled",
]

#: positive magnitude ladder: half-decade (~3.16x) steps from 1e-6 to
#: 1e12 — deliberately COARSER than the registry histograms' ~12%
#: ladder.  PSI compares per-bucket *proportions*, and with the fine
#: ladder a realistic feature spreads a few hundred samples one or two
#: deep across dozens of buckets, so smoothing noise alone reads as
#: drift; half-decade buckets put a unit-scale feature in ~5 buckets
#: with solid occupancy (the classic ~10-bucket PSI regime) while a
#: half-decade mean shift still moves visible mass.  Signed index 0 is
#: the zero bucket, +k / -k mirror the ladder for negative values.
_BOUNDS = np.asarray([10.0 ** (e / 2.0) for e in range(-12, 25)])
_ZERO_EPS = float(_BOUNDS[0])  # |v| <= 1e-6 counts as zero

# read through the knob registry (core/_env.py)
_ENABLED = _env.env_flag("HEAT_TPU_SKETCH")
_THRESHOLD = _env.env_float("HEAT_TPU_DRIFT_THRESHOLD")
_MIN_ROWS = _env.env_int("HEAT_TPU_DRIFT_MIN_ROWS")

_BATCHES_C = _metrics.counter(
    "drift.batches_sketched", "coalesced input batches folded into drift sketches"
)
_ROWS_C = _metrics.counter("drift.rows_sketched", "input rows folded into drift sketches")

#: PSI smoothing: every union bucket gets this pseudo-count so a bucket
#: present on one side only contributes a finite, bounded term
_PSI_EPS = 0.5


def sketch_enabled() -> bool:
    """Whether input sketches are being recorded (``HEAT_TPU_SKETCH``)."""
    return _ENABLED


def set_enabled(enabled: bool) -> bool:
    """Enable/disable sketch recording at runtime; returns the previous
    state (the ``quality_signals_overhead`` perf gate's toggle)."""
    global _ENABLED
    prev = _ENABLED
    _ENABLED = bool(enabled)
    return prev


def refresh_env() -> None:
    """Re-read the sketch knobs (tests that flip the env mid-process)."""
    global _ENABLED, _THRESHOLD, _MIN_ROWS
    _ENABLED = _env.env_flag("HEAT_TPU_SKETCH")
    _THRESHOLD = _env.env_float("HEAT_TPU_DRIFT_THRESHOLD")
    _MIN_ROWS = _env.env_int("HEAT_TPU_DRIFT_MIN_ROWS")


def _bucket_indices(col: np.ndarray) -> np.ndarray:
    """Signed geometric bucket index per value: 0 for |v| <= 1e-6,
    else ``sign(v) * (searchsorted(|v|) + 1)``."""
    mag = np.abs(col)
    idx = np.searchsorted(_BOUNDS, mag, side="left") + 1
    signed = np.where(col < 0, -idx, idx)
    return np.where(mag <= _ZERO_EPS, 0, signed)


class FeatureSketch:
    """Streaming sketch of one feature: exact moments + bucket table."""

    __slots__ = ("count", "mean", "m2", "min", "max", "buckets")

    def __init__(self):
        self.count = 0
        self.mean = 0.0
        self.m2 = 0.0
        self.min = math.inf
        self.max = -math.inf
        self.buckets: Dict[int, int] = {}

    def update_batch(self, col: np.ndarray) -> None:
        """Fold one batch column in (vectorized: one Welford merge +
        one bucket-count pass per batch, not per value)."""
        col = np.asarray(col, dtype=np.float64)
        n = int(col.size)
        if n == 0:
            return
        b_mean = float(col.mean())
        b_m2 = float(((col - b_mean) ** 2).sum())
        if self.count == 0:
            self.mean, self.m2 = b_mean, b_m2
        else:
            # parallel-variance merge (Chan et al.): exact, order-free
            delta = b_mean - self.mean
            tot = self.count + n
            self.mean += delta * n / tot
            self.m2 += b_m2 + delta * delta * self.count * n / tot
        self.count += n
        self.min = min(self.min, float(col.min()))
        self.max = max(self.max, float(col.max()))
        ixs, counts = np.unique(_bucket_indices(col), return_counts=True)
        for ix, c in zip(ixs.tolist(), counts.tolist()):
            self.buckets[ix] = self.buckets.get(ix, 0) + c

    @property
    def variance(self) -> float:
        return self.m2 / self.count if self.count > 1 else 0.0

    def doc(self) -> Dict[str, Any]:
        """JSON-safe document (bucket keys stringified for transport)."""
        return {
            "count": self.count,
            "mean": self.mean,
            "m2": self.m2,
            "min": self.min if self.count else None,
            "max": self.max if self.count else None,
            "buckets": {str(k): v for k, v in sorted(self.buckets.items())},
        }

    @classmethod
    def from_doc(cls, doc: Dict[str, Any]) -> "FeatureSketch":
        s = cls()
        s.count = int(doc.get("count", 0))
        s.mean = float(doc.get("mean", 0.0))
        s.m2 = float(doc.get("m2", 0.0))
        s.min = math.inf if doc.get("min") is None else float(doc["min"])
        s.max = -math.inf if doc.get("max") is None else float(doc["max"])
        s.buckets = {int(k): int(v) for k, v in (doc.get("buckets") or {}).items()}
        return s


def psi(p_buckets: Dict[int, int], q_buckets: Dict[int, int]) -> float:
    """Population stability index between two bucket tables (symmetric;
    smoothed so one-sided buckets stay finite).  0 = identical;
    conventional reading: <0.1 stable, 0.1-0.25 moderate, >0.25 shifted."""
    keys = set(p_buckets) | set(q_buckets)
    if not keys:
        return 0.0
    k = len(keys)
    p_tot = sum(p_buckets.values()) + _PSI_EPS * k
    q_tot = sum(q_buckets.values()) + _PSI_EPS * k
    if p_tot <= 0 or q_tot <= 0:
        return 0.0
    out = 0.0
    for key in keys:
        p = (p_buckets.get(key, 0) + _PSI_EPS) / p_tot
        q = (q_buckets.get(key, 0) + _PSI_EPS) / q_tot
        out += (p - q) * math.log(p / q)
    return out


def kl_divergence(p_buckets: Dict[int, int], q_buckets: Dict[int, int]) -> float:
    """KL(p‖q) between two (smoothed) bucket tables — the asymmetric
    companion score (p = live traffic, q = baseline)."""
    keys = set(p_buckets) | set(q_buckets)
    if not keys:
        return 0.0
    k = len(keys)
    p_tot = sum(p_buckets.values()) + _PSI_EPS * k
    q_tot = sum(q_buckets.values()) + _PSI_EPS * k
    if p_tot <= 0 or q_tot <= 0:
        return 0.0
    out = 0.0
    for key in keys:
        p = (p_buckets.get(key, 0) + _PSI_EPS) / p_tot
        q = (q_buckets.get(key, 0) + _PSI_EPS) / q_tot
        out += p * math.log(p / q)
    return out


class ModelSketch:
    """One served model's input sketch: a FeatureSketch per column."""

    __slots__ = ("name", "n_features", "features", "n_batches", "updated_ts",
                 "started_ts")

    def __init__(self, name: str, n_features: int):
        self.name = name
        self.n_features = int(n_features)
        self.features = [FeatureSketch() for _ in range(self.n_features)]
        self.n_batches = 0
        self.started_ts = time.time()
        self.updated_ts = 0.0

    def update(self, rows: np.ndarray) -> None:
        rows = np.asarray(rows)
        if rows.ndim != 2 or rows.shape[1] != self.n_features:
            raise ValueError(
                f"sketch for {self.name!r} expects (n, {self.n_features}) "
                f"rows, got shape {tuple(rows.shape)}"
            )
        for j, fs in enumerate(self.features):
            fs.update_batch(rows[:, j])
        self.n_batches += 1
        self.updated_ts = time.time()

    @property
    def count(self) -> int:
        return self.features[0].count if self.features else 0

    def doc(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "n_features": self.n_features,
            "n_batches": self.n_batches,
            "count": self.count,
            "started_ts": self.started_ts,
            "updated_ts": self.updated_ts or None,
            "features": [fs.doc() for fs in self.features],
        }

    @classmethod
    def from_doc(cls, doc: Dict[str, Any]) -> "ModelSketch":
        s = cls(doc.get("name", "?"), int(doc.get("n_features", 0)))
        s.features = [FeatureSketch.from_doc(d) for d in doc.get("features") or []]
        s.n_features = len(s.features)
        s.n_batches = int(doc.get("n_batches", 0))
        s.started_ts = float(doc.get("started_ts") or 0.0)
        s.updated_ts = float(doc.get("updated_ts") or 0.0)
        return s


def divergence(live: Dict[str, Any], baseline: Dict[str, Any]) -> Dict[str, Any]:
    """Per-feature PSI/KL + moment deltas of a live sketch document
    against a baseline document; the model ``score`` is the worst
    feature's PSI.  Pure function of the two documents (cross-worker
    merges and tests call it on shipped snapshots)."""
    live_f = live.get("features") or []
    base_f = baseline.get("features") or []
    feats: List[Dict[str, Any]] = []
    score = 0.0
    for j in range(min(len(live_f), len(base_f))):
        lf, bf = live_f[j], base_f[j]
        lb = {int(k): int(v) for k, v in (lf.get("buckets") or {}).items()}
        bb = {int(k): int(v) for k, v in (bf.get("buckets") or {}).items()}
        p = psi(lb, bb)
        feats.append(
            {
                "feature": j,
                "psi": round(p, 6),
                "kl": round(kl_divergence(lb, bb), 6),
                "mean_delta": round(
                    float(lf.get("mean", 0.0)) - float(bf.get("mean", 0.0)), 6
                ),
                "live_count": int(lf.get("count", 0)),
                "baseline_count": int(bf.get("count", 0)),
            }
        )
        score = max(score, p)
    return {
        "score": round(score, 6),
        "worst_feature": max(feats, key=lambda f: f["psi"])["feature"] if feats else None,
        "features": feats,
    }


class SketchRegistry:
    """name -> (live ModelSketch, frozen baseline document)."""

    def __init__(self):
        # name -> {"live": ModelSketch|None, "baseline": doc|None}
        self._models: Dict[str, Dict[str, Any]] = {}
        self._lock = _tsan.register_lock("telemetry.sketch")

    def record(self, name: str, rows: np.ndarray) -> bool:
        """Fold one batch of true (un-padded) input rows into the
        model's live sketch; returns False when recording is disabled.
        The sketch is created lazily from the first batch's width."""
        if not _ENABLED:
            return False
        rows = np.asarray(rows)
        if rows.ndim != 2 or rows.shape[0] == 0:
            return False
        with self._lock:
            _tsan.note_access("telemetry.sketch.registry")
            entry = self._models.setdefault(name, {"live": None, "baseline": None})
            live = entry["live"]
            if live is None or live.n_features != rows.shape[1]:
                live = entry["live"] = ModelSketch(name, rows.shape[1])
            live.update(rows)
        _BATCHES_C.inc()
        _ROWS_C.inc(int(rows.shape[0]))
        return True

    def freeze_baseline(self, name: str) -> Dict[str, Any]:
        """Freeze the model's CURRENT live sketch as its baseline and
        restart the live sketch — the runtime capture path (the
        save-time path passes the returned document to ``save_model``
        so it persists with the version)."""
        with self._lock:
            _tsan.note_access("telemetry.sketch.registry")
            entry = self._models.get(name)
            if entry is None or entry["live"] is None or entry["live"].count == 0:
                raise ValueError(
                    f"no live input sketch for model {name!r} to freeze; "
                    "serve (or sketch) some traffic first"
                )
            doc = entry["live"].doc()
            entry["baseline"] = doc
            entry["live"] = ModelSketch(name, entry["live"].n_features)
        return doc

    def set_baseline(self, name: str, baseline: Optional[Dict[str, Any]]) -> None:
        """Attach a persisted baseline document (registry hot-load
        path); ``None`` detaches."""
        with self._lock:
            _tsan.note_access("telemetry.sketch.registry")
            entry = self._models.setdefault(name, {"live": None, "baseline": None})
            entry["baseline"] = dict(baseline) if baseline else None

    def baseline(self, name: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            _tsan.note_access("telemetry.sketch.registry", write=False)
            entry = self._models.get(name)
            return dict(entry["baseline"]) if entry and entry["baseline"] else None

    def reset_live(self, name: str) -> None:
        """Restart the model's live sketch (keeps the baseline)."""
        with self._lock:
            _tsan.note_access("telemetry.sketch.registry")
            entry = self._models.get(name)
            if entry is not None and entry["live"] is not None:
                entry["live"] = ModelSketch(name, entry["live"].n_features)

    def status(self, name: str) -> Dict[str, Any]:
        """One model's drift status: live sketch digest, baseline
        presence, divergence score (None without both sides)."""
        with self._lock:
            _tsan.note_access("telemetry.sketch.registry", write=False)
            entry = self._models.get(name)
            live = entry["live"].doc() if entry and entry["live"] else None
            base = entry["baseline"] if entry else None
        doc: Dict[str, Any] = {
            "model": name,
            "sketched_batches": (live or {}).get("n_batches", 0),
            "sketched_rows": (live or {}).get("count", 0),
            "n_features": (live or {}).get("n_features"),
            "baseline": base is not None,
            "baseline_rows": int(base.get("count", 0)) if base else 0,
            "score": None,
            "drifting": False,
            "warming": False,
            "threshold": _THRESHOLD,
            "min_rows": _MIN_ROWS,
        }
        if live is not None and base is not None and live["count"] > 0:
            if live["count"] < _MIN_ROWS:
                # below the small-sample floor the PSI is noise, not a
                # verdict: report "warming", never a score
                doc["warming"] = True
            else:
                div = divergence(live, base)
                doc["score"] = div["score"]
                doc["worst_feature"] = div["worst_feature"]
                doc["features"] = div["features"]
                doc["drifting"] = div["score"] > _THRESHOLD
        return doc

    def model_names(self) -> List[str]:
        with self._lock:
            _tsan.note_access("telemetry.sketch.registry", write=False)
            return sorted(self._models)

    def digest(self) -> List[Dict[str, Any]]:
        """Compact per-model digests (score + counts, no bucket tables)
        — the form that travels in cross-worker snapshots."""
        out = []
        for name in self.model_names():
            st = self.status(name)
            out.append(
                {
                    "model": name,
                    "score": st["score"],
                    "drifting": st["drifting"],
                    "sketched_rows": st["sketched_rows"],
                    "baseline": st["baseline"],
                }
            )
        return out

    def clear(self) -> None:
        """Drop every sketch and baseline (tests, ``reset_all``)."""
        with self._lock:
            _tsan.note_access("telemetry.sketch.registry")
            self._models.clear()


#: the process-global sketch registry the serving layer records into
SKETCHES = SketchRegistry()


def record_batch(name: str, rows: np.ndarray) -> bool:
    """Fold one coalesced batch's true rows into the global registry."""
    return SKETCHES.record(name, rows)


def check_drift() -> List[Dict[str, Any]]:
    """Score every model with a baseline and fire/resolve its
    deduplicated ``drift:<model>`` alert (called by the SLO monitor
    tick; tests call it directly).  Returns the status documents."""
    out = []
    for name in SKETCHES.model_names():
        st = SKETCHES.status(name)
        out.append(st)
        if st["score"] is None:
            continue
        if st["drifting"]:
            _alerts.fire(
                f"drift:{name}",
                severity="warn",
                message=(
                    f"input drift on model {name!r}: PSI {st['score']:g} > "
                    f"{st['threshold']:g} (worst feature "
                    f"{st.get('worst_feature')})"
                ),
                value=st["score"],
                threshold=st["threshold"],
                labels={"model": name},
            )
        else:
            _alerts.resolve(f"drift:{name}", labels={"model": name})
    return out


def drift_report() -> Dict[str, Any]:
    """The ``/driftz`` payload: every sketched model's status (scores,
    per-feature PSI where a baseline exists) plus the active drift
    alerts."""
    return {
        "timestamp": time.time(),
        "enabled": _ENABLED,
        "threshold": _THRESHOLD,
        "models": [SKETCHES.status(n) for n in SKETCHES.model_names()],
        "alerts": [
            a for a in _alerts.active_alerts() if a["name"].startswith("drift:")
        ],
    }


def render_driftz_html() -> str:
    """``/driftz`` as a small dependency-free HTML page: one row per
    sketched model (score vs threshold, per-feature PSI for scored
    models) plus the active drift alerts.  Model names arrive verbatim
    from request bodies, so every interpolated string goes through
    ``html.escape``."""
    import html as _html

    from .slo import _HTML_HEAD, _render_alert_table

    esc = lambda s: _html.escape(str(s), quote=True)
    rep = drift_report()
    parts = [
        _HTML_HEAD.replace("/sloz", "/driftz"),
        "<h1>/driftz — input-drift sketches</h1>",
        f"<p>sketching {'enabled' if rep['enabled'] else 'DISABLED'} · "
        f"PSI threshold {esc(rep['threshold'])} · "
        f"generated {time.strftime('%H:%M:%S')}</p>",
    ]
    if rep["models"]:
        parts.append(
            "<table><tr><th class=l>model</th><th>rows sketched</th>"
            "<th>baseline rows</th><th>PSI score</th><th>worst feature</th>"
            "<th>state</th></tr>"
        )
        for m in rep["models"]:
            state = (
                "DRIFTING" if m["drifting"]
                else ("ok" if m["score"] is not None
                      else ("no baseline" if not m["baseline"]
                            else ("warming" if m.get("warming") else "no traffic")))
            )
            cls = "firing" if m["drifting"] else ""
            parts.append(
                f'<tr class="{esc(cls)}"><td class=l>{esc(m["model"])}</td>'
                f'<td>{esc(m["sketched_rows"])}</td><td>{esc(m["baseline_rows"])}</td>'
                f'<td>{esc(m["score"] if m["score"] is not None else "·")}</td>'
                f'<td>{esc(m.get("worst_feature", "·"))}</td><td>{esc(state)}</td></tr>'
            )
        parts.append("</table>")
        for m in rep["models"]:
            if not m.get("features"):
                continue
            parts.append(f"<h3>{esc(m['model'])} — per-feature PSI</h3>"
                         "<table><tr><th>feature</th><th>PSI</th><th>KL</th>"
                         "<th>mean Δ</th></tr>")
            for f in m["features"]:
                cls = "firing" if f["psi"] > rep["threshold"] else ""
                parts.append(
                    f'<tr class="{esc(cls)}"><td>{esc(f["feature"])}</td>'
                    f'<td>{esc(f["psi"])}</td><td>{esc(f["kl"])}</td>'
                    f'<td>{esc(f["mean_delta"])}</td></tr>'
                )
            parts.append("</table>")
    else:
        parts.append("<p>(no models sketched yet — serve some traffic)</p>")
    parts.append(_render_alert_table(rep["alerts"], esc))
    parts.append("<p>JSON form: <a href='/driftz?format=json'>/driftz?format=json</a>"
                 " · SLOs: <a href='/sloz'>/sloz</a></p></body></html>")
    return "".join(parts)
