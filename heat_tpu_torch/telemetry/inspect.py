"""Pretty-print a flight-recorder crash bundle
(counterpart of heat_tpu/telemetry/inspect.py).

::

    python -m heat_tpu_torch.telemetry.inspect <bundle.json> [--metrics N] [--spans N]

Verifies the bundle against its CRC32 sidecar (a torn bundle fails
loudly), then renders the post-mortem sections in reading order: the
exception and traceback, where a resume would restart, what the process
was doing (last spans), the headline metrics, the dispatch-cache /
cost-accounting state, and the knob values that were in effect.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List

__all__ = ["format_bundle", "load_bundle", "main"]


def load_bundle(path: str) -> Dict[str, Any]:
    """Checksum-verified bundle document."""
    from ..resilience.atomic import verify_checksum

    verify_checksum(path)
    with open(path) as f:
        doc = json.load(f)
    if not isinstance(doc, dict) or "schema" not in doc:
        raise ValueError(f"{path!r} is not a flight-recorder bundle")
    return doc


def _rule(title: str) -> str:
    return f"\n== {title} " + "=" * max(0, 64 - len(title))


def format_bundle(doc: Dict[str, Any], n_metrics: int = 20, n_spans: int = 15) -> str:
    """The bundle as human-readable text (pure; tests render in-memory)."""
    lines: List[str] = []
    import datetime

    ts = doc.get("timestamp")
    when = (
        datetime.datetime.fromtimestamp(ts).isoformat(sep=" ", timespec="seconds")
        if isinstance(ts, (int, float))
        else "?"
    )
    lines.append(
        f"flight-recorder bundle (schema {doc.get('schema')}) — "
        f"{doc.get('reason')} — pid {doc.get('pid')} — {when}"
    )

    exc = doc.get("exception")
    lines.append(_rule("exception"))
    if exc:
        lines.append(f"{exc.get('type')}: {exc.get('message')}")
        if exc.get("site"):
            lines.append(f"fault site: {exc['site']}")
        if exc.get("iteration") is not None:
            lines.append(f"iteration: {exc['iteration']}")
        tb = exc.get("traceback") or []
        lines.append("".join(tb).rstrip())
    else:
        lines.append("(none recorded — manual bundle)")

    ck = doc.get("checkpoint") or {}
    lines.append(_rule("checkpoint"))
    if ck.get("last_step") is not None:
        lines.append(f"last durable step: {ck['last_step']} (resume restarts here)")
    else:
        lines.append("no durable checkpoint recorded")

    el = doc.get("elastic")
    if el and (el.get("worker_losses") or el.get("reshapes") or el.get("world_size")):
        lines.append(_rule("elastic"))
        lines.append(
            f"world_size={el.get('world_size')} "
            f"worker_losses={el.get('worker_losses')} reshapes={el.get('reshapes')}"
        )

    spans = doc.get("spans") or []
    lines.append(_rule(f"last spans ({min(n_spans, len(spans))} of {len(spans)})"))
    for rec in spans[-n_spans:]:
        ms = float(rec.get("duration_ns", 0)) / 1e6
        indent = "  " * int(rec.get("depth", 0))
        attrs = rec.get("attrs") or {}
        attr_s = (
            " {" + ", ".join(f"{k}={v}" for k, v in sorted(attrs.items())) + "}"
            if attrs
            else ""
        )
        lines.append(f"{indent}{rec.get('name')}  {ms:.3f} ms{attr_s}")
    if not spans:
        lines.append("(span ring empty)")

    traces = doc.get("traces") or {}
    active = traces.get("active") or []
    t_errors = traces.get("errors") or []
    if active or t_errors:
        lines.append(_rule(
            f"request traces ({len(active)} in flight, {len(t_errors)} shed/errored retained)"
        ))
        for tr in active[:5]:
            lines.append(
                f"IN FLIGHT {tr.get('trace_id')} {tr.get('route')} — "
                f"{tr.get('n_spans')} spans on {tr.get('n_threads')} thread(s)"
            )
            for sp in (tr.get("spans") or [])[-8:]:
                lines.append(
                    f"    {sp.get('name')}  {sp.get('duration_ms')} ms"
                    + (f"  [t{sp.get('thread_id')}]" if sp.get("thread_id") else "")
                )
        for tr in t_errors[-5:]:
            lines.append(
                f"{str(tr.get('status', '?')).upper()} {tr.get('trace_id')} "
                f"{tr.get('route')} — {tr.get('duration_ms')} ms, "
                f"{tr.get('n_spans')} spans"
            )

    alerts_doc = doc.get("alerts") or {}
    a_active = alerts_doc.get("active") or []
    a_events = alerts_doc.get("events") or []
    if a_active or a_events:
        lines.append(_rule(
            f"alerts ({len(a_active)} firing, {len(a_events)} transition(s) retained)"
        ))
        for a in a_active:
            labels = ",".join(
                f"{k}={v}" for k, v in sorted((a.get("labels") or {}).items())
            )
            lines.append(
                f"FIRING [{a.get('severity')}] {a.get('name')}"
                + (f"{{{labels}}}" if labels else "")
                + f" — {a.get('message')}"
                + (f" (trace {a.get('trace_id')})" if a.get("trace_id") else "")
            )
        for e in a_events[-8:]:
            lines.append(
                f"  {str(e.get('event', '?')).upper():8s} {e.get('name')} "
                f"value={e.get('value')} threshold={e.get('threshold')}"
            )

    slo_doc = doc.get("slo") or {}
    slos = slo_doc.get("slos") or []
    if slos:
        lines.append(_rule(f"slo verdicts ({len(slos)} objective(s))"))
        for s in slos:
            state = "FIRING" if s.get("firing") else (
                "no data" if s.get("no_data") else "ok"
            )
            lines.append(
                f"{s.get('objective')}: burn fast {s.get('burn_fast')} / "
                f"slow {s.get('burn_slow')} [{state}]"
            )

    drift_doc = doc.get("drift") or {}
    d_models = drift_doc.get("models") or []
    if d_models:
        lines.append(_rule(f"input drift ({len(d_models)} sketched model(s))"))
        for m in d_models:
            score = m.get("score")
            state = "DRIFTING" if m.get("drifting") else (
                "ok" if score is not None else "no baseline"
            )
            lines.append(
                f"{m.get('model')}: PSI {score if score is not None else '—'} "
                f"over {m.get('sketched_rows')} rows [{state}]"
            )

    canary_doc = doc.get("canary") or {}
    c_models = canary_doc.get("models") or {}
    c_events = canary_doc.get("events") or []
    if c_models or c_events:
        lines.append(_rule(
            f"canary decision plane ({len(c_models)} model(s), "
            f"{len(c_events)} retained event(s))"
        ))
        for name in sorted(c_models):
            m = c_models[name]
            dec = m.get("decision") or {}
            lines.append(
                f"{name}: canary v{m.get('canary_version')} vs active "
                f"v{m.get('active_version')} [{m.get('mode')}] — "
                f"{m.get('rows')} rows, {m.get('mismatch_pct')}% mismatch, "
                f"latency {m.get('latency_ratio')}x -> "
                f"{str(m.get('verdict', '?')).upper()}"
                + (f" ({dec.get('action')})" if dec else "")
            )
            for r in dec.get("reasons") or []:
                lines.append(f"    reason: {r}")
            for v in m.get("vetoes") or []:
                lines.append(f"    veto: {v}")
            for h in (m.get("history") or [])[-5:]:
                lines.append(
                    f"    history: v{h.get('canary_version')} "
                    f"{h.get('verdict')} -> {h.get('action')} "
                    f"({h.get('rows')} rows, {h.get('mismatch_pct')}%)"
                )
        for ev in c_events[-8:]:
            lines.append(
                f"  {str(ev.get('severity', '?')).upper():5s} "
                f"[{ev.get('kind')}] {ev.get('model')}: {ev.get('message')}"
                + (f" (trace {ev.get('trace_id')})" if ev.get("trace_id") else "")
            )

    jnl = doc.get("journal") or {}
    j_events = jnl.get("events") or []
    if j_events:
        lines.append(_rule(f"decision journal ({len(j_events)} event(s) retained)"))
        for e in j_events[-12:]:
            lines.append(
                f"  {str(e.get('severity', '?')).upper():5s} "
                f"{e.get('actor')}/{e.get('action')}"
                + (f" [{e.get('model')}]" if e.get("model") else "")
                + f": {e.get('message')}"
                + (f" (cause {e.get('cause')})" if e.get("cause") else "")
                + (f" (trace {e.get('trace_id')})" if e.get("trace_id") else "")
            )

    tsdb_doc = doc.get("tsdb") or {}
    series = tsdb_doc.get("series") or {}
    if series:
        lines.append(_rule(f"metric history ({len(series)} series retained)"))
        for name in sorted(series)[:12]:
            pts = series[name] or []
            last = pts[-1][1] if pts else None
            lines.append(f"  {name}: {len(pts)} point(s), last={last}")
        if len(series) > 12:
            lines.append(f"  ... {len(series) - 12} more")

    metrics = doc.get("metrics") or {}
    nonzero = {
        k: v
        for k, v in metrics.items()
        if (isinstance(v, dict) and v.get("count")) or (not isinstance(v, dict) and v)
    }
    lines.append(_rule(f"metrics ({min(n_metrics, len(nonzero))} of {len(nonzero)} nonzero)"))
    for name in sorted(nonzero)[:n_metrics]:
        v = nonzero[name]
        if isinstance(v, dict):
            lines.append(
                f"{name}: count={v.get('count')} sum={v.get('sum')} "
                f"p50={v.get('p50')} p99={v.get('p99')}"
            )
        else:
            lines.append(f"{name}: {v}")

    disp = doc.get("dispatch")
    lines.append(_rule("dispatch"))
    if disp:
        stats = disp.get("stats") or {}
        lines.append(
            f"hit_rate={stats.get('hit_rate')} cache_size={stats.get('cache_size')} "
            f"compile_fallbacks={stats.get('compile_fallbacks')}"
        )
        cost = disp.get("cost") or {}
        if cost.get("enabled"):
            lines.append(
                f"cost accounting: flops_total={cost.get('flops_total')} "
                f"bytes_total={cost.get('bytes_total')} over {len(cost.get('per_key') or {})} executables"
            )
        keys = disp.get("cache_keys") or []
        for k in keys[:10]:
            lines.append(f"  {k}")
        if len(keys) > 10:
            lines.append(f"  ... {len(keys) - 10} more")
    else:
        lines.append("(not recorded)")

    knobs = doc.get("knobs") or {}
    set_knobs = {k: v for k, v in knobs.items() if isinstance(v, dict) and v.get("set")}
    lines.append(_rule(f"knobs ({len(set_knobs)} set, {len(knobs)} registered)"))
    for name in sorted(set_knobs):
        lines.append(f"{name}={set_knobs[name].get('value')}")
    if not set_knobs:
        lines.append("(all at registered defaults)")

    tsan_doc = doc.get("tsan") or {}
    tsan_findings = tsan_doc.get("findings") or []
    if tsan_findings:
        lines.append(_rule(f"concurrency sanitizer ({len(tsan_findings)} finding(s), mode {tsan_doc.get('mode')})"))
        for f in tsan_findings[:10]:
            lines.append(f"{f.get('rule')}: {f.get('message')}")
            for frame in (f.get("access_stack") or f.get("closing_edge", {}).get("acquire_stack") or [])[:3]:
                lines.append(f"    {frame}")
        if len(tsan_findings) > 10:
            lines.append(f"  ... {len(tsan_findings) - 10} more")

    ana = doc.get("analysis") or {}
    ana_diags = ana.get("recent_diagnostics") or []
    ana_hbm = (ana.get("hbm") or {}).get("estimates") or {}
    if ana_diags or ana_hbm:
        lines.append(_rule(
            f"program lint ({len(ana_diags)} recent diagnostic(s), "
            f"mode {ana.get('mode')})"
        ))
        for d in ana_diags[:10]:
            lines.append(f"{d.get('rule')} [{d.get('location')}]: {d.get('message')}")
        budget = (ana.get("hbm") or {}).get("budget_bytes") or 0
        if ana_hbm:
            top = sorted(
                ana_hbm.items(),
                key=lambda kv: kv[1].get("per_device_bytes", 0),
                reverse=True,
            )[:5]
            lines.append(
                "predicted peak HBM (per device"
                + (f", budget {budget:,} B" if budget else "")
                + "):"
            )
            for label, rec in top:
                lines.append(
                    f"    {rec.get('per_device_bytes', 0):>14,} B  {label}"
                )

    obs = doc.get("observatory") or {}
    obs_ledger = obs.get("ledger") or []
    if obs:
        lines.append(_rule(
            f"observatory ({len(obs_ledger)} tracked executable(s), "
            f"sync_every={obs.get('sync_every')})"
        ))
        peaks = obs.get("peaks")
        if peaks:
            lines.append(
                f"device peaks [{peaks.get('source')}]: "
                f"{float(peaks.get('flops') or 0) / 1e9:.1f} GFLOP/s · "
                f"{float(peaks.get('bytes_per_s') or 0) / 1e9:.1f} GB/s"
            )
        wm = obs.get("watermark")
        if wm:
            lines.append(
                f"watermark [{wm.get('source')}]: "
                f"{float(wm.get('bytes_in_use') or 0) / 2**20:.1f} MiB in use, "
                f"peak seen {float(wm.get('peak_seen_bytes') or 0) / 2**20:.1f} MiB, "
                f"predicted {float(wm.get('predicted_peak_bytes') or 0) / 2**20:.1f} MiB, "
                f"budget {float(wm.get('budget_bytes') or 0) / 2**20:.1f} MiB"
            )
        for r in obs_ledger[:10]:
            util = r.get("utilization")
            lines.append(
                f"  {r.get('calls'):>7} calls  {r.get('mean_ms')} ms "
                f"[{r.get('timing')}]  "
                + (
                    f"{r.get('gflops_per_s')} GFLOP/s " if r.get("gflops_per_s") else ""
                )
                + (f"{r.get('gbytes_per_s')} GB/s " if r.get("gbytes_per_s") else "")
                + f"{r.get('bound')}"
                + (f" util={util}" if util is not None else "")
                + f"  {r.get('key')}"
            )
        if len(obs_ledger) > 10:
            lines.append(f"  ... {len(obs_ledger) - 10} more")

    rt = doc.get("runtime") or {}
    lines.append(_rule("runtime"))
    # a bundle of this package names torch and CUDA, one of the JAX
    # package names jax: each renders as written
    stack = (f"jax {rt.get('jax')}" if "jax" in rt
             else f"torch {rt.get('torch')} · cuda {rt.get('cuda')}")
    lines.append(
        f"python {rt.get('python')} · {stack} · backend "
        f"{rt.get('backend')} · {rt.get('device_count')}x {rt.get('device_kind')} · "
        f"process {rt.get('process_index')}/{rt.get('process_count')}"
    )
    return "\n".join(lines) + "\n"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m heat_tpu_torch.telemetry.inspect",
        description="pretty-print a heat_tpu flight-recorder crash bundle",
    )
    ap.add_argument("bundle", help="path to a flight_*.json crash bundle")
    ap.add_argument("--metrics", type=int, default=20, help="max metrics to show")
    ap.add_argument("--spans", type=int, default=15, help="max trailing spans to show")
    args = ap.parse_args(argv)
    doc = load_bundle(args.bundle)
    sys.stdout.write(format_bundle(doc, n_metrics=args.metrics, n_spans=args.spans))
    return 0


if __name__ == "__main__":  # pragma: no cover - exercised via subprocess
    sys.exit(main())
