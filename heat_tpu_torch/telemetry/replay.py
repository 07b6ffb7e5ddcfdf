"""Offline incident replay: rebuild the decision timeline from disk
(counterpart of heat_tpu/telemetry/replay.py).

``python -m heat_tpu_torch.telemetry.replay <journal-dir>`` reads the durable
decision-journal segments (committed by :mod:`heat_tpu_torch.telemetry.
journal` under ``HEAT_TPU_JOURNAL_DIR``), verifies every CRC sidecar,
and reconstructs the incident timeline **after the process is gone** —
the serving replica crashed or was killed, the hot rings died with it,
and the postmortem starts from this directory alone.

    python -m heat_tpu_torch.telemetry.replay /var/log/heat_tpu/journal
    python -m heat_tpu_torch.telemetry.replay /var/log/heat_tpu/journal \
        --event-id 3f21-18c9a2b4e01-000007      # causal-chain explain
    python -m heat_tpu_torch.telemetry.replay /var/log/heat_tpu/journal --json

The default rendering is the chronological timeline with cause links
resolved inline; ``--event-id`` walks one decision's causal chain to
its root and lists its downstream effects (the offline twin of
``/decisionz?event_id=``); ``--check`` steps the timeline through the
declared control-plane protocols (:mod:`heat_tpu_torch.analysis.protocols`)
and reports every H805 conformance violation, exiting non-zero if any;
``--json`` emits the machine form.  :func:`replay_report` is the pure
core the tests drive.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List, Optional

from ..analysis import conformance as _conformance
from .journal import causal_chain, read_journal

__all__ = ["format_replay", "main", "replay_report"]


def replay_report(
    directory: str,
    event_id: Optional[str] = None,
    check: bool = False,
) -> Dict[str, Any]:
    """The machine form of a replay: the full durable timeline, per-actor
    counts, root events (no retained cause), and — when ``event_id`` is
    given — that event's causal chain and effects.  With ``check`` the
    timeline is stepped through the declared control-plane protocols and
    the violations land under ``"check"``."""
    events = read_journal(directory)
    actors: Dict[str, int] = {}
    for e in events:
        actors[e.get("actor", "?")] = actors.get(e.get("actor", "?"), 0) + 1
    ids = {e.get("event_id") for e in events}
    roots = [e for e in events if not e.get("cause") or e["cause"] not in ids]
    doc: Dict[str, Any] = {
        "dir": directory,
        "event_count": len(events),
        "actors": dict(sorted(actors.items())),
        "roots": [e.get("event_id") for e in roots],
        "events": events,
    }
    if event_id is not None:
        doc["explain"] = causal_chain(event_id, events=events)
    if check:
        annotations = _conformance.annotate(events)
        stepped = sum(1 for a in annotations.values())
        bad = [
            {"event_id": eid, "protocol": a.get("protocol"),
             "scope_key": a.get("scope_key"), "from": a.get("from"),
             "message": a.get("message")}
            for eid, a in annotations.items() if not a.get("ok")
        ]
        doc["check"] = {
            "stepped": stepped,
            "violations": bad,
            "violation_count": len(bad),
        }
    return doc


def _fmt_event(e: Dict[str, Any], indent: str = "") -> str:
    ev = ", ".join(f"{k}={e['evidence'][k]}" for k in sorted(e.get("evidence") or {}))
    bits = [
        f"{indent}{e.get('ts', 0):.3f} [{e.get('severity', '?'):4s}] "
        f"{e.get('actor')}/{e.get('action')}"
    ]
    if e.get("model") or e.get("tenant"):
        bits.append(f"({e.get('model') or e.get('tenant')})")
    if e.get("message"):
        bits.append(f"— {e['message']}")
    lines = [" ".join(bits), f"{indent}    event_id={e.get('event_id')}"]
    if e.get("cause"):
        lines.append(f"{indent}    cause={e['cause']}")
    if e.get("trace_id"):
        lines.append(f"{indent}    exemplar trace_id={e['trace_id']}")
    if ev:
        lines.append(f"{indent}    evidence: {ev}")
    return "\n".join(lines)


def format_replay(doc: Dict[str, Any]) -> str:
    """Human rendering of :func:`replay_report`."""
    out: List[str] = [
        f"decision journal replay: {doc['dir']}",
        f"{doc['event_count']} event(s), "
        + ", ".join(f"{a}×{n}" for a, n in doc["actors"].items()),
        "",
    ]
    explain = doc.get("explain")
    if explain is not None:
        if not explain["found"]:
            out.append(f"event {explain['event_id']} not found in the durable log")
            return "\n".join(out)
        out.append(
            f"causal chain for {explain['event_id']} "
            f"({len(explain['chain'])} event(s), root first):"
        )
        for i, e in enumerate(explain["chain"]):
            out.append(_fmt_event(e, indent="  " * i))
        out.append("")
        out.append(f"downstream effects ({len(explain['effects'])}):")
        for e in explain["effects"]:
            out.append(_fmt_event(e, indent="  "))
        return "\n".join(out)
    check = doc.get("check")
    if check is not None:
        out.append(
            f"protocol conformance: {check['stepped']} protocol event(s) "
            f"stepped, {check['violation_count']} violation(s)"
        )
        for v in check["violations"]:
            out.append(f"  H805 {v['event_id']}: {v['message']}")
        out.append("")
    out.append("timeline (oldest first):")
    for e in doc["events"]:
        out.append(_fmt_event(e))
    return "\n".join(out)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m heat_tpu_torch.telemetry.replay",
        description="reconstruct the control-plane incident timeline "
        "from a durable decision-journal directory",
    )
    ap.add_argument("directory", help="HEAT_TPU_JOURNAL_DIR of the dead process")
    ap.add_argument("--event-id", default=None,
                    help="explain one decision: causal chain + effects")
    ap.add_argument("--check", action="store_true",
                    help="step the timeline through the declared control-"
                    "plane protocols; non-zero exit on any H805 violation")
    ap.add_argument("--json", action="store_true", help="machine-readable output")
    args = ap.parse_args(argv)

    doc = replay_report(args.directory, event_id=args.event_id, check=args.check)
    if args.json:
        print(json.dumps(doc, indent=1, default=str))
    else:
        print(format_replay(doc))
    if args.check and doc["check"]["violation_count"]:
        return 2
    return 0 if doc["event_count"] else 1


if __name__ == "__main__":
    sys.exit(main())
