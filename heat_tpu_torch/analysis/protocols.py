"""Declared control-plane protocol state machines (counterpart of
heat_tpu/analysis/protocols.py, verbatim in its tables).

Each entry declares one autonomous controller's protocol as a state
machine: its states, its legal transitions, and the journal ``(actor,
action)`` event each transition must emit.  The runtime conformance
checker (:mod:`heat_tpu_torch.analysis.conformance`,
``HEAT_TPU_PROTOCOL_CHECK=0/1/raise``) replays the live decision journal
through the same machines and reports any illegal transition as an
``analysis.diags.H805`` diagnostic.

The tables are the reference's, value for value: a journal written by
either package steps through the same machines, and ``module`` names the
reference's controller module (the port's controllers come with the
serving, fleet and streaming slices).  Every table is a pure literal
(``ast.literal_eval`` over the source reproduces it): no comprehensions,
no name references, no function calls.

Registry schema (one entry per protocol)::

    "name": {
        "doc":      one-line description,
        "actor":    the journal actor every transition of this machine
                    emits under,
        "module":   repo-relative path of the owning controller module,
        "scope":    how conformance keys machine *instances*:
                    "model" (event.model), "replica"/"alert"/"gate"
                    (evidence key of that name) or "global",
        "initial":  the state a fresh instance starts in,
        "states":   every declared state,
        "transitions": records {"from", "to", "action", "when",
                    "effect"} -- ``action`` is the journal action the
                    transition emits; ``when``/``effect`` are
                    model-checker atoms over :data:`ENVIRONMENT` vars,
        "state_attrs", "state_keys", "transition_fns", "silent_fns":
                    the reference's static-lint metadata, kept so the
                    tables compare equal,
    }
"""

from __future__ import annotations

from typing import Any, Dict, FrozenSet, List, Set, Tuple

__all__ = [
    "PROTOCOLS",
    "ENVIRONMENT",
    "PROPERTIES",
    "declared_pairs",
    "protocol_for_pair",
    "registry_problems",
    "render_diagrams_markdown",
    # the journal vocabulary, one constant per declared actor/action
    "ACTOR_ROUTER", "CB_TRIP", "CB_HALF_OPEN", "CB_READMIT", "CB_REOPEN",
    "ACTOR_CANARY", "CANARY_STAGE", "CANARY_VETO", "CANARY_PROMOTED",
    "CANARY_ROLLED_BACK", "CANARY_OBSERVED",
    "ACTOR_REPLICA", "REPLICA_WARM", "REPLICA_READY", "REPLICA_DRAIN",
    "REPLICA_STOP",
    "ACTOR_PREEMPT", "PREEMPT_RAISE", "PREEMPT_CLEAR",
    "ACTOR_AUTOSCALER", "SCALE_SPAWN", "SCALE_DRAIN",
    "ACTOR_REFRESH", "REFRESH_TRIGGER",
    "ACTOR_ALERTS", "ALERT_FIRE", "ALERT_RESOLVE",
    "ACTOR_STREAM", "STREAM_RESHARD",
    "ACTOR_ELASTIC", "ELASTIC_RESHAPE",
    "ACTOR_FLIGHT_RECORDER", "FLIGHT_RECORDER_BUNDLE",
]

# ----------------------------------------------------------------------
# the journal vocabulary: one constant per declared actor/action, so
# emit sites and the journal's readers cannot drift apart.
# ----------------------------------------------------------------------
ACTOR_ROUTER = "router"
CB_TRIP = "cb_trip"
CB_HALF_OPEN = "cb_half_open"
CB_READMIT = "cb_readmit"
CB_REOPEN = "cb_reopen"

ACTOR_CANARY = "canary"
CANARY_STAGE = "stage"
CANARY_VETO = "veto"
CANARY_PROMOTED = "promoted"
CANARY_ROLLED_BACK = "rolled_back"
CANARY_OBSERVED = "observed"

ACTOR_REPLICA = "replica"
REPLICA_WARM = "warm"
REPLICA_READY = "ready"
REPLICA_DRAIN = "drain"
REPLICA_STOP = "stop"

ACTOR_PREEMPT = "preempt"
PREEMPT_RAISE = "raise"
PREEMPT_CLEAR = "clear"

ACTOR_AUTOSCALER = "autoscaler"
SCALE_SPAWN = "spawn"
SCALE_DRAIN = "drain"

ACTOR_REFRESH = "refresh"
REFRESH_TRIGGER = "trigger"

ACTOR_ALERTS = "alerts"
ALERT_FIRE = "fire"
ALERT_RESOLVE = "resolve"

ACTOR_STREAM = "stream"
STREAM_RESHARD = "reshard"

ACTOR_ELASTIC = "elastic"
ELASTIC_RESHAPE = "reshape"

ACTOR_FLIGHT_RECORDER = "flight_recorder"
FLIGHT_RECORDER_BUNDLE = "bundle"


#: every controller's declared protocol machine — PURE LITERAL (see
#: the module docstring for the schema and the atom syntax)
PROTOCOLS = {
    "router.breaker": {
        "doc": "per-replica circuit breaker in the fleet router: "
               "closed -> open on consecutive failures, exactly one "
               "half-open probe after the cooldown, readmit on a "
               "successful probe, re-open on a failed one",
        "actor": "router",
        "module": "heat_tpu/fleet/router.py",
        "scope": "replica",
        "initial": "closed",
        "states": ("closed", "open", "half_open"),
        "transitions": (
            {"from": "closed", "to": "open", "action": "cb_trip",
             "when": ("env.replica_up=no",), "effect": ()},
            {"from": "open", "to": "half_open", "action": "cb_half_open",
             "when": ("env.probes=0",), "effect": ("env.probes=1",)},
            {"from": "half_open", "to": "closed", "action": "cb_readmit",
             "when": ("env.replica_up=yes",), "effect": ("env.probes=0",)},
            {"from": "half_open", "to": "open", "action": "cb_reopen",
             "when": ("env.replica_up=no",), "effect": ("env.probes=0",)},
        ),
        "state_attrs": ("cb_open", "probing"),
        "state_keys": (),
        "transition_fns": ("_pick", "_report"),
        "silent_fns": ("__init__", "_cb_mark_probe", "_cb_on_success",
                       "_cb_on_failure"),
    },
    "canary": {
        "doc": "canary decision plane: a staged version is resident "
               "until the shadow window decides; a veto (firing drift/"
               "SLO alert) holds it resident — never terminal",
        "actor": "canary",
        "module": "heat_tpu/serving/canary.py",
        "scope": "model",
        "initial": "absent",
        "states": ("absent", "resident", "promoted", "rolled_back",
                   "observed"),
        "transitions": (
            {"from": "absent", "to": "resident", "action": "stage",
             "when": ("env.staged=yes",),
             "effect": ("env.staged=no", "env.shadow=collecting")},
            {"from": "resident", "to": "resident", "action": "stage",
             "when": ("env.staged=yes",),
             "effect": ("env.staged=no", "env.shadow=collecting")},
            {"from": "promoted", "to": "resident", "action": "stage",
             "when": ("env.staged=yes",),
             "effect": ("env.staged=no", "env.shadow=collecting")},
            {"from": "rolled_back", "to": "resident", "action": "stage",
             "when": ("env.staged=yes",),
             "effect": ("env.staged=no", "env.shadow=collecting")},
            {"from": "observed", "to": "resident", "action": "stage",
             "when": ("env.staged=yes",),
             "effect": ("env.staged=no", "env.shadow=collecting")},
            {"from": "resident", "to": "resident", "action": "veto",
             "when": ("env.shadow=pass", "env.drift=firing"),
             "effect": ()},
            {"from": "resident", "to": "promoted", "action": "promoted",
             "when": ("env.shadow=pass", "env.drift=idle"),
             "effect": ()},
            {"from": "resident", "to": "rolled_back",
             "action": "rolled_back",
             "when": ("env.shadow=fail",), "effect": ()},
            {"from": "resident", "to": "observed", "action": "observed",
             "when": ("env.shadow=pass", "env.drift=idle"),
             "effect": ()},
        ),
        "state_attrs": (),
        "state_keys": ("verdict",),
        "transition_fns": ("_journal_stage", "_hold", "_decide"),
        "silent_fns": (),
    },
    "replica": {
        "doc": "serving replica lifecycle behind /readyz: born ready "
               "in-process, warming in the fleet spawn path, draining "
               "finishes in-flight work, stopped is terminal",
        "actor": "replica",
        "module": "heat_tpu/serving/service.py",
        "scope": "replica",
        "initial": "ready",
        "states": ("warming", "ready", "draining", "stopped"),
        "transitions": (
            {"from": "ready", "to": "warming", "action": "warm",
             "when": (), "effect": ()},
            {"from": "warming", "to": "ready", "action": "ready",
             "when": (), "effect": ()},
            {"from": "ready", "to": "draining", "action": "drain",
             "when": (), "effect": ()},
            {"from": "warming", "to": "draining", "action": "drain",
             "when": (), "effect": ()},
            {"from": "ready", "to": "stopped", "action": "stop",
             "when": (), "effect": ()},
            {"from": "warming", "to": "stopped", "action": "stop",
             "when": (), "effect": ()},
            {"from": "draining", "to": "stopped", "action": "stop",
             "when": (), "effect": ()},
        ),
        "state_attrs": ("_state",),
        "state_keys": (),
        "transition_fns": ("set_state",),
        "silent_fns": ("__init__",),
    },
    "preempt": {
        "doc": "level-triggered preemption gate between latency "
               "traffic and checkpointed fits: a raise must always "
               "have a reachable clear",
        "actor": "preempt",
        "module": "heat_tpu/core/preempt.py",
        "scope": "gate",
        "initial": "idle",
        "states": ("idle", "raised"),
        "transitions": (
            {"from": "idle", "to": "raised", "action": "raise",
             "when": ("env.spike=on",), "effect": ()},
            {"from": "raised", "to": "idle", "action": "clear",
             "when": ("env.spike=off",), "effect": ()},
        ),
        "state_attrs": ("_reason",),
        "state_keys": (),
        "transition_fns": ("request", "clear"),
        "silent_fns": ("__init__",),
    },
    "autoscaler": {
        "doc": "hysteresis autoscaler actuations: spawn answers "
               "sustained overload, drain sustained underload — no "
               "spawn/drain cycle without an environment change",
        "actor": "autoscaler",
        "module": "heat_tpu/fleet/autoscaler.py",
        "scope": "global",
        "initial": "steady",
        "states": ("steady",),
        "transitions": (
            {"from": "steady", "to": "steady", "action": "spawn",
             "when": ("env.load=high",), "effect": ("env.load=normal",)},
            {"from": "steady", "to": "steady", "action": "drain",
             "when": ("env.load=low",), "effect": ("env.load=normal",)},
        ),
        "state_attrs": (),
        "state_keys": (),
        "transition_fns": ("_journal_scale",),
        "silent_fns": (),
    },
    "refresh": {
        "doc": "drift-triggered refresh driver: re-fit + fresh "
               "baseline + canary stage, only while no canary is "
               "already resident (the decision plane owns the next "
               "transition)",
        "actor": "refresh",
        "module": "heat_tpu/streaming/refresh.py",
        "scope": "model",
        "initial": "watching",
        "states": ("watching",),
        "transitions": (
            {"from": "watching", "to": "watching", "action": "trigger",
             "when": ("env.drift=firing", "canary!=resident"),
             "effect": ("env.baseline=fresh", "env.staged=yes")},
        ),
        "state_attrs": (),
        "state_keys": (),
        "transition_fns": ("_refresh",),
        "silent_fns": (),
    },
    "alerts": {
        "doc": "deduplicated alert lifecycle: one fired transition "
               "per active (name, labels), idempotent resolve",
        "actor": "alerts",
        "module": "heat_tpu/telemetry/alerts.py",
        "scope": "alert",
        "initial": "inactive",
        "states": ("inactive", "firing"),
        "transitions": (
            {"from": "inactive", "to": "firing", "action": "fire",
             "when": (), "effect": ()},
            {"from": "firing", "to": "inactive", "action": "resolve",
             "when": (), "effect": ()},
        ),
        "state_attrs": (),
        "state_keys": (),
        "transition_fns": ("fire", "resolve"),
        "silent_fns": (),
    },
    "stream": {
        "doc": "streaming consumer key-distribution watcher: a "
               "sustained PSI shift triggers exactly one reshard",
        "actor": "stream",
        "module": "heat_tpu/streaming/consumer.py",
        "scope": "global",
        "initial": "consuming",
        "states": ("consuming",),
        "transitions": (
            {"from": "consuming", "to": "consuming", "action": "reshard",
             "when": (), "effect": ()},
        ),
        "state_attrs": (),
        "state_keys": (),
        "transition_fns": ("_fold_keys",),
        "silent_fns": (),
    },
    "elastic": {
        "doc": "elastic supervisor mesh reshape after worker loss",
        "actor": "elastic",
        "module": "heat_tpu/elastic/supervisor.py",
        "scope": "global",
        "initial": "supervising",
        "states": ("supervising",),
        "transitions": (
            {"from": "supervising", "to": "supervising",
             "action": "reshape", "when": (), "effect": ()},
        ),
        "state_attrs": (),
        "state_keys": (),
        "transition_fns": ("_recover",),
        "silent_fns": (),
    },
    "flight_recorder": {
        "doc": "forensic bundle dump chained off a canary rollback",
        "actor": "flight_recorder",
        "module": "heat_tpu/serving/canary.py",
        "scope": "model",
        "initial": "armed",
        "states": ("armed",),
        "transitions": (
            {"from": "armed", "to": "armed", "action": "bundle",
             "when": (), "effect": ()},
        ),
        "state_attrs": (),
        "state_keys": (),
        "transition_fns": ("_dump_bundle",),
        "silent_fns": (),
    },
}


#: the small adversarial environment the model checker composes the
#: machines with — PURE LITERAL.  Variables are finite domains (the
#: first value is the initial one); events are the world's moves,
#: guarded by ``when`` atoms and applying ``set`` assignments.  The
#: environment is deliberately pessimistic: a firing drift alert only
#: resolves against a FRESH baseline (live traffic is never assumed to
#: drift back on its own), and a passing shadow window can always
#: degrade to fail (the window keeps accumulating until the decision).
ENVIRONMENT = {
    "vars": {
        "drift": ("idle", "firing"),
        "baseline": ("stale", "fresh"),
        "shadow": ("collecting", "pass", "fail"),
        "staged": ("no", "yes"),
        "spike": ("off", "on"),
        "load": ("normal", "high", "low"),
        "replica_up": ("yes", "no"),
        "probes": (0, 1, 2),
    },
    "events": (
        {"name": "drift_fires",
         "when": ("env.drift=idle", "env.baseline=stale"),
         "set": ("env.drift=firing",)},
        {"name": "drift_resolves",
         "when": ("env.drift=firing", "env.baseline=fresh"),
         "set": ("env.drift=idle",)},
        {"name": "distribution_shifts",
         "when": ("env.drift=idle", "env.baseline=fresh"),
         "set": ("env.baseline=stale",)},
        {"name": "shadow_passes",
         "when": ("env.shadow=collecting",),
         "set": ("env.shadow=pass",)},
        {"name": "shadow_fails",
         "when": ("env.shadow=collecting",),
         "set": ("env.shadow=fail",)},
        {"name": "shadow_degrades",
         "when": ("env.shadow=pass",),
         "set": ("env.shadow=fail",)},
        {"name": "operator_stages",
         "when": ("env.staged=no",),
         "set": ("env.staged=yes",)},
        {"name": "spike_starts",
         "when": ("env.spike=off",),
         "set": ("env.spike=on",)},
        {"name": "spike_ends",
         "when": ("env.spike=on",),
         "set": ("env.spike=off",)},
        {"name": "load_rises",
         "when": ("env.load=normal",),
         "set": ("env.load=high",)},
        {"name": "load_falls",
         "when": ("env.load=normal",),
         "set": ("env.load=low",)},
        {"name": "replica_dies",
         "when": ("env.replica_up=yes",),
         "set": ("env.replica_up=no",)},
        {"name": "replica_recovers",
         "when": ("env.replica_up=no",),
         "set": ("env.replica_up=yes",)},
    ),
}


#: the model-checked invariants — PURE LITERAL.  Kinds:
#:
#: * ``never``: the atom conjunction must hold in NO reachable product
#:   state (safety); counterexample = the path that reaches it.
#: * ``reach``: from EVERY reachable state satisfying ``when``, some
#:   state satisfying ``goal`` must be reachable (no stuck region);
#:   counterexample = the path into the stuck region plus the livelock
#:   cycle (or deadlock) it is trapped in.
#: * ``no_cycle``: no reachable cycle exists that contains every action
#:   in ``actions``, none in ``forbid_actions``, and (unless
#:   ``env_ok``) no environment event at all — the flap/livelock shape.
PROPERTIES = (
    {"name": "breaker_single_probe",
     "kind": "never",
     "doc": "the circuit breaker admits at most one half-open probe "
            "in flight per replica",
     "machines": ("router.breaker",),
     "atoms": ("env.probes=2",)},
    {"name": "breaker_recovers",
     "kind": "reach",
     "doc": "an open breaker can always readmit its replica once the "
            "replica recovers (closed stays reachable)",
     "machines": ("router.breaker",),
     "when": ("router.breaker=open",),
     "goal": ("router.breaker=closed",)},
    {"name": "canary_decides",
     "kind": "reach",
     "doc": "a resident canary can always reach a decision — the "
            "drift veto must never pin it resident forever",
     "machines": ("refresh", "canary"),
     "when": ("canary=resident",),
     "goal": ("canary!=resident", "canary!=absent")},
    {"name": "refresh_no_livelock",
     "kind": "no_cycle",
     "doc": "the refresh driver must not re-fire against its own "
            "vetoed canary: no trigger/veto cycle without an "
            "intervening decision",
     "machines": ("refresh", "canary"),
     "actions": ("trigger", "veto"),
     "forbid_actions": ("promoted", "rolled_back", "observed"),
     "env_ok": True},
    {"name": "preempt_clear_reachable",
     "kind": "reach",
     "doc": "a raised preemption request can always be cleared once "
            "the latency spike drains",
     "machines": ("preempt",),
     "when": ("preempt=raised",),
     "goal": ("preempt=idle",)},
    {"name": "autoscaler_no_flap",
     "kind": "no_cycle",
     "doc": "hysteresis holds: no spawn/drain cycle without an "
            "intervening load change",
     "machines": ("autoscaler",),
     "actions": ("spawn", "drain"),
     "forbid_actions": (),
     "env_ok": False},
)


# ----------------------------------------------------------------------
# derivations (shared by conformance and the tests)
# ----------------------------------------------------------------------
def declared_pairs(
    protocols: Dict[str, Any] = None,
) -> Set[Tuple[str, str]]:
    """Every declared journal ``(actor, action)`` pair."""
    table = PROTOCOLS if protocols is None else protocols
    out: Set[Tuple[str, str]] = set()
    for rec in table.values():
        for t in rec["transitions"]:
            out.add((rec["actor"], t["action"]))
    return out


def protocol_for_pair(
    actor: str, action: str, protocols: Dict[str, Any] = None,
) -> List[str]:
    """Names of the protocols declaring ``(actor, action)`` (hygiene
    requires exactly one)."""
    table = PROTOCOLS if protocols is None else protocols
    return sorted(
        name for name, rec in table.items()
        if rec["actor"] == actor
        and any(t["action"] == action for t in rec["transitions"])
    )


def registry_problems(protocols: Dict[str, Any] = None) -> List[str]:
    """Structural defects in a PROTOCOLS-shaped table: transitions
    from/to undeclared states, an initial state outside ``states``,
    declared-but-unreachable states, and an ``(actor, action)`` pair
    claimed by two protocols.  Empty on the shipped registry (the H804
    rule and the hygiene tests both assert it)."""
    table = PROTOCOLS if protocols is None else protocols
    problems: List[str] = []
    pair_owner: Dict[Tuple[str, str], str] = {}
    for name, rec in sorted(table.items()):
        states = set(rec["states"])
        if rec["initial"] not in states:
            problems.append(
                f"{name}: initial state {rec['initial']!r} is not in "
                f"states {sorted(states)}"
            )
        adjacency: Dict[str, Set[str]] = {s: set() for s in states}
        for t in rec["transitions"]:
            for end, label in ((t["from"], "from"), (t["to"], "to")):
                if end not in states:
                    problems.append(
                        f"{name}: transition {t['action']!r} {label}-state "
                        f"{end!r} is not a declared state"
                    )
            if t["from"] in states and t["to"] in states:
                adjacency[t["from"]].add(t["to"])
            pair = (rec["actor"], t["action"])
            owner = pair_owner.setdefault(pair, name)
            if owner != name:
                problems.append(
                    f"{name}: journal pair {pair!r} is already declared "
                    f"by protocol {owner!r}"
                )
        if rec["initial"] in states:
            seen = {rec["initial"]}
            frontier = [rec["initial"]]
            while frontier:
                for nxt in adjacency.get(frontier.pop(), ()):
                    if nxt not in seen:
                        seen.add(nxt)
                        frontier.append(nxt)
            for s in sorted(states - seen):
                problems.append(
                    f"{name}: state {s!r} is unreachable from initial "
                    f"{rec['initial']!r} via the declared transitions"
                )
    return problems


def transition_index(
    protocols: Dict[str, Any] = None,
) -> Dict[Tuple[str, str], Tuple[str, str, Tuple[Tuple[str, str], ...]]]:
    """``(actor, action) -> (protocol, scope, ((from, to), ...))`` — the
    lookup table the runtime conformance checker steps events through."""
    table = PROTOCOLS if protocols is None else protocols
    out: Dict[Tuple[str, str], Tuple[str, str, Tuple[Tuple[str, str], ...]]] = {}
    for name, rec in sorted(table.items()):
        for t in rec["transitions"]:
            pair = (rec["actor"], t["action"])
            prev = out.get(pair)
            edges = (prev[2] if prev else ()) + ((t["from"], t["to"]),)
            out[pair] = (name, rec["scope"], edges)
    return out


def render_diagrams_markdown(protocols: Dict[str, Any] = None) -> str:
    """Per-controller state-machine diagrams as markdown."""
    table = PROTOCOLS if protocols is None else protocols
    lines: List[str] = []
    for name in sorted(table):
        rec = table[name]
        lines.append(
            f"**`{name}`** — actor `{rec['actor']}`, `{rec['module']}`, "
            f"scope `{rec['scope']}` — {rec['doc']}"
        )
        lines.append("")
        lines.append("```")
        width = max(len(str(t["from"])) for t in rec["transitions"])
        for t in rec["transitions"]:
            frm = str(t["from"]).rjust(width)
            marker = " *" if t["from"] == rec["initial"] else "  "
            guard = ""
            if t["when"]:
                guard = "   [" + " & ".join(t["when"]) + "]"
            lines.append(f"{marker}{frm} --{t['action']}--> {t['to']}{guard}")
        lines.append("```")
        lines.append("")
    return "\n".join(lines).rstrip() + "\n"
