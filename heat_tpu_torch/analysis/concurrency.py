"""Central lock registry (counterpart of heat_tpu/analysis/concurrency.py).

Every lock of the port that guards cross-thread state is declared once in
:data:`LOCK_REGISTRY`: its name, the module that creates it, the lexical
spelling(s) a ``with`` statement uses to hold it, the shared structures
it guards, and a one-line doc.  The runtime sanitizer
(:mod:`heat_tpu_torch.analysis.tsan`) wraps every registered lock in an
instrumented proxy when ``HEAT_TPU_TSAN=1`` and checks off-thread access
to the registered structures against this table.

The names are the reference's, so a sanitizer finding reads the same in
both packages; only the port's own locks are registered (the metrics
registry, the span ring, the trace store, the decision journal, the
diagnostics ring, the conformance checker and the fault injector).  The
table is a pure literal: it can be read with ``ast.literal_eval``.
"""

from __future__ import annotations

from typing import Dict, Set, Tuple

__all__ = [
    "LOCK_REGISTRY",
    "lock_for_structure",
    "registered_lock_names",
    "registered_spellings",
    "registered_structures",
]

#: Every registered cross-thread lock: name -> {file, spellings,
#: structures, doc}.  ``file`` is the repo-relative module that creates
#: the lock; ``spellings`` are the lexical forms a ``with`` statement
#: holding it uses in that module; ``structures`` are the shared-state
#: names the lock guards (what ``tsan.note_access`` checkpoints
#: reference).
LOCK_REGISTRY = {
    'telemetry.metrics.registry': {
        'file': 'heat_tpu_torch/telemetry/metrics.py',
        'spellings': ('self._lock',),
        'structures': ('telemetry.metrics.registry',),
        'doc': 'MetricsRegistry._metrics name->metric map (get-or-make, snapshot, reset, Prometheus expose); per-metric value locks stay unregistered leaf locks',
    },
    'telemetry.spans.ring': {
        'file': 'heat_tpu_torch/telemetry/spans.py',
        'spellings': ('_RING_LOCK',),
        'structures': ('telemetry.spans.ring',),
        'doc': 'the bounded span ring buffer: appended by span() from any thread, iterated by get_spans/chrome_trace_doc from any other',
    },
    'telemetry.tracing.store': {
        'file': 'heat_tpu_torch/telemetry/tracing.py',
        'spellings': ('_STORE_LOCK',),
        'structures': ('telemetry.tracing.store',),
        'doc': 'the tail-sampled trace store: in-flight trace table mutations (begin/finish on request threads) and the recent/slowest/error retention structures (read by tracez_report and snapshots); per-trace span lists are unregistered leaf structures appended lock-free (GIL-atomic list.append), like the per-metric value locks',
    },
    'telemetry.journal': {
        'file': 'heat_tpu_torch/telemetry/journal.py',
        'spellings': ('_LOCK',),
        'structures': ('telemetry.journal.state',),
        'doc': 'the decision-journal hot ring + durable-segment cursor: controllers emit from their own threads, readers and snapshot gathers read; the durable segment append runs under it too (control-plane rates, a few events per incident)',
    },
    'analysis.diagnostics.ring': {
        'file': 'heat_tpu_torch/analysis/diagnostics.py',
        'spellings': ('_LOCK',),
        'structures': ('analysis.diagnostics.ring',),
        'doc': 'the bounded recent-diagnostics ring: emit() appends from any thread (sanitizer findings, protocol violations), recent_diagnostics() lists',
    },
    'analysis.conformance': {
        'file': 'heat_tpu_torch/analysis/conformance.py',
        'spellings': ('_LOCK',),
        'structures': ('analysis.conformance.state',),
        'doc': 'the protocol-conformance tracked machine states + bounded recent-violations list: note_emit() steps from whichever thread journaled (a strict leaf — journal.emit calls it only after the telemetry.journal lock is released; the violation diagnostic is reported outside it)',
    },
    'resilience.faults.injector': {
        'file': 'heat_tpu_torch/resilience/faults.py',
        'spellings': ('self._lock',),
        'structures': ('resilience.faults.counters',),
        'doc': 'FaultInjector per-site call indices + injected lists: sites may be evaluated from any thread; the lock keeps per-site call order deterministic',
    },
}


def registered_lock_names() -> Set[str]:
    """All registered lock names."""
    return set(LOCK_REGISTRY)


def registered_spellings() -> Set[str]:
    """Union of every registered lock's lexical ``with`` spellings."""
    out: Set[str] = set()
    for rec in LOCK_REGISTRY.values():
        out.update(rec["spellings"])
    return out


def registered_structures() -> Dict[str, str]:
    """structure name -> owning lock name, for every registered guarded
    structure (the table :func:`heat_tpu_torch.analysis.tsan.note_access`
    checks against)."""
    out: Dict[str, str] = {}
    for lock_name, rec in LOCK_REGISTRY.items():
        for s in rec["structures"]:
            out[s] = lock_name
    return out


def lock_for_structure(name: str) -> str:
    """The registered owner lock of guarded structure ``name``."""
    try:
        return registered_structures()[name]
    except KeyError:
        raise KeyError(
            f"{name!r} is not a registered guarded structure; add it to a "
            "lock's 'structures' tuple in heat_tpu_torch.analysis."
            "concurrency.LOCK_REGISTRY"
        ) from None
