"""Deterministic, seeded fault injection for failure-path testing
(counterpart of heat_tpu/resilience/faults.py).

Long-running fits on preemptible machines see transient IO errors, host
preemption and lost collectives; CPU CI sees none of them.  This module
makes failure a *scriptable, reproducible* scenario: named injection
points (``faults.inject("io.write", path=...)``) are wired through the
port's io (``io.open``, ``io.write``), the SpGEMM ring's count re-sync
(``comm.collective``), the process-group bootstrap (``comm.init``), the
checkpoints (``checkpoint.*``), the resumable fits' chunk boundaries
(``kmeans.iter`` and the like, ``qos.preempt``), the elastic
supervisors (``elastic.*``), the dispatch layer's misses
(``dispatch.compile``) and the artifact cache (``aot.load``,
``aot.save``), and a **fault plan** decides, per site and per call index,
whether a scripted fault fires.  Plans, seeds and site names are the reference's:
the same plan and seed fire at the same call indices in both packages.

Sites may be evaluated from *any* thread; the injector is
lock-protected, so per-site call indices stay deterministic across
threads as long as the call *sequence* is.

Plan format
-----------
A plan is a mapping from site pattern to a list of rules::

    {
        "io.write":          [0, 3],                    # transient at call 0 and 3
        "dispatch.compile":  [{"at": 1, "kind": "transient"}],
        "checkpoint.save":   [{"at": 2, "kind": "kill"}],
        "comm.*":            [{"p": 0.01, "kind": "transient"}],
    }

* Site patterns match exactly or by :mod:`fnmatch` glob (``"io.*"``).
* A bare int ``n`` is shorthand for ``{"at": n, "kind": "transient"}``.
* ``at`` may be an int or list of ints — the per-site **call index** at
  which the rule fires (each evaluated injection point increments the
  site's counter).
* ``p`` fires with probability ``p`` per call, driven by a
  ``random.Random`` seeded from ``(seed, site)`` — the same plan + seed
  + call sequence always injects the same faults.
* ``kind``: ``"transient"`` (raises :class:`TransientFault`, retryable),
  ``"permanent"`` (raises :class:`PermanentFault`, never retried) or
  ``"kill"`` (``os._exit`` — simulated host preemption; exit code via
  ``exit_code``, default 137).
* ``times`` caps how often a ``p`` rule may fire (default unlimited;
  ``at`` rules fire once per listed index).

Activation
----------
* Context manager: ``with fault_plan({...}, seed=0) as inj: ...`` —
  ``inj.hits``/``inj.injected`` hold per-site counters for assertions.
* Environment: ``HEAT_TPU_FAULT_PLAN`` holds either inline JSON or a
  path to a JSON file (``{"plan": {...}, "seed": 0}`` or just the plan
  mapping).  This is how a *subprocess* under test gets its script —
  e.g. "kill the fit at iteration k" for kill-and-resume tests.

With no active plan, :func:`inject` is a counter-free no-op — the
injection points cost one global read on production paths.
"""

from __future__ import annotations

import fnmatch
import json
import os
import random
import threading
from typing import Any, Dict, List, Optional

from .errors import PermanentFault, TransientFault
from ..core import _env
from ..analysis import tsan as _tsan
from ..telemetry import metrics as _tm

__all__ = [
    "FaultInjector",
    "KNOWN_SITES",
    "fault_plan",
    "inject",
    "active_injector",
    "fault_stats",
    "reset_fault_stats",
    "refresh_env_plan",
]

PLAN_ENV = "HEAT_TPU_FAULT_PLAN"

#: Registry of every named injection point, the reference's table (a
#: plan written for the reference names the same sites).  The port wires
#: ``comm.init``, ``comm.collective`` (the SpGEMM ring), ``io.open``,
#: ``io.write``, the ``checkpoint.*`` sites, the estimators' ``*.iter``
#: and ``pca.stage``, the ``elastic.*`` sites, ``qos.preempt``,
#: ``dispatch.compile`` and ``aot.load``/``aot.save`` so far;
#: the others come with the modules that evaluate them.  A pure literal.
KNOWN_SITES = (
    "comm.init",
    "comm.collective",
    "dispatch.compile",
    "io.open",
    "io.write",
    "checkpoint.save",
    "checkpoint.restore",
    "checkpoint.write",
    "checkpoint.async_write",
    "estimator.iter",
    "kmeans.iter",
    "kmedians.iter",
    "kmedoids.iter",
    "lasso.iter",
    "pca.stage",
    "elastic.detect",
    "elastic.reshape",
    "elastic.resume",
    "serve.load",
    "serve.predict",
    "serve.batch",
    "serve.shadow",
    "aot.load",
    "aot.save",
    "fleet.route",
    "fleet.spawn",
    "stream.read",
    "stream.commit",
    "stream.refresh",
    "qos.preempt",
)

#: process-lifetime totals (survive injector deactivation) — registered
#: in the shared telemetry registry as ``fault.*``, read by
#: ``telemetry.snapshot()``
_SITES_EVALUATED = _tm.counter("fault.sites_evaluated")
_FAULTS_INJECTED = _tm.counter("fault.faults_injected")


def _normalize_rule(rule: Any) -> Dict:
    if isinstance(rule, int):
        rule = {"at": rule}
    if not isinstance(rule, dict):
        raise TypeError(f"fault rule must be an int or dict, got {type(rule)}")
    out = dict(rule)
    kind = out.setdefault("kind", "transient")
    if kind not in ("transient", "permanent", "kill"):
        raise ValueError(f"unknown fault kind {kind!r}")
    if "at" in out:
        at = out["at"]
        out["at"] = frozenset([int(at)] if isinstance(at, int) else [int(i) for i in at])
    elif "p" not in out:
        raise ValueError("fault rule needs 'at' or 'p'")
    if "p" in out:
        p = float(out["p"])
        if not 0.0 <= p <= 1.0:
            raise ValueError(f"fault probability must be in [0, 1], got {p}")
        out["p"] = p
    return out


class FaultInjector:
    """An activated fault plan with per-site hit accounting.

    ``hits[site]`` counts every evaluation of the site's injection
    point; ``injected[site]`` lists ``(call_index, kind)`` for each
    fault actually raised — the assertion surface of failure tests.
    """

    def __init__(self, plan: Dict[str, Any], seed: int = 0):
        self.seed = int(seed)
        self.plan = {
            site: [_normalize_rule(r) for r in (rules if isinstance(rules, list) else [rules])]
            for site, rules in (plan or {}).items()
        }
        self.hits: Dict[str, int] = {}
        self.injected: Dict[str, List] = {}
        self._fired: Dict[int, int] = {}  # id(rule) -> times fired
        self._rngs: Dict[str, random.Random] = {}
        # sites fire from the async-writer and loader threads; the
        # registered lock keeps per-site call indices deterministic and
        # lets the sanitizer verify every evaluation holds it
        self._lock = _tsan.register_lock("resilience.faults.injector")
        self._prev: Optional["FaultInjector"] = None

    # -- plan evaluation ------------------------------------------------
    def _rules_for(self, site: str) -> List[Dict]:
        rules = self.plan.get(site)
        if rules is not None:
            return rules
        out: List[Dict] = []
        for pattern, rs in self.plan.items():
            if "*" in pattern or "?" in pattern or "[" in pattern:
                if fnmatch.fnmatchcase(site, pattern):
                    out.extend(rs)
        return out

    def check(self, site: str, info: Dict) -> None:
        """Record one evaluation of ``site`` and raise if the plan says so."""
        with self._lock:
            _tsan.note_access("resilience.faults.counters")
            index = self.hits.get(site, 0)
            self.hits[site] = index + 1
            _SITES_EVALUATED.inc()
            fire_kind = None
            for rule in self._rules_for(site):
                fired = self._fired.get(id(rule), 0)
                times = rule.get("times")
                if times is not None and fired >= times:
                    continue
                hit = False
                if "at" in rule and index in rule["at"]:
                    hit = True
                elif "p" in rule:
                    rng = self._rngs.get(site)
                    if rng is None:
                        rng = self._rngs[site] = random.Random(f"{self.seed}:{site}")
                    hit = rng.random() < rule["p"]
                if hit:
                    self._fired[id(rule)] = fired + 1
                    fire_kind = rule["kind"]
                    break
            if fire_kind is None:
                return
            self.injected.setdefault(site, []).append((index, fire_kind))
            _FAULTS_INJECTED.inc()
        if fire_kind == "kill":
            os._exit(int(rule.get("exit_code", 137)))
        msg = rule.get(
            "message", f"injected {fire_kind} fault at {site!r} call {index}"
        )
        if fire_kind == "permanent":
            raise PermanentFault(msg, site=site, index=index)
        raise TransientFault(msg, site=site, index=index)

    # -- activation -----------------------------------------------------
    def __enter__(self) -> "FaultInjector":
        global _ACTIVE
        self._prev = _ACTIVE
        _ACTIVE = self
        return self

    def __exit__(self, *exc) -> None:
        global _ACTIVE
        _ACTIVE = self._prev
        self._prev = None


_ACTIVE: Optional[FaultInjector] = None
_ENV_CHECKED = False


def fault_plan(plan: Dict[str, Any], seed: int = 0) -> FaultInjector:
    """Build a :class:`FaultInjector`; use as a context manager to
    activate it for the enclosed block."""
    return FaultInjector(plan, seed=seed)


def _load_env_plan() -> Optional[FaultInjector]:
    raw = _env.env_str(PLAN_ENV)
    if not raw:
        return None
    raw = raw.strip()
    if not raw.startswith("{") and os.path.exists(raw):
        with open(raw) as f:
            raw = f.read()
    spec = json.loads(raw)
    if "plan" in spec and isinstance(spec["plan"], dict):
        return FaultInjector(spec["plan"], seed=int(spec.get("seed", 0)))
    return FaultInjector(spec)


def refresh_env_plan() -> Optional[FaultInjector]:
    """(Re-)read ``HEAT_TPU_FAULT_PLAN`` and activate it process-wide.

    Called lazily by the first :func:`inject`; call explicitly after
    changing the env var mid-process (tests)."""
    global _ACTIVE, _ENV_CHECKED
    _ENV_CHECKED = True
    inj = _load_env_plan()
    if inj is not None:
        _ACTIVE = inj
    return inj


def active_injector() -> Optional[FaultInjector]:
    """The currently active injector, or None."""
    return _ACTIVE


def inject(site: str, **info) -> None:
    """Evaluate the injection point ``site``.

    No-op (one global read) without an active plan; with one, records
    the hit and raises the scripted fault when the plan triggers."""
    global _ENV_CHECKED
    if _ACTIVE is None:
        if _ENV_CHECKED:
            return
        refresh_env_plan()
        if _ACTIVE is None:
            return
    _ACTIVE.check(site, info)


def fault_stats() -> Dict[str, int]:
    """Process-lifetime injection totals — a thin view over the shared
    telemetry registry (``fault.*``)."""
    return {
        "sites_evaluated": _SITES_EVALUATED.value,
        "faults_injected": _FAULTS_INJECTED.value,
    }


def reset_fault_stats() -> None:
    """Zero the injection totals; delegates to
    ``telemetry.reset_all("faults")``."""
    from ..telemetry import reset_all

    reset_all("faults")
