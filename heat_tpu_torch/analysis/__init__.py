"""Runtime analysis (counterpart of heat_tpu/analysis): the concurrency
sanitizer and the control-plane protocol checker.

* :mod:`~heat_tpu_torch.analysis.concurrency` -- the pure-literal
  :data:`LOCK_REGISTRY` of the port's cross-thread locks;
* :mod:`~heat_tpu_torch.analysis.tsan` -- the runtime sanitizer
  (``HEAT_TPU_TSAN=0/1/raise``): every registered lock is an
  instrumented proxy feeding a lock-order graph (a cycle is a potential
  deadlock, ``tsan.lock_cycle``) and guarded-structure checkpoints
  (``tsan.unguarded_access``);
* :mod:`~heat_tpu_torch.analysis.diagnostics` -- the structured
  :class:`Diagnostic` record every finding reports through;
* :mod:`~heat_tpu_torch.analysis.protocols` and
  :mod:`~heat_tpu_torch.analysis.conformance` -- the controllers'
  declared state machines and the checker that steps every journal
  event through them (``HEAT_TPU_PROTOCOL_CHECK=0/1/raise``).

The reference's static analyzers (the jaxpr/HLO program lint, the AST
lint, the dtype-flow and memory models, the model checker) read JAX
programs and the reference's sources; they are not part of the port.

This ``__init__`` is lazy (PEP 562), as the reference's: the low-level
modules that create registered locks at import (``telemetry.metrics``)
import ``tsan``, a stdlib-only module, while they are themselves being
imported.
"""

from __future__ import annotations

import importlib

__all__ = [
    "AnalysisWarning",
    "Diagnostic",
    "LOCK_REGISTRY",
    "PROPERTIES",
    "PROTOCOLS",
    "ProgramLintError",
    "analysis_mode",
    "clear_diagnostics",
    "concurrency",
    "conformance",
    "conformance_report",
    "diagnostics",
    "note_emit",
    "protocol_mode",
    "protocols",
    "recent_diagnostics",
    "set_analysis_mode",
    "set_protocol_mode",
    "tsan",
]

#: public name -> defining submodule (resolved lazily on first access)
_EXPORTS = {
    "AnalysisWarning": "diagnostics",
    "Diagnostic": "diagnostics",
    "ProgramLintError": "diagnostics",
    "analysis_mode": "diagnostics",
    "clear_diagnostics": "diagnostics",
    "recent_diagnostics": "diagnostics",
    "set_analysis_mode": "diagnostics",
    "LOCK_REGISTRY": "concurrency",
    "PROTOCOLS": "protocols",
    "PROPERTIES": "protocols",
    "conformance_report": "conformance",
    "note_emit": "conformance",
    "protocol_mode": "conformance",
    "set_protocol_mode": "conformance",
}

_SUBMODULES = ("concurrency", "conformance", "diagnostics", "protocols", "tsan")


def __getattr__(name: str):
    if name in _SUBMODULES:
        return importlib.import_module(f".{name}", __name__)
    modname = _EXPORTS.get(name)
    if modname is not None:
        mod = importlib.import_module(f".{modname}", __name__)
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(__all__))
