"""Diagnostic records, modes, and the recent-diagnostics ring
(counterpart of heat_tpu/analysis/diagnostics.py).

The port's analyzers -- the concurrency sanitizer
(:mod:`~heat_tpu_torch.analysis.tsan`) and the protocol conformance
checker (:mod:`~heat_tpu_torch.analysis.conformance`) -- report through
one structured record type, the reference's.  Every diagnostic flows into
the shared telemetry registry (``analysis.diags.{rule}`` counters) and a
bounded ring of recent records, so a long-running fit's hazards are
visible from ``telemetry.snapshot()``.

``HEAT_TPU_ANALYZE`` selects the default mode: ``0`` (off, the
default), ``1`` (warn: each diagnostic raises an
:class:`AnalysisWarning`), ``raise`` (the first diagnostic raises
:class:`ProgramLintError`).  ``HEAT_TPU_ANALYZE_RING`` (default 256) is
the ring's capacity.  Both are read through ``core/_env.py``.
"""

from __future__ import annotations

import threading
import warnings
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ..telemetry import metrics as _tm
from ..core import _env
from . import tsan as _tsan

__all__ = [
    "AnalysisWarning",
    "Diagnostic",
    "ProgramLintError",
    "analysis_mode",
    "clear_diagnostics",
    "emit",
    "recent_diagnostics",
    "refresh_env",
    "set_analysis_mode",
]

MODE_OFF = "off"
MODE_WARN = "warn"
MODE_RAISE = "raise"

_MODE_ALIASES = {
    "0": MODE_OFF, "off": MODE_OFF, "false": MODE_OFF, "no": MODE_OFF,
    "1": MODE_WARN, "on": MODE_WARN, "warn": MODE_WARN, "true": MODE_WARN,
    "raise": MODE_RAISE, "error": MODE_RAISE, "2": MODE_RAISE,
}


class AnalysisWarning(UserWarning):
    """A program-lint diagnostic surfaced in warn mode."""


class ProgramLintError(RuntimeError):
    """A program-lint diagnostic surfaced in raise mode."""

    def __init__(self, diagnostic: "Diagnostic"):
        super().__init__(str(diagnostic))
        self.diagnostic = diagnostic


@dataclass(frozen=True)
class Diagnostic:
    """One structured finding of either analyzer.

    ``rule`` is the stable rule ID (``tsan.*`` for the sanitizer, ``H805``
    for a protocol violation; the reference's program and AST lints use
    ``J1xx`` and ``H1xx``-``H8xx``); ``location`` is a ``file:line`` or a
    label; ``details`` carries the machine-readable evidence."""

    rule: str
    message: str
    location: Optional[str] = None
    source: str = "program"  # "program" | "dispatch" | "ast"
    details: Dict[str, Any] = field(default_factory=dict)

    def __str__(self) -> str:
        loc = f" [{self.location}]" if self.location else ""
        return f"{self.rule}{loc}: {self.message}"


def _parse_mode(raw: Optional[str]) -> str:
    if raw is None:
        raw = "0"
    mode = _MODE_ALIASES.get(str(raw).strip().lower())
    if mode is None:
        raise ValueError(
            f"HEAT_TPU_ANALYZE={raw!r}: expected one of 0/1/raise"
        )
    return mode


_MODE = _parse_mode(_env.env_str("HEAT_TPU_ANALYZE"))
_RING_SIZE = _env.env_int("HEAT_TPU_ANALYZE_RING")
_RING: "deque[Diagnostic]" = deque(maxlen=max(1, _RING_SIZE))
#: emit() appends from any thread (sanitizer findings, protocol
#: violations); registered so the sanitizer can check the ring itself
_LOCK = _tsan.register_lock("analysis.diagnostics.ring")


def analysis_mode() -> str:
    """Current analyzer mode: ``"off"``, ``"warn"`` or ``"raise"``."""
    return _MODE


def set_analysis_mode(mode: str) -> str:
    """Set the analyzer mode at runtime (overrides the env var); accepts
    the env spellings (``0/1/raise``) or the mode names; returns the
    previous mode."""
    global _MODE
    prev = _MODE
    _MODE = _parse_mode(mode)
    return prev


def refresh_env() -> str:
    """Re-read ``HEAT_TPU_ANALYZE`` (tests that flip the env var
    mid-process); returns the new mode."""
    global _MODE
    _MODE = _parse_mode(_env.env_str("HEAT_TPU_ANALYZE"))
    return _MODE


def recent_diagnostics() -> List[Diagnostic]:
    """Recent diagnostics, oldest first (bounded ring,
    ``HEAT_TPU_ANALYZE_RING`` capacity)."""
    with _LOCK:
        _tsan.note_access("analysis.diagnostics.ring", write=False)
        return list(_RING)


def clear_diagnostics() -> None:
    """Drop every recorded diagnostic."""
    with _LOCK:
        _tsan.note_access("analysis.diagnostics.ring")
        _RING.clear()


def emit(diag: Diagnostic, mode: Optional[str] = None) -> None:
    """Record one diagnostic: bump ``analysis.diags.{rule}`` in the
    telemetry registry, append to the ring, and surface it according to
    ``mode`` (default: the global analyzer mode) — a warning in warn
    mode, :class:`ProgramLintError` in raise mode."""
    _tm.counter(
        f"analysis.diags.{diag.rule}",
        f"program-lint diagnostics of rule {diag.rule}",
    ).inc()
    with _LOCK:
        _tsan.note_access("analysis.diagnostics.ring")
        _RING.append(diag)
    mode = _MODE if mode is None else mode
    if mode == MODE_RAISE:
        raise ProgramLintError(diag)
    if mode == MODE_WARN:
        warnings.warn(str(diag), AnalysisWarning, stacklevel=3)
