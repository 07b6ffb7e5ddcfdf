"""Alias of :mod:`heat_tpu_torch.telemetry.profiling` (counterpart of
heat_tpu/utils/profiling.py): every public name is re-exported here so
``heat_tpu_torch.utils.profiling`` imports work as the reference's do.
"""

from __future__ import annotations

from ..telemetry.profiling import (  # noqa: F401
    annotate,
    monitor,
    start_trace,
    stop_trace,
    trace,
)

__all__ = ["annotate", "monitor", "start_trace", "stop_trace", "trace"]
