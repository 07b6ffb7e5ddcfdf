"""Utilities (counterpart of heat_tpu/utils): the data tooling of
:mod:`.data`, the image transforms of :mod:`.vision_transforms`, and
checkpoint/resume (:mod:`.checkpoint`) with its background writer
(:mod:`.overlap`), and the profiling hooks (:mod:`.profiling`, an alias of
``telemetry.profiling``)."""

from . import checkpoint
from . import data
from . import overlap
from . import profiling
from . import vision_transforms

__all__ = ["checkpoint", "data", "overlap", "profiling", "vision_transforms"]
