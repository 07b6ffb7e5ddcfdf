"""Utilities (counterpart of heat_tpu/utils): the data tooling of
:mod:`.data`, the image transforms of :mod:`.vision_transforms`, and
checkpoint/resume (:mod:`.checkpoint`) with its background writer
(:mod:`.overlap`)."""

from . import checkpoint
from . import data
from . import overlap
from . import vision_transforms

__all__ = ["checkpoint", "data", "overlap", "vision_transforms"]
