"""Utilities (counterpart of heat_tpu/utils): the data tooling of
:mod:`.data` and the image transforms of :mod:`.vision_transforms`."""

from . import data, vision_transforms

__all__ = ["data", "vision_transforms"]
