"""Utilities (counterpart of heat_tpu/utils): so far the data helpers of
:mod:`.data` that the data-parallel training path needs."""

from . import data

__all__ = ["data"]
