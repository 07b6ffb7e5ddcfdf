"""Distance computations (counterpart of heat_tpu/spatial)."""

from .distance import *
