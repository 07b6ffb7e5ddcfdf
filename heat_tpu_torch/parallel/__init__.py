"""Communication layer (counterpart of heat_tpu/parallel)."""

from .comm import *
