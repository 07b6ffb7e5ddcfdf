"""Graph analysis (counterpart of heat_tpu/graph)."""

from .laplacian import *
