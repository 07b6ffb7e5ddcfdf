"""Linear algebra (counterpart of heat_tpu/core/linalg)."""

from .basics import *
from .svdtools import *
from . import svdtools
