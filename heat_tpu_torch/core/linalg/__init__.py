"""Linear algebra (counterpart of heat_tpu/core/linalg)."""

from .basics import *
from .qr import *
from .svd import *
from .svdtools import *
from .solver import *
from .extras import *
from . import factorizations
from . import svdtools
