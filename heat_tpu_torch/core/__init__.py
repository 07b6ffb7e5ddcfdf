"""Core namespace assembly (counterpart of heat_tpu/core/__init__.py)."""

from .devices import *
from .types import *
from .dndarray import *
from .factories import *
from .stride_tricks import *
from .base import *
from .arithmetics import *
from .statistics import *
from .relational import *
from .logical import *
from .indexing import *
from .printing import *
from .constants import *
from . import devices
from . import types
from . import random
from . import sanitation
from . import logical
from . import indexing
from . import printing
from . import constants
from . import kernels
from . import linalg
from .linalg import *
