"""heat_tpu_torch: the PyTorch/CUDA port of heat_tpu.

It keeps heat_tpu's names and module layout, so code written against
heat_tpu's ``ht.*`` surface reads the same with ``heat_tpu_torch as ht``, and
runs on torch tensors, one rank per CUDA card over ``torch.distributed``.  Entry points run on the card unless
the caller asks for the CPU (``device="cpu"`` or ``use_device("cpu")``).
This package imports nothing of JAX or of heat_tpu.
"""

from .version import __version__

from . import parallel
from .parallel import Communication, SELF, WORLD, get_comm, sanitize_comm, use_comm

from . import core
from .core import *
from .core import devices, io, kernels, linalg, random, types

from . import spatial
from . import cluster
from . import classification
from . import naive_bayes
from . import regression
from . import graph
from . import decomposition
from . import preprocessing
from . import fft
from . import sparse
from . import nn
from . import optim
from . import utils
from . import interop
from . import datasets
from . import analysis
from . import resilience
from . import telemetry

communication = parallel  # the reference's alias of parallel
