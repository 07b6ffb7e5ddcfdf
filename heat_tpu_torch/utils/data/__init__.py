"""Data helpers (counterpart of heat_tpu/utils/data): so far
:func:`synthetic_mnist` and the clustered data of :mod:`.spherical`.  The
rest of heat_tpu/utils/data waits (ROADMAP queue 1, item 14)."""

from . import spherical
from .mnist import synthetic_mnist
from .spherical import create_clusters, create_spherical_dataset

__all__ = ["create_clusters", "create_spherical_dataset", "spherical", "synthetic_mnist"]
