"""Matrix decomposition estimators (counterpart of heat_tpu/decomposition)."""

from .pca import PCA

__all__ = ["PCA"]
