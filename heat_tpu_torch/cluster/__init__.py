"""Clustering estimators (counterpart of heat_tpu/cluster)."""

from ._kcluster import _KCluster
from .kmeans import KMeans

__all__ = ["KMeans"]
