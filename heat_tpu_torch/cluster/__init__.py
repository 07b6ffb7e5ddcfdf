"""Clustering estimators (counterpart of heat_tpu/cluster)."""

from ._kcluster import _KCluster
from .kmeans import KMeans
from .kmedians import KMedians
from .kmedoids import KMedoids

__all__ = ["KMeans", "KMedians", "KMedoids"]
