"""Clustering estimators (counterpart of heat_tpu/cluster)."""

from ._kcluster import _KCluster
from .kmeans import KMeans
from .kmedians import KMedians
from .kmedoids import KMedoids
from .spectral import Spectral
from .batchparallelclustering import BatchParallelKMeans, BatchParallelKMedians

__all__ = ["KMeans", "KMedians", "KMedoids", "Spectral", "BatchParallelKMeans", "BatchParallelKMedians"]
