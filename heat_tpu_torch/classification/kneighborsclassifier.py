"""K-nearest-neighbours classifier (counterpart of
heat_tpu/classification/kneighborsclassifier.py).

``predict`` takes each query row's k nearest training rows from
``spatial.distance``'s fused top-k (the ring where the queries and the
training rows are split over the same ranks), sums their one-hot label
rows and votes by the first largest sum.  The training labels ride the
ring beside the training rows, so neither is gathered.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core import types
from ..core.base import BaseEstimator, ClassificationMixin
from ..core.dndarray import DNDarray
from ..spatial import distance

__all__ = ["KNeighborsClassifier", "one_hot_encoding"]


def one_hot_encoding(labels: DNDarray, num_classes: Optional[int] = None) -> DNDarray:
    """float32 one-hot rows of integer labels (floats truncated toward
    zero), split like the labels; ``num_classes`` is the largest label
    plus one by default (one max over the ranks).  A label outside
    ``[0, num_classes)`` gets a row of zeros."""
    cast = labels.astype(types.int32)
    if num_classes is None:
        own = cast.larray.max().reshape(1) if cast.larray.numel() else cast.larray.new_full((1,), -1)
        num_classes = int((cast.comm.pmax(own) if cast.is_distributed() else own)[0]) + 1
    local = cast.larray_padded
    rows = (local[:, None] == torch.arange(num_classes, dtype=local.dtype, device=local.device)).to(torch.float32)
    return cast._like(rows, (labels.shape[0], num_classes), labels.split)


class KNeighborsClassifier(BaseEstimator, ClassificationMixin):
    """Vote of the k nearest training rows."""

    def __init__(self, n_neighbors: int = 5):
        self.n_neighbors = n_neighbors
        self.x = None
        self.y = None

    def fit(self, x: DNDarray, y: DNDarray) -> "KNeighborsClassifier":
        """Keep the training rows and their labels (one-hot rows where y is
        1-D)."""
        if not isinstance(x, DNDarray) or not isinstance(y, DNDarray):
            raise TypeError("x and y need to be DNDarrays")
        self.x = x
        if y.ndim == 1:
            y = one_hot_encoding(y)
        self.y = y
        return self

    def predict(self, x: DNDarray) -> DNDarray:
        """The class of the largest vote of each row's ``n_neighbors``
        nearest training rows, the first on ties; int64, split like x."""
        if self.x is None:
            raise RuntimeError("fit needs to be called before predict")
        votes = distance._k_nearest(x, self.x, self.n_neighbors, self.y).rows.sum(1)
        return x._like(votes.argmax(1), (x.shape[0],), 0 if x.split is not None else None)
