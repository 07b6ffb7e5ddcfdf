"""Classification estimators (counterpart of heat_tpu/classification)."""

from .kneighborsclassifier import KNeighborsClassifier, one_hot_encoding

__all__ = ["KNeighborsClassifier", "one_hot_encoding"]
