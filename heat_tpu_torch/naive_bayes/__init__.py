"""Naive Bayes estimators (counterpart of heat_tpu/naive_bayes)."""

from .gaussianNB import GaussianNB

__all__ = ["GaussianNB"]
