"""Regression estimators (counterpart of heat_tpu/regression)."""

from .lasso import Lasso

__all__ = ["Lasso"]
