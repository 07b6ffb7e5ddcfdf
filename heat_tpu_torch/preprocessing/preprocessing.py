"""Data scalers (counterpart of heat_tpu/preprocessing/preprocessing.py).

Each is a composition of the port's distributed operations over the
sample axis: ``mean``/``var`` (StandardScaler), ``min``/``max``
(MinMaxScaler, MaxAbsScaler), a norm of each row (Normalizer), and ``median``/``percentile`` along axis 0 (RobustScaler:
the columns sorted by the distributed sample sort, nothing gathered).
Fitted statistics are unsplit, on every rank.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..core import arithmetics, exponential, rounding, statistics, types
from ..core.base import BaseEstimator, TransformMixin
from ..core.dndarray import DNDarray

__all__ = ["StandardScaler", "MinMaxScaler", "Normalizer", "MaxAbsScaler", "RobustScaler"]


def _check_2d_float(x, name="X"):
    if not isinstance(x, DNDarray):
        raise TypeError(f"{name} must be a DNDarray, got {type(x)}")
    if not types.heat_type_is_inexact(x.dtype):
        return x.astype(types.float32)
    return x


def _unit_where_zero(v: DNDarray, unsplit: bool = True) -> DNDarray:
    """``v`` with its zeros replaced by 1 (a constant feature is left as it
    is), unsplit (or split as ``v``)."""
    if unsplit and v.split is not None:
        v = v.resplit(None)
    t = v.larray_padded
    return v._like(torch.where(t == 0, torch.ones_like(t), t), dtype=v.dtype)


class StandardScaler(BaseEstimator, TransformMixin):
    """Zero mean and unit variance per feature."""

    def __init__(self, copy: bool = True, with_mean: bool = True, with_std: bool = True):
        self.copy = copy
        self.with_mean = with_mean
        self.with_std = with_std
        self.mean_ = None
        self.var_ = None

    def fit(self, x: DNDarray, sample_weight=None) -> "StandardScaler":
        if sample_weight is not None:
            raise NotImplementedError("sample_weight is not yet supported")
        x = _check_2d_float(x)
        self.mean_ = statistics.mean(x, axis=0) if self.with_mean else None
        self.var_ = _unit_where_zero(statistics.var(x, axis=0), unsplit=False) if self.with_std else None
        return self

    def transform(self, x: DNDarray) -> DNDarray:
        x = _check_2d_float(x)
        if self.with_mean and self.mean_ is not None:
            x = x - self.mean_
        if self.with_std and self.var_ is not None:
            x = x / exponential.sqrt(self.var_)
        return x

    def inverse_transform(self, y: DNDarray) -> DNDarray:
        y = _check_2d_float(y, "Y")
        if self.with_std and self.var_ is not None:
            y = y * exponential.sqrt(self.var_)
        if self.with_mean and self.mean_ is not None:
            y = y + self.mean_
        return y


class MinMaxScaler(BaseEstimator, TransformMixin):
    """Each feature rescaled to ``feature_range``."""

    def __init__(self, feature_range: Tuple[float, float] = (0.0, 1.0), copy: bool = True, clip: bool = False):
        if feature_range[0] >= feature_range[1]:
            raise ValueError(f"Minimum of desired feature range must be smaller than maximum, got {feature_range}")
        self.feature_range = feature_range
        self.copy = copy
        self.clip = clip
        self.data_min_ = None
        self.data_max_ = None
        self.scale_ = None
        self.min_ = None

    def fit(self, x: DNDarray) -> "MinMaxScaler":
        x = _check_2d_float(x)
        self.data_min_ = statistics.min(x, axis=0)
        self.data_max_ = statistics.max(x, axis=0)
        lo, hi = self.feature_range
        self.scale_ = (hi - lo) / _unit_where_zero(self.data_max_ - self.data_min_)
        self.min_ = lo - self.data_min_.resplit(None) * self.scale_
        return self

    def transform(self, x: DNDarray) -> DNDarray:
        x = _check_2d_float(x)
        y = x * self.scale_ + self.min_
        if self.clip:
            y = rounding.clip(y, self.feature_range[0], self.feature_range[1])
        return y

    def inverse_transform(self, y: DNDarray) -> DNDarray:
        y = _check_2d_float(y, "Y")
        return (y - self.min_) / self.scale_


class Normalizer(BaseEstimator, TransformMixin):
    """Each sample scaled to unit norm ("l1", "l2" or "max"), split as the
    input."""

    def __init__(self, norm: str = "l2", copy: bool = True):
        if norm not in ("l1", "l2", "max"):
            raise NotImplementedError(f"norm must be 'l1', 'l2' or 'max', got {norm!r}")
        self.norm = norm
        self.copy = copy

    def fit(self, x: DNDarray) -> "Normalizer":
        return self  # stateless

    def transform(self, x: DNDarray) -> DNDarray:
        x = _check_2d_float(x)
        if self.norm == "l2":
            n = exponential.sqrt(arithmetics.sum(x * x, axis=1, keepdims=True))
        elif self.norm == "l1":
            n = arithmetics.sum(rounding.abs(x), axis=1, keepdims=True)
        else:
            n = statistics.max(rounding.abs(x), axis=1, keepdims=True)
        t = n.larray_padded
        return x / n._like(torch.where(t == 0, torch.ones_like(t), t), dtype=n.dtype)


class MaxAbsScaler(BaseEstimator, TransformMixin):
    """Each feature divided by its largest absolute value."""

    def __init__(self, copy: bool = True):
        self.copy = copy
        self.max_abs_ = None
        self.scale_ = None

    def fit(self, x: DNDarray) -> "MaxAbsScaler":
        x = _check_2d_float(x)
        self.max_abs_ = statistics.max(rounding.abs(x), axis=0)
        self.scale_ = _unit_where_zero(self.max_abs_)
        return self

    def transform(self, x: DNDarray) -> DNDarray:
        return _check_2d_float(x) / self.scale_

    def inverse_transform(self, y: DNDarray) -> DNDarray:
        return _check_2d_float(y, "Y") * self.scale_


class RobustScaler(BaseEstimator, TransformMixin):
    """Centring on the median and scaling by the interquartile range
    (``quantile_range``) per feature."""

    def __init__(self, quantile_range: Tuple[float, float] = (25.0, 75.0), copy: bool = True,
                 with_centering: bool = True, with_scaling: bool = True, unit_variance: bool = False):
        if unit_variance:
            raise NotImplementedError("unit_variance is not yet supported")
        lo, hi = quantile_range
        if not 0 <= lo <= hi <= 100:
            raise ValueError(f"Invalid quantile range: {quantile_range}")
        self.quantile_range = quantile_range
        self.copy = copy
        self.with_centering = with_centering
        self.with_scaling = with_scaling
        self.unit_variance = unit_variance
        self.center_ = None
        self.iqr_ = None

    def fit(self, x: DNDarray) -> "RobustScaler":
        x = _check_2d_float(x)
        if self.with_centering:
            self.center_ = statistics.median(x, axis=0)
        if self.with_scaling:
            lo, hi = self.quantile_range
            q = statistics.percentile(x, [lo, hi], axis=0)
            self.iqr_ = _unit_where_zero(q[1] - q[0])
        return self

    def transform(self, x: DNDarray) -> DNDarray:
        x = _check_2d_float(x)
        if self.with_centering and self.center_ is not None:
            x = x - self.center_
        if self.with_scaling and self.iqr_ is not None:
            x = x / self.iqr_
        return x

    def inverse_transform(self, y: DNDarray) -> DNDarray:
        y = _check_2d_float(y, "Y")
        if self.with_scaling and self.iqr_ is not None:
            y = y * self.iqr_
        if self.with_centering and self.center_ is not None:
            y = y + self.center_
        return y
