"""Estimator base classes (counterpart of heat_tpu/core/base.py)."""

from __future__ import annotations

import inspect
import os
from typing import Dict, List, Optional

__all__ = [
    "BaseEstimator",
    "ClassificationMixin",
    "ClusteringMixin",
    "TransformMixin",
    "lazy_scalar_property",
    "low_precision_predict_requested",
]

_NATIVE_PREDICT = ("", "0", "off", "float32", "f32", "native")


def low_precision_predict_requested() -> bool:
    """True where ``HEAT_TPU_PREDICT_DTYPE`` asks predict and transform for a
    low-precision compute type (not ported yet: callers raise)."""
    return os.environ.get("HEAT_TPU_PREDICT_DTYPE", "").strip().lower() not in _NATIVE_PREDICT


def lazy_scalar_property(attr: str, kind: type = float, doc: Optional[str] = None) -> property:
    """Property that turns a stored device scalar into a host ``kind`` on
    first access and caches it, so a fit never waits on the device for it."""

    def fget(self):
        v = getattr(self, attr)
        if v is not None and not isinstance(v, kind):
            v = kind(v)
            setattr(self, attr, v)
        return v

    def fset(self, value):
        setattr(self, attr, value)

    return property(fget, fset, doc=doc or f"Lazy host {kind.__name__} of ``{attr}``.")


class BaseEstimator:
    """sklearn-style estimator base: parameters are the ``__init__`` arguments."""

    @classmethod
    def _parameter_names(cls) -> List[str]:
        init = cls.__init__
        if init is object.__init__:
            return []
        sig = inspect.signature(init)
        return [
            name
            for name, p in sig.parameters.items()
            if name != "self" and p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)
        ]

    def get_params(self, deep: bool = True) -> Dict:
        """Parameters of this estimator."""
        params = {}
        for key in self._parameter_names():
            value = getattr(self, key, None)
            if deep and hasattr(value, "get_params"):
                for sub_key, sub_value in value.get_params().items():
                    params[f"{key}__{sub_key}"] = sub_value
            params[key] = value
        return params

    def set_params(self, **params) -> "BaseEstimator":
        """Set estimator parameters."""
        if not params:
            return self
        valid = self.get_params(deep=True)
        for key, value in params.items():
            key, _, sub_key = key.partition("__")
            if key not in valid:
                raise ValueError(f"Invalid parameter {key} for estimator {self}.")
            if sub_key:
                valid[key].set_params(**{sub_key: value})
            else:
                setattr(self, key, value)
        return self

    def __repr__(self) -> str:
        params = ", ".join(f"{k}={v!r}" for k, v in self.get_params(deep=False).items())
        return f"{self.__class__.__name__}({params})"


class ClusteringMixin:
    """fit / fit_predict protocol of clusterers."""

    def fit(self, x):
        raise NotImplementedError()

    def fit_predict(self, x):
        self.fit(x)
        return self.predict(x)


class ClassificationMixin:
    """fit / predict protocol of classifiers."""

    def fit(self, x, y):
        raise NotImplementedError()

    def fit_predict(self, x, y):
        self.fit(x, y)
        return self.predict(x)

    def predict(self, x):
        raise NotImplementedError()


class TransformMixin:
    """fit / transform protocol of transformers."""

    def fit(self, x):
        raise NotImplementedError()

    def fit_transform(self, x):
        return self.fit(x).transform(x)

    def transform(self, x):
        raise NotImplementedError()
