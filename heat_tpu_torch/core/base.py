"""Estimator base classes (counterpart of heat_tpu/core/base.py)."""

from __future__ import annotations

import inspect
import os
from typing import Dict, List, Optional

__all__ = [
    "BaseEstimator",
    "ClassificationMixin",
    "ClusteringMixin",
    "RegressionMixin",
    "TransformMixin",
    "is_classifier",
    "is_estimator",
    "is_clusterer",
    "is_regressor",
    "is_transformer",
    "lazy_scalar_property",
    "low_precision_predict_requested",
    "validate_resume_params",
]

_NATIVE_PREDICT = ("", "0", "off", "float32", "f32", "native")


def low_precision_predict_requested() -> bool:
    """True where ``HEAT_TPU_PREDICT_DTYPE`` asks predict and transform for a
    low-precision compute type (not ported yet: callers raise)."""
    return os.environ.get("HEAT_TPU_PREDICT_DTYPE", "").strip().lower() not in _NATIVE_PREDICT


def _sample_rows(x, *aligned):
    """``(rows, [entries], reduce)`` for an estimator's sums over samples:
    where x is split along its rows over several ranks, this rank's rows of
    x, each ``aligned`` array's entries (flattened) for those rows and the
    all-reduce of a sum; else the whole arrays and the identity.  An
    aligned None stays None."""
    if x.split == 0 and x.comm.size > 1:
        lo, rows = x.comm.chunk(x.shape, 0)[0], x.lshape[0]

        def mine(v):
            if v is None:
                return None
            if v.split == 0 and v.shape[0] == x.shape[0]:  # the same canonical rows
                return v.larray.reshape(-1)
            return v._dense().reshape(-1)[lo:lo + rows]

        return x.larray, [mine(v) for v in aligned], x.comm.psum
    return x._dense(), [None if v is None else v._dense().reshape(-1) for v in aligned], (lambda t: t)


def validate_resume_params(
    checkpoint_every: Optional[int],
    checkpoint_dir: Optional[str],
    resume_from: Optional[str],
) -> None:
    """The constructors' check of the resumable-fit parameters: any of them
    raises, since resumable fits are not ported yet (ROADMAP Queue 1 item
    15b)."""
    if checkpoint_every is not None or checkpoint_dir is not None or resume_from is not None:
        raise NotImplementedError("resumable fits (checkpoint_every, checkpoint_dir, resume_from) are not ported yet")


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


class RegressionMixin:
    """fit / predict protocol of regressors."""

    def fit(self, x, y):
        raise NotImplementedError()

    def fit_predict(self, x, y):
        self.fit(x, y)
        return self.predict(x)

    def predict(self, x):
        raise NotImplementedError()


def is_classifier(estimator) -> bool:
    """True for classifiers."""
    return isinstance(estimator, ClassificationMixin)


def is_estimator(estimator) -> bool:
    """True for estimators."""
    return isinstance(estimator, BaseEstimator)


def is_clusterer(estimator) -> bool:
    """True for clusterers."""
    return isinstance(estimator, ClusteringMixin)


def is_regressor(estimator) -> bool:
    """True for regressors."""
    return isinstance(estimator, RegressionMixin)


def is_transformer(estimator) -> bool:
    """True for transformers."""
    return isinstance(estimator, TransformMixin)
