"""Fitted state carried over from the JAX package.

:func:`from_reference_state` takes the document that heat_tpu's
``serving.model_io.export_state`` writes, ``{"kind", "params", "state"}``,
with its array leaves already turned into numpy arrays, and returns the
port's fitted estimator, ready to ``predict``.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from .cluster import KMeans
from .core import factories

__all__ = ["from_reference_state"]

_KINDS = {"KMeans": KMeans}


def from_reference_state(doc: Dict[str, Any], device=None, comm=None):
    """A fitted port estimator from a heat_tpu model document (KMeans only)."""
    try:
        kind, params, state = doc["kind"], doc["params"], doc["state"]
    except (TypeError, KeyError):
        raise ValueError("not a model document: it needs kind, params and state") from None
    if kind not in _KINDS:
        raise NotImplementedError(f"carrying over a fitted {kind} is not ported yet; supported: {sorted(_KINDS)}")
    est = _KINDS[kind](**params)
    centers = np.asarray(state["cluster_centers"])
    est._cluster_centers = factories.array(centers, device=device, comm=comm)
    return est
