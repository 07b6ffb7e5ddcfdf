"""Fitted state and results carried over from the JAX package.

:func:`from_reference_state` takes the document that heat_tpu's
``serving.model_io.export_state`` writes, ``{"kind", "params", "state"}``,
with its array leaves already turned into numpy arrays, and returns the
port's fitted estimator, ready to ``predict`` (KMeans, KMedians, KMedoids,
KNeighborsClassifier) or ``transform`` (PCA).  :func:`from_reference_array` takes a result of heat_tpu (for example
a spectrum, which heat_tpu may hold as two real planes) as numpy and returns
the port's DNDarray of it, complex where it is complex.
:func:`params_from_reference` takes a flax parameter tree of the JAX
package's data-parallel models and returns a ``torch.nn.Module``'s
parameters by name.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .classification import KNeighborsClassifier
from .cluster import KMeans, KMedians, KMedoids
from .core import factories
from .decomposition import PCA

__all__ = ["from_reference_array", "from_reference_state", "params_from_reference"]


def from_reference_array(value, split=None, device=None, comm=None):
    """The port's DNDarray of a reference result given as numpy: one array
    (real or complex), or an ``(re, im)`` pair of real planes, which becomes
    one complex array (complex64 from float32 planes, else complex128)."""
    if isinstance(value, tuple):
        if len(value) != 2:
            raise ValueError(f"planes come as (re, im), got {len(value)} arrays")
        re, im = (np.asarray(v) for v in value)
        if re.shape != im.shape or re.dtype != im.dtype or re.dtype.kind != "f":
            raise ValueError(f"planes must be real and alike, got {re.dtype}{re.shape} and {im.dtype}{im.shape}")
        value = np.empty(re.shape, np.complex64 if re.dtype == np.float32 else np.complex128)
        value.real, value.imag = re, im
    return factories.array(np.asarray(value), split=split, device=device, comm=comm)


def _kcluster_state(est, state: Dict[str, Any], device, comm) -> None:
    est._cluster_centers = factories.array(np.asarray(state["cluster_centers"]), device=device, comm=comm)


def _knn_state(est: KNeighborsClassifier, state: Dict[str, Any], device, comm) -> None:
    est.x = factories.array(np.asarray(state["x"]), device=device, comm=comm)
    est.y = factories.array(np.asarray(state["y"]), device=device, comm=comm)


_PCA_ARRAYS = {
    "mean_": "mean",
    "components_": "components",
    "singular_values_": "singular_values",
    "explained_variance_": "explained_variance",
    "explained_variance_ratio_": "explained_variance_ratio",
}


def _pca_state(est: PCA, state: Dict[str, Any], device, comm) -> None:
    for attr, key in _PCA_ARRAYS.items():
        setattr(est, attr, factories.array(np.asarray(state[key]), device=device, comm=comm))
    est._tevr = float(state["tevr"])
    est.n_components_ = int(state["n_components"])


_KINDS = {
    "KMeans": (KMeans, _kcluster_state),
    "KMedians": (KMedians, _kcluster_state),
    "KMedoids": (KMedoids, _kcluster_state),
    "KNeighborsClassifier": (KNeighborsClassifier, _knn_state),
    "PCA": (PCA, _pca_state),
}


def from_reference_state(doc: Dict[str, Any], device=None, comm=None):
    """A fitted port estimator from a heat_tpu model document (KMeans,
    KMedians, KMedoids, KNeighborsClassifier or PCA)."""
    try:
        kind, params, state = doc["kind"], doc["params"], doc["state"]
    except (TypeError, KeyError):
        raise ValueError("not a model document: it needs kind, params and state") from None
    if kind not in _KINDS:
        raise NotImplementedError(f"carrying over a fitted {kind} is not ported yet; supported: {sorted(_KINDS)}")
    cls, restore = _KINDS[kind]
    est = cls(**params)
    restore(est, state, device, comm)
    return est


_FLAX_LEAVES = {"kernel": "weight", "bias": "bias"}


def params_from_reference(params: Dict[str, Any], module: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """``module``'s parameters by name (as ``DataParallel.set_params`` takes
    them) from a flax parameter tree with numpy leaves, ``{"params": {layer:
    {"kernel", "bias"}}}`` or its inner dict.

    The tree's layers, in their order (the order flax made them), go to
    ``module``'s layers that hold parameters, in theirs.  A kernel's two
    last axes (in, out) become torch's two first (out, in): a Dense kernel
    (in, out) becomes (out, in), a Conv kernel (H, W, in, out) becomes (out,
    in, H, W); biases are taken as they are.  flax
    convolves NHWC and flattens in (H, W, C) order, so a module that
    flattens a convolution's output for a Dense layer must flatten in that
    order too (NHWC), for the Dense kernel to meet its inputs in place."""
    tree = params.get("params", params)
    layers = [(name, m) for name, m in module.named_modules() if any(True for _ in m.parameters(recurse=False))]
    if len(tree) != len(layers):
        raise ValueError(f"the tree has {len(tree)} layers ({list(tree)}), the module {len(layers)} "
                         f"({[name for name, _ in layers]})")
    own = dict(module.named_parameters())
    out: Dict[str, torch.Tensor] = {}
    for (ref_name, leaves), (name, _) in zip(tree.items(), layers):
        for key, value in leaves.items():
            if key not in _FLAX_LEAVES:
                raise ValueError(f"{ref_name}: no counterpart for the flax parameter {key!r}")
            a = np.asarray(value)
            if key == "kernel":
                a = np.moveaxis(a, (-1, -2), (0, 1))
            target = f"{name}.{_FLAX_LEAVES[key]}" if name else _FLAX_LEAVES[key]
            if target not in own or tuple(own[target].shape) != a.shape:
                want = tuple(own[target].shape) if target in own else "no such parameter"
                raise ValueError(f"{ref_name}.{key} of shape {a.shape} does not fit {target}: {want}")
            out[target] = torch.tensor(a)
    return {name: out[name] for name in own if name in out}
