"""Fitted state and results carried over from the JAX package.

:func:`from_reference_state` takes the document that heat_tpu's
``serving.model_io.export_state`` writes, ``{"kind", "params", "state"}``,
with its array leaves already turned into numpy arrays, and returns the
port's fitted estimator, ready to ``predict`` (KMeans, KMedians, KMedoids,
KNeighborsClassifier, Lasso, whose state is ``theta``) or ``transform``
(PCA).  The five scalers, GaussianNB and the two batch-parallel clusterers,
which that writer does not take, come as documents of the same form whose
state is their fitted attributes by name (``mean_``, ``var_``, ``scale_``
...; ``classes_``, ``theta_``, ``class_count_`` ...; ``cluster_centers``).
:func:`from_reference_array` takes a result of heat_tpu (for example
a spectrum, which heat_tpu may hold as two real planes) as numpy and returns
the port's DNDarray of it, complex where it is complex.
:func:`params_from_reference` takes a flax parameter tree of the JAX
package's data-parallel models and returns a ``torch.nn.Module``'s
parameters by name.  :func:`from_reference_sparse` takes a heat_tpu DCSR or
DCSC matrix as its global ``indptr``, ``indices`` and ``data`` and returns
the port's sparse matrix of it, stored zeros kept.
A ``DASO`` document (``{"kind": "DASO", "params": the constructor's
keywords, "state": DASO.get_state(), "replicas": the stacked per-node
parameter tree}``, replicas optional) gives the port's DASO on ``comm`` with
that schedule state, and sets ``module``'s parameters from node
``rank // per_node``'s replica.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .classification import KNeighborsClassifier
from .cluster import BatchParallelKMeans, BatchParallelKMedians, KMeans, KMedians, KMedoids
from .core import factories
from .decomposition import PCA
from .naive_bayes import GaussianNB
from .preprocessing import MaxAbsScaler, MinMaxScaler, Normalizer, RobustScaler, StandardScaler
from .regression import Lasso

__all__ = ["from_reference_array", "from_reference_sparse", "from_reference_state", "params_from_reference"]


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


def from_reference_sparse(indptr, indices, data, shape, format: str = "csr", split=None, device=None, comm=None):
    """The port's DCSR (``format="csr"``) or DCSC (``"csc"``) matrix of a
    reference matrix given as numpy: its global ``indptr``, ``indices`` and
    ``data`` (``A.indptr``, ``A.indices``, ``A.data``), its shape and its
    split.  Every stored entry is kept, explicit zeros included."""
    import scipy.sparse as sp

    from . import sparse

    triplet = (np.asarray(data), np.asarray(indices), np.asarray(indptr))
    if format == "csr":
        return sparse.sparse_csr_matrix(sp.csr_matrix(triplet, shape=tuple(shape)), split=split, device=device,
                                        comm=comm)
    if format == "csc":
        return sparse.sparse_csc_matrix(sp.csc_matrix(triplet, shape=tuple(shape)), split=split, device=device,
                                        comm=comm)
    raise ValueError(f"format must be 'csr' or 'csc', got {format!r}")


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


_SCALER_ARRAYS = {
    "StandardScaler": ("mean_", "var_"),
    "MinMaxScaler": ("data_min_", "data_max_", "scale_", "min_"),
    "Normalizer": (),
    "MaxAbsScaler": ("max_abs_", "scale_"),
    "RobustScaler": ("center_", "iqr_"),
}


def _scaler_state(est, state: Dict[str, Any], device, comm) -> None:
    for attr in _SCALER_ARRAYS[type(est).__name__]:
        value = state.get(attr)
        setattr(est, attr, None if value is None else factories.array(np.asarray(value), device=device, comm=comm))


_GNB_ARRAYS = ("classes_", "theta_", "var_", "class_count_", "class_prior_")


def _gnb_state(est: GaussianNB, state: Dict[str, Any], device, comm) -> None:
    for attr in _GNB_ARRAYS:
        setattr(est, attr, factories.array(np.asarray(state[attr]), device=device, comm=comm))
    est._epsilon = est._eps_applied = torch.tensor(float(state["epsilon_"]), dtype=est.var_.larray.dtype,
                                                   device=est.var_.larray.device)


def _lasso_state(est: Lasso, state: Dict[str, Any], device, comm) -> None:
    est._theta = factories.array(np.asarray(state["theta"]).reshape(-1, 1), device=device, comm=comm)


_KINDS = {
    "KMeans": (KMeans, _kcluster_state),
    "KMedians": (KMedians, _kcluster_state),
    "KMedoids": (KMedoids, _kcluster_state),
    "KNeighborsClassifier": (KNeighborsClassifier, _knn_state),
    "PCA": (PCA, _pca_state),
    "Lasso": (Lasso, _lasso_state),
    "GaussianNB": (GaussianNB, _gnb_state),
    "BatchParallelKMeans": (BatchParallelKMeans, _kcluster_state),
    "BatchParallelKMedians": (BatchParallelKMedians, _kcluster_state),
    **{cls.__name__: (cls, _scaler_state)
       for cls in (StandardScaler, MinMaxScaler, Normalizer, MaxAbsScaler, RobustScaler)},
}


def _daso_state(doc: Dict[str, Any], comm, optimizer, module):
    """The port's DASO from a heat_tpu DASO document; ``module`` takes this
    rank's node's slice of the stacked replicas where they are given."""
    from .optim import DASO

    if optimizer is None:
        raise ValueError("a DASO document needs the local optimizer (a torch.optim.Optimizer over the module)")
    daso = DASO(optimizer, comm=comm, **doc["params"])
    daso.set_state(doc["state"])
    replicas = doc.get("replicas")
    if replicas is not None:
        if module is None:
            raise ValueError("stacked replicas need the module that takes them")
        node = daso.comm.rank // daso.comm.node_size if daso.hierarchical else 0
        mine = _tree_map(lambda leaf: np.asarray(leaf)[node], replicas)
        with torch.no_grad():
            own = dict(module.named_parameters())
            for name, value in params_from_reference(mine, module).items():
                own[name].copy_(value)
    return daso


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def from_reference_state(doc: Dict[str, Any], device=None, comm=None, optimizer=None, module=None):
    """A fitted port estimator from a heat_tpu model document (KMeans,
    KMedians, KMedoids, KNeighborsClassifier, PCA, Lasso, GaussianNB, the
    batch-parallel clusterers or one of the scalers), or the port's DASO
    from a DASO document (``optimizer`` and ``module`` are the local
    optimizer and the model it trains)."""
    try:
        kind, params, state = doc["kind"], doc["params"], doc["state"]
    except (TypeError, KeyError):
        raise ValueError("not a model document: it needs kind, params and state") from None
    if kind == "DASO":
        return _daso_state(doc, comm, optimizer, module)
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
