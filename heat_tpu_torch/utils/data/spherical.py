"""Synthetic clustered data (counterpart of heat_tpu/utils/data/spherical.py).

Both generators draw from ``ht.random`` (the reference's draws, bitwise)
after seeding it with ``random_state``, and scale and shift the draws in
the reference's order and types, so a seed gives the reference's points.
"""

from __future__ import annotations

import numpy as np
import torch

from ...core import factories, types
from ...core import random as ht_random
from ...core.devices import sanitize_device
from ...core.dndarray import DNDarray
from ...core.linalg.basics import full_f32_matmul

__all__ = ["create_spherical_dataset", "create_clusters"]


def create_spherical_dataset(
    num_samples_cluster: int,
    radius: float = 1.0,
    offset: float = 4.0,
    dtype=types.float32,
    random_state: int = 1,
    device=None,
) -> DNDarray:
    """Four Gaussian clusters of ``num_samples_cluster`` points each, of
    standard deviation ``radius`` in 3 dimensions, centred at ``+-offset``
    on the diagonals; split=0."""
    ht_random.seed(random_state)
    dtype = types.canonical_heat_type(dtype)
    device = sanitize_device(device)
    o = offset
    centers = torch.tensor([[-o, -o, -o], [-o, o, -o], [o, -o, o], [o, o, o]], dtype=dtype.torch_type(),
                           device=device.torch_device)
    parts = [ht_random.randn(num_samples_cluster, 3, dtype=dtype, device=device).larray * radius + centers[c]
             for c in range(4)]
    return factories.array(torch.cat(parts), split=0, device=device)


def _promoted(a: torch.Tensor, b: torch.Tensor):
    """Both operands in their common type (the reference promotes a 0-d
    operand like any other)."""
    common = torch.promote_types(a.dtype, b.dtype)
    return a.to(common), b.to(common)


def _as_tensor(value, device) -> torch.Tensor:
    if isinstance(value, DNDarray):
        return value._dense().to(device)
    return torch.as_tensor(np.asarray(value), device=device)


def create_clusters(
    n_samples: int,
    n_features: int,
    n_clusters: int,
    cluster_mean,
    cluster_std,
    cluster_weight=None,
    device=None,
    random_state: int = 1,
) -> DNDarray:
    """Gaussian clusters of the given means (k, f) and standard deviations
    (one per cluster, one per feature, or an (f, f) matrix that multiplies
    the draws), ``n_samples`` in all, shared evenly or by
    ``cluster_weight`` (the last cluster takes what rounding leaves);
    split=0."""
    ht_random.seed(random_state)
    device = sanitize_device(device)
    means = _as_tensor(cluster_mean, device.torch_device)
    stds = _as_tensor(cluster_std, device.torch_device)
    if cluster_weight is None:
        counts = [n_samples // n_clusters] * n_clusters
    else:
        w = np.asarray(cluster_weight, dtype=np.float64)
        counts = (w / w.sum() * n_samples).astype(int).tolist()
    counts[-1] += n_samples - sum(counts)
    parts = []
    for c in range(n_clusters):
        pts, std = _promoted(ht_random.randn(counts[c], n_features, device=device).larray, stds[c])
        if std.ndim == 2:
            with full_f32_matmul():
                pts = pts @ std
        else:
            pts = pts * std
        pts, mean = _promoted(pts, means[c])
        parts.append(pts + mean)
    return factories.array(torch.cat(parts), split=0, device=device)
