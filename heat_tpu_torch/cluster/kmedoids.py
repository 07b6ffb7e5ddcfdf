"""KMedoids (counterpart of heat_tpu/cluster/kmedoids.py).

Each iteration labels the points by their nearest centre in city-block
distance, takes each centre's members' mean (the old centre where it has
none) and moves the centre to the member row nearest that mean in
city-block distance (any row where it has no members), the first global
row on ties.  It stops when no centre moves or after ``max_iter``
iterations.

No point is gathered: the means are one psum of the members' sums and
counts, the nearest row a local argmin, a pmin of its distance and a pmin
of the global index among the ranks that hold that distance, and the row
itself comes as ``_global_rows`` fetches rows (one psum).
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from ..core.dndarray import DNDarray
from ..spatial import distance
from ._kcluster import _KCluster, _fit_input, _global_rows, _members

__all__ = ["KMedoids"]


def _medoids(x: DNDarray, centers: torch.Tensor) -> torch.Tensor:
    """One KMedoids update of ``centers`` (k, f) on x."""
    members, counts, reduce = _members(x, centers)
    local = x.larray
    sums = reduce(torch.stack([torch.where(m[:, None], local, 0.0).sum(0) for m in members]))
    means = torch.where(counts[:, None] > 0, sums / counts.clamp(min=1)[:, None], centers)
    d = distance._pairwise("manhattan", local, means)
    d.masked_fill_(~(members.T | (counts == 0)[None, :]), float("inf"))
    n, comm = x.shape[0], x.comm
    offset = comm.chunk(x.shape, 0)[0] if x.is_distributed() else 0
    if local.shape[0]:
        idx = d.argmin(0)
        best = d.gather(0, idx[None, :])[0]
        idx += offset
    else:
        best = torch.full((centers.shape[0],), float("inf"), dtype=d.dtype, device=d.device)
        idx = torch.full_like(best, n, dtype=torch.int64)
    if x.is_distributed():
        least = comm.pmin(best.clone())
        idx = comm.pmin(torch.where(best == least, idx, n))
    return _global_rows(x, idx).to(centers.dtype)


class KMedoids(_KCluster):
    """K-Medoids with city-block assignment: centres are rows of the data."""

    def __init__(
        self,
        n_clusters: int = 8,
        init: Union[str, DNDarray] = "random",
        max_iter: int = 300,
        random_state: Optional[int] = None,
        checkpoint_every: Optional[int] = None,
        checkpoint_dir: Optional[str] = None,
        resume_from: Optional[str] = None,
    ):
        if isinstance(init, str) and init == "kmedoids++":
            init = "probability_based"
        super().__init__(
            metric=lambda x, y: distance.manhattan(x, y),
            n_clusters=n_clusters,
            init=init,
            max_iter=max_iter,
            tol=0.0,
            random_state=random_state,
            checkpoint_every=checkpoint_every,
            checkpoint_dir=checkpoint_dir,
            resume_from=resume_from,
        )

    def fit(self, x: DNDarray) -> "KMedoids":
        """Medoid updates until no centre moves, at most ``max_iter``; then
        one assignment for ``labels_`` and ``inertia_``.  One host read of
        the shift an iteration."""
        x = _fit_input(x)

        def run(centers, n):
            i, shift = 0, float("inf")
            while i < n and shift > 0.0:
                new = _medoids(x, centers)
                shift = float(torch.sum(torch.abs(new - centers)).to(torch.float32))
                centers, i = new, i + 1
            return centers, i, shift

        centers, self._n_iter = self._fit_centers(x, run, "kmedoids.iter")
        self._cluster_centers = DNDarray.from_dense(centers, None, x.device, x.comm)
        self._labels = self._assign_to_cluster(x, eval_functional_value=True)
        return self
