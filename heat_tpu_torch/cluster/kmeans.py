"""KMeans (counterpart of heat_tpu/cluster/kmeans.py).

Every Lloyd iteration, and the final assignment, is one launch of the fused
Lloyd kernel (:func:`heat_tpu_torch.core.kernels.lloyd_update`) on each
rank's chunk of the points, followed by one all-reduce of the small partial
sums.  The loop runs on the host and reads the centre shift once per
iteration to test convergence, as the JAX package's kernel path does.  With
``checkpoint_every`` / ``resume_from`` the same sequence of launches runs in
checkpointed chunks (``_KCluster._fit_centers``).  Each of those launches
counts one ``dispatch.external_dispatches`` (the reference counts one for
its whole on-device fit loop) and is noted by the roofline observatory
under one key with the kernel's cost (``dispatch.kernel_launch``).
"""

from __future__ import annotations

from typing import Optional, Union

from ..core import dispatch, kernels, types
from ..core.base import low_precision_predict_requested
from ..core.dndarray import DNDarray
from ..spatial import distance
from ._kcluster import _KCluster

__all__ = ["KMeans"]


class KMeans(_KCluster):
    """K-Means with Lloyd iterations."""

    def __init__(
        self,
        n_clusters: int = 8,
        init: Union[str, DNDarray] = "random",
        max_iter: int = 300,
        tol: float = 1e-4,
        random_state: Optional[int] = None,
        checkpoint_every: Optional[int] = None,
        checkpoint_dir: Optional[str] = None,
        resume_from: Optional[str] = None,
    ):
        if max_iter < 1:
            raise ValueError(f"max_iter must be >= 1, got {max_iter}")
        if isinstance(init, str) and init == "kmeans++":
            init = "probability_based"
        super().__init__(
            metric=lambda x, y: distance.cdist(x, y, quadratic_expansion=True),
            n_clusters=n_clusters,
            init=init,
            max_iter=max_iter,
            tol=tol,
            random_state=random_state,
            checkpoint_every=checkpoint_every,
            checkpoint_dir=checkpoint_dir,
            resume_from=resume_from,
        )

    def fit(self, x: DNDarray) -> "KMeans":
        """Lloyd iterations until the centre shift is at most ``tol``, then
        one assignment pass for ``labels_`` and ``inertia_``."""
        if not isinstance(x, DNDarray):
            raise ValueError(f"input needs to be a DNDarray, but was {type(x)}")
        if x.ndim != 2:
            raise ValueError(f"input needs to be 2D, but was {x.ndim}D")
        if not types.heat_type_is_inexact(x.dtype):
            x = x.astype(types.float32)

        key = kernels.lloyd_launch_cost(x, self.n_clusters)

        def run(centers, n):
            shift = float("inf")
            for i in range(n):
                # one launch per Lloyd step
                centers, shift_t, _ = dispatch.kernel_launch(*key, lambda: kernels.lloyd_update(x, centers))
                shift = float(shift_t)
                if shift <= self.tol:
                    return centers, i + 1, shift
            return centers, n, shift

        centers, self._n_iter = self._fit_centers(x, run, "kmeans.iter")
        self._cluster_centers = DNDarray.from_dense(centers, None, x.device, x.comm)
        # final assignment against the converged centres: labels and
        # inertia from the same kernel, its new centres unused
        _, _, inertia, labels = dispatch.kernel_launch(*kernels.lloyd_launch_cost(x, self.n_clusters, labels=True),
                                                       lambda: kernels.lloyd_update(x, centers, labels=True))
        self._inertia = inertia
        self._labels = x._like(labels, (x.shape[0],), x.split)
        return self

    def predict(self, x: DNDarray) -> DNDarray:
        """Nearest learned centre for each sample, in native float32.  The
        low-precision predict scope (``HEAT_TPU_PREDICT_DTYPE``), which the
        reference gives KMeans alone, is not ported yet and raises."""
        if isinstance(x, DNDarray) and low_precision_predict_requested():
            raise NotImplementedError("low-precision predict (HEAT_TPU_PREDICT_DTYPE) is not ported yet")
        return super().predict(x)
