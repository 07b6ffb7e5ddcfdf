"""Graph Laplacian (counterpart of heat_tpu/graph/laplacian.py).

The similarity matrix comes split along rows (or not split), and every step
stays on each rank's own rows: the threshold, the zeroed self-loops (each
rank finds its rows' diagonal from its row offset) and the degrees.  The
symmetric normalisation needs every node's degree beside a rank's own: one
all-gather of the n degrees, never of the matrix.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..core.dndarray import DNDarray

__all__ = ["Laplacian"]


class Laplacian:
    """Graph Laplacian of a pairwise similarity.

    definition: ``"simple"`` (L = D - A) or ``"norm_sym"`` (L = I - D^-1/2 A
    D^-1/2); mode: ``"fully_connected"`` or ``"eNeighbour"``, which keeps
    the similarities below (``threshold_key="upper"``) or above
    (``"lower"``) ``threshold_value``, as weights or as ones."""

    def __init__(
        self,
        similarity: Callable,
        weighted: bool = True,
        definition: str = "norm_sym",
        mode: str = "fully_connected",
        threshold_key: str = "upper",
        threshold_value: float = 1.0,
        neighbours: int = 10,
    ):
        self.similarity_metric = similarity
        self.weighted = weighted
        if definition not in ("simple", "norm_sym"):
            raise NotImplementedError("Only simple and normalized symmetric Laplacians are supported, got " + definition)
        if mode not in ("fully_connected", "eNeighbour"):
            raise NotImplementedError("Only eNeighborhood and fully-connected graphs are supported, got " + mode)
        if threshold_key not in ("upper", "lower"):
            raise ValueError(f"threshold_key must be 'upper' or 'lower', got {threshold_key}")
        self.definition = definition
        self.mode = mode
        self.epsilon = (threshold_key, threshold_value)
        self.neighbours = neighbours

    def construct(self, X: DNDarray) -> DNDarray:
        """Similarity, then adjacency, then the Laplacian, split like X."""
        S = self.similarity_metric(X)
        if S.split not in (None, 0):
            raise NotImplementedError(f"the similarity must be split along rows or not split, got split={S.split}")
        A = S.larray_padded
        n = S.shape[0]
        if self.mode == "eNeighbour":
            keep = A < self.epsilon[1] if self.epsilon[0] == "upper" else A > self.epsilon[1]
            A = torch.where(keep, A if self.weighted else torch.ones_like(A), 0.0)
        else:
            A = A.clone()
        # this rank's rows' diagonal: row i is node offset + i (padding rows have none)
        distributed = S.split == 0 and S.comm.size > 1
        offset = S.comm.chunk(S.shape, 0)[0] if distributed else 0
        rows = torch.arange(max(0, min(A.shape[0], n - offset)), device=A.device)
        diag = A[rows, offset + rows]
        A[rows, offset + rows] = diag - diag  # the self-loops zeroed as A - diag(diag(A))
        degree = torch.sum(A, dim=1)
        if self.definition == "norm_sym":
            scale = torch.where(degree > 0, 1.0 / torch.sqrt(torch.clamp(degree, min=1e-30)), 0.0)
            every = S.comm.all_gather(scale)[:n] if distributed else scale
            L = A.neg_().mul_(scale[:, None]).mul_(every[None, :])
            L[rows, offset + rows] += 1.0
        else:
            L = A.neg_()
            L[rows, offset + rows] += degree[rows]
        out = S._like(L, (n, n), S.split)
        return out if out.split == X.split else out.resplit(X.split)
