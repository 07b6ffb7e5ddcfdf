"""Pairwise distances (counterpart of heat_tpu/spatial/distance.py).

Every function takes X split along rows (0) or not split, and returns its
rows of the result split like X.  Where X is split 0 over more than one rank
and Y is None or split 0 on the same comm, the distances run on a ring: X's
padded row block stands still and Y's block moves one rank down by
``comm.ppermute`` after every round, so no rank holds more of Y than one
block (:func:`_ring_schedule`).  With Y None each off-diagonal tile is
computed once and its transpose sent to the mirror owner.  Otherwise each
rank computes its own rows of X against the whole of Y, gathering Y only
where Y is split (as the reference's ``_dense()`` does); X is never
gathered.

The broadcast forms (the direct euclidean and the city-block tile) run in
blocks whose (f, rows, cols) intermediate stays within
:data:`_BLOCK_ELEMENTS`, so no call needs more than its result and one
block.  The expanded form's largest temporary is its result.

:func:`cdist_topk` fuses the distances with a running k-smallest merge over
Y's blocks, in the ring's visit order: its ties are those of
``jax.lax.top_k`` in the reference's ring (the candidate seen first wins).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from ..core import types
from ..core.base import low_precision_predict_requested
from ..core.dndarray import DNDarray
from ..core.linalg.basics import full_f32_matmul
from ..core.sanitation import sanitize_in

__all__ = ["cdist", "cdist_small", "cdist_topk", "manhattan", "rbf"]

# elements of one block's (f, rows, cols) intermediate in the broadcast forms
# and of one (rows, k + cols) candidate matrix of the top-k merge: 2^28
# float32 are 1 GiB, so a call's extra memory stays a few GiB beside its
# result (cdist of 2^16 x 2^14 rows of 16 features would need 69 GB whole)
_BLOCK_ELEMENTS = 1 << 28


def _sqeuclidean(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``|x_i - y_j|^2`` by the expanded form, ``(|x|^2 + |y|^2) - 2 x.y``
    in the reference's order, clipped at 0; one full-f32 matrix product."""
    with full_f32_matmul():
        cross = x @ y.T
    d = torch.sum(x * x, dim=1, keepdim=True) + torch.sum(y * y, dim=1, keepdim=True).T
    return d.sub_(cross.mul_(2.0)).clamp_(min=0.0)


def _euclidean(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return _sqeuclidean(x, y).sqrt_()


def _differences(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``x_i - y_j`` feature by feature, as an (f, rows, cols) tensor: the
    sum over features then runs along the outer axis, which the card
    reduces at its memory rate (a sum over an inner axis of 16 took four
    times as long)."""
    return x.T[:, :, None] - y.T[:, None, :]


def _direct_tile(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Exact broadcast-subtract euclidean tile: no cancellation for
    near-duplicate points; its intermediate is (f, rows, cols)."""
    diff = _differences(x, y)
    return torch.sum(diff.mul_(diff), dim=0).sqrt_()


def _cityblock_tile(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """City-block tile; its intermediate is (f, rows, cols)."""
    return torch.sum(_differences(x, y).abs_(), dim=0)


_METRICS = {
    "sqeuclidean": _sqeuclidean,
    "euclidean": _euclidean,
    "euclidean_direct": _direct_tile,
    "manhattan": _cityblock_tile,
}
_BROADCAST = ("euclidean_direct", "manhattan")


def _pairwise(metric: str, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The (n, m) matrix of ``metric`` between the rows of x and of y.  A
    broadcast form runs in blocks of at most :data:`_BLOCK_ELEMENTS`
    intermediate elements."""
    fn = _METRICS[metric]
    if metric not in _BROADCAST:
        return fn(x, y)
    n, m, f = x.shape[0], y.shape[0], max(x.shape[1], 1)
    out = torch.empty((n, m), dtype=torch.promote_types(x.dtype, y.dtype), device=x.device)
    cols = min(m, max(1, _BLOCK_ELEMENTS // f))
    rows = min(n, max(1, _BLOCK_ELEMENTS // (cols * f)))
    for i in range(0, n, rows):
        for j in range(0, m, cols):
            out[i : i + rows, j : j + cols] = fn(x[i : i + rows], y[j : j + cols])
    return out


# ----------------------------------------------------------------------
# checks and operands
# ----------------------------------------------------------------------
def _prep_checks(X: DNDarray, Y: Optional[DNDarray]) -> None:
    """The reference's checks of both operands, in its order."""
    sanitize_in(X)
    if X.ndim != 2:
        raise NotImplementedError(f"X should be a 2D DNDarray, but is {X.ndim}D")
    if X.split is not None and X.split != 0:
        raise NotImplementedError(f"Splittings other than 0 or None currently not supported, got {X.split}")
    if Y is not None:
        sanitize_in(Y)
        if Y.ndim != 2:
            raise NotImplementedError(f"Y should be a 2D DNDarray, but is {Y.ndim}D")
        if X.shape[1] != Y.shape[1]:
            raise ValueError(f"X and Y must have the same number of features, got {X.shape[1]} and {Y.shape[1]}")


def _refuse_low_precision() -> None:
    if low_precision_predict_requested():
        raise NotImplementedError("the bf16 distance variants (HEAT_TPU_PREDICT_DTYPE) wait for the precision "
                                  "policies (ROADMAP queue 1, item 18)")


def _float(t: torch.Tensor, dtype) -> torch.Tensor:
    """``t`` as floats: integer and bool inputs become float32."""
    return t if types.heat_type_is_inexact(dtype) else t.to(torch.float32)


def _ring_eligible(X: DNDarray, Y: Optional[DNDarray]) -> bool:
    return X.split == 0 and X.comm.size > 1 and (Y is None or (Y.split == 0 and Y.comm == X.comm))


def _whole_rows(Y: DNDarray) -> torch.Tensor:
    """All of Y's rows on this rank (gathered where Y is split)."""
    return Y.larray if Y.split is None or Y.comm.size == 1 else Y._dense()


def _local_operands(X: DNDarray, Y: Optional[DNDarray]) -> Tuple[torch.Tensor, torch.Tensor]:
    """This rank's rows of X (its padded chunk where X is split) and all of
    Y (X's own rows where Y is None, possible only outside the ring), both
    float and of one dtype."""
    x = _float(X.larray_padded, X.dtype)
    if Y is None:
        return x, x
    y = _float(_whole_rows(Y), Y.dtype)
    dtype = torch.promote_types(x.dtype, y.dtype)
    return x.to(dtype), y.to(dtype)


def _result(X: DNDarray, d: torch.Tensor, m: int) -> DNDarray:
    return X._like(d, (X.shape[0], m), 0 if X.split is not None else None)


# ----------------------------------------------------------------------
# the ring
# ----------------------------------------------------------------------
def _ring_schedule(rank: int, p: int, symmetric: bool) -> List[Tuple[int, Optional[Tuple[list, int]]]]:
    """The rounds of the distance ring on ``rank`` of ``p``: for each,
    ``(owner, mirror)``.  ``owner`` is the rank whose Y block this rank holds
    in that round, ``(rank + it) % p``.  With ``symmetric`` (Y is X) only
    ``p // 2 + 1`` rounds run, and ``mirror`` is ``(perm, src)`` in every
    round ``0 < it`` but round ``p / 2`` of an even ``p``: the tile's
    transpose goes by ppermute with ``perm`` to its owner, and this rank
    receives the tile of rank ``src``, its column block; else None."""
    rounds = p // 2 + 1 if symmetric else p
    out = []
    for it in range(rounds):
        mirror = None
        if symmetric and 0 < it and not (p % 2 == 0 and it == p // 2):
            mirror = ([(i, (i + it) % p) for i in range(p)], (rank - it) % p)
        out.append(((rank + it) % p, mirror))
    return out


def _shift_down(p: int) -> list:
    """The ppermute that moves every rank's block to the rank below."""
    return [((i + 1) % p, i) for i in range(p)]


def _ring_blocks(X: DNDarray, Y: Optional[DNDarray]) -> Tuple[torch.Tensor, torch.Tensor]:
    """X's and Y's padded row blocks, Y's cast to X's float type (the
    reference's ring does so)."""
    x = _float(X.larray_padded, X.dtype)
    if Y is None:
        return x, x
    return x, _float(Y.larray_padded, Y.dtype).to(x.dtype)


def _ring_pairwise(X: DNDarray, Y: Optional[DNDarray], metric: str) -> torch.Tensor:
    """This rank's (bn, m) row band of the distance matrix, by the ring."""
    comm = X.comm
    p = comm.size
    m = X.shape[0] if Y is None else Y.shape[0]
    x, y = _ring_blocks(X, Y)
    bm = y.shape[0]
    out = torch.empty((x.shape[0], m), dtype=x.dtype, device=x.device)

    def put(block: int, tile: torch.Tensor) -> None:
        start = block * bm
        width = min(bm, m - start)
        if width > 0:
            out[:, start : start + width] = tile[:, :width]

    schedule = _ring_schedule(comm.rank, p, Y is None)
    for it, (owner, mirror) in enumerate(schedule):
        tile = _pairwise(metric, x, y)
        put(owner, tile)
        if mirror is not None:
            perm, src = mirror
            put(src, comm.ppermute(tile.T.contiguous(), perm))
        del tile
        if it + 1 < len(schedule):
            y = comm.ppermute(y, _shift_down(p))
    return out


def _distances(X: DNDarray, Y: Optional[DNDarray], metric: str) -> DNDarray:
    m = X.shape[0] if Y is None else Y.shape[0]
    if _ring_eligible(X, Y):
        return _result(X, _ring_pairwise(X, Y, metric), m)
    x, y = _local_operands(X, Y)
    return _result(X, _pairwise(metric, x, y), m)


def cdist(X: DNDarray, Y: Optional[DNDarray] = None, quadratic_expansion: bool = False) -> DNDarray:
    """Euclidean distance matrix between the rows of X and of Y (X itself
    when Y is None), split like X's rows.  ``quadratic_expansion`` takes the
    expanded form (one matrix product); the default is the exact direct
    form."""
    _prep_checks(X, Y)
    _refuse_low_precision()
    return _distances(X, Y, "euclidean" if quadratic_expansion else "euclidean_direct")


cdist_small = cdist


def manhattan(X: DNDarray, Y: Optional[DNDarray] = None, expand: bool = False) -> DNDarray:
    """City-block distance matrix, split like X's rows (``expand`` is the
    reference's and changes nothing)."""
    _prep_checks(X, Y)
    return _distances(X, Y, "manhattan")


def rbf(X: DNDarray, Y: Optional[DNDarray] = None, sigma: float = 1.0, quadratic_expansion: bool = False) -> DNDarray:
    """Gaussian kernel matrix ``exp(-d^2 / (2 sigma^2))`` of the expanded
    squared distances (in the ring and outside it, as the reference's)."""
    _prep_checks(X, Y)
    d2 = _distances(X, Y, "sqeuclidean")
    t = d2.larray_padded
    # divided by a tensor: torch multiplies by the reciprocal of a host scalar on the card
    t.neg_().div_(torch.tensor(2.0 * sigma * sigma, dtype=t.dtype, device=t.device)).exp_()
    return d2


# ----------------------------------------------------------------------
# the k nearest rows of Y
# ----------------------------------------------------------------------
def _smallest(cand: torch.Tensor, k: int) -> torch.Tensor:
    """Positions of the k smallest values of each row of ``cand`` (non-negative
    or +inf), ascending, a tie to the lower position (``jax.lax.top_k``'s
    order; ``torch.topk`` promises none).  float32 values go as one int64
    key each, their bits above their position, through ``torch.topk``;
    other types through a stable sort."""
    if cand.dtype == torch.float32:
        pos = torch.arange(cand.shape[1], dtype=torch.int64, device=cand.device)
        key = torch.bitwise_or(cand.view(torch.int32).to(torch.int64).bitwise_left_shift_(32), pos)
        return torch.topk(key, k, dim=1, largest=False, sorted=True).values.bitwise_and_(0xFFFFFFFF)
    return torch.sort(cand, dim=1, stable=True).indices[:, :k]


class _Nearest:
    """A running k-smallest set of each row of x over blocks of Y: the
    squared distances ``vals``, their global Y rows ``idx`` and, where
    labels ride along, their label rows ``rows``.  Each merge takes the
    candidates ``[vals, block]`` in that order, so a candidate seen earlier
    wins a tie."""

    def __init__(self, x: torch.Tensor, k: int, n_labels: Optional[Tuple[int, torch.dtype]] = None):
        self.x, self.k = x, k
        self.vals = torch.full((x.shape[0], k), float("inf"), dtype=x.dtype, device=x.device)
        self.idx = torch.zeros((x.shape[0], k), dtype=torch.int64, device=x.device)
        self.rows = None
        if n_labels is not None:
            self.rows = torch.zeros((x.shape[0], k, n_labels[0]), dtype=n_labels[1], device=x.device)

    def add(self, y: torch.Tensor, first: int, m: int, labels: Optional[torch.Tensor] = None) -> None:
        """Merge Y rows ``first, first + 1, ...`` (``y``; those at ``m`` or past
        it are padding, +inf), with their label rows, in blocks."""
        k = self.k
        cols = max(1, _BLOCK_ELEMENTS // max(self.x.shape[0], 1) - k)
        for j in range(0, y.shape[0], cols):
            block = _sqeuclidean(self.x, y[j : j + cols])
            gcol = first + j + torch.arange(block.shape[1], dtype=torch.int64, device=block.device)
            block.masked_fill_(gcol[None, :] >= m, float("inf"))
            cand = torch.cat([self.vals, block], dim=1)
            del block
            pos = _smallest(cand, k)
            self.vals = cand.gather(1, pos)
            del cand
            new = pos >= k
            fresh = (pos - k).clamp_(min=0)
            kept = pos.clamp(max=k - 1)
            self.idx = torch.where(new, gcol[fresh], self.idx.gather(1, kept))
            if self.rows is not None:
                lab = labels[j : j + cols][fresh]
                old = self.rows.gather(1, kept[..., None].expand(-1, -1, lab.shape[-1]))
                self.rows = torch.where(new[..., None], lab, old)


def _nearest(X: DNDarray, Y: DNDarray, k: int, labels: Optional[DNDarray] = None) -> _Nearest:
    """The k nearest rows of Y to each of this rank's rows of X (its padded
    chunk where X is split), with their rows of ``labels`` (one row per
    row of Y) where given.  On the ring the label block rides beside Y's,
    one more ppermute a round; outside it Y's blocks are merged in
    ascending order, the dense ``top_k``'s tie order."""
    m = Y.shape[0]
    n_labels = None
    if labels is not None:
        n_labels = (labels.shape[1], labels.larray.dtype)
    if _ring_eligible(X, Y):
        comm = X.comm
        p = comm.size
        x, y = _ring_blocks(X, Y)
        lab = None if labels is None else labels.resplit(0).larray_padded  # no exchange where split 0 or None
        near = _Nearest(x, k, n_labels)
        for it, (owner, _) in enumerate(_ring_schedule(comm.rank, p, False)):
            near.add(y, owner * y.shape[0], m, lab)
            if it + 1 < p:
                y = comm.ppermute(y, _shift_down(p))
                if lab is not None:
                    lab = comm.ppermute(lab, _shift_down(p))
        return near
    x, y = _local_operands(X, Y)
    near = _Nearest(x, k, n_labels)
    near.add(y, 0, m, None if labels is None else _whole_rows(labels))
    return near


def _k_nearest(X: DNDarray, Y: DNDarray, k, labels: Optional[DNDarray] = None) -> _Nearest:
    """:func:`_nearest` after the reference's checks of ``cdist_topk``."""
    _prep_checks(X, Y)
    k = int(k)
    if k > Y.shape[0]:
        raise ValueError(f"k={k} exceeds the number of Y rows ({Y.shape[0]})")
    _refuse_low_precision()
    return _nearest(X, Y, k, labels)


def cdist_topk(X: DNDarray, Y: DNDarray, k: int):
    """The k smallest euclidean distances from each row of X to the rows of
    Y, ascending, and the global indices (int32) of those rows: ``(dist,
    idx)``, both (n, k), split like X.  The (n, m) matrix never exists: at
    most one block of Y's rows and the (rows, k) candidates do."""
    near = _k_nearest(X, Y, k)
    shape = (X.shape[0], near.k)
    split = 0 if X.split is not None else None
    return X._like(near.vals.sqrt_(), shape, split), X._like(near.idx.to(torch.int32), shape, split)
