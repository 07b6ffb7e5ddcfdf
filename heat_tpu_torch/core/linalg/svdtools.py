"""Hierarchical SVD (counterpart of heat_tpu/core/linalg/svdtools.py).

``hsvd_rank`` and ``hsvd_rtol`` truncate a 2-D array's SVD at a fixed rank
or at a relative error; both go through one body, :func:`_hsvd_body`, as the
reference's fixed-rank and rtol callers do.  Where the data lives decides
the route:

- **A tall array split along rows, or not split** (m >= n): one leaf.  Each
  rank adds its own rows into the Gram matrix ``G = x^T x`` (the hand-written
  kernel of :func:`heat_tpu_torch.core.kernels.gram_partials` on the card),
  one all-reduce of the (n, n) G follows, and every rank takes ``eigh`` of
  the same G: its eigenvalues are the squared singular values, its vectors
  V.  ``U = x V / s`` stays split along rows.  Nothing is gathered.
- **An array split along columns** over p ranks (n >= p): each rank's column
  block is a leaf of the merge tree.  Each rank truncates its own leaf, the
  (m, <= trunc) leaf factors are all-gathered, and every rank runs the merge
  levels in the reference's block order, groups of ``no_of_merges`` leaves at
  a time.
- **The reference's dense cases** (a wide array split along rows, fewer
  columns than ranks): the whole array, gathered, as the reference does.

``rsvd`` is the reference's randomized SVD: a Gaussian test matrix from the
seeded ``random.randn`` (on the card, one launch of the threefry kernel),
``A Omega``, optional power iterations, an orthonormal basis Q by two passes
of symmetric (Loewdin) Gram orthogonalization, ``Q^T A`` and one small SVD.
It works on the dense matrix, as the reference does: on a world of one that
is A itself, on more ranks A gathered.

Every product runs in IEEE float32 or float64 (no TF32).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from .. import kernels, types
from ..dndarray import DNDarray
from ..sanitation import sanitize_in
from .basics import full_f32_matmul

__all__ = ["hsvd", "hsvd_rank", "hsvd_rtol", "rsvd"]


def hsvd_rank(
    A: DNDarray,
    maxrank: int,
    compute_sv: bool = False,
    maxmergedim: Optional[int] = None,
    safetyshift: int = 5,
    silent: bool = True,
):
    """Hierarchical SVD truncated at rank ``maxrank``: ``(U, rel_err)``, or
    ``(U, S, V, rel_err)`` with ``compute_sv``."""
    sanitize_in(A)
    if A.ndim != 2:
        raise ValueError(f"A must be a 2D matrix, but is {A.ndim}-dimensional")
    if not isinstance(maxrank, int) or maxrank < 1:
        raise ValueError(f"maxrank must be a positive integer, but is {maxrank}")
    return _hsvd(A, maxrank=maxrank, rtol=None, compute_sv=compute_sv, safetyshift=safetyshift)


def hsvd_rtol(
    A: DNDarray,
    rtol: float,
    compute_sv: bool = False,
    maxrank: Optional[int] = None,
    maxmergedim: Optional[int] = None,
    safetyshift: int = 5,
    no_of_merges: Optional[int] = None,
    silent: bool = True,
):
    """Hierarchical SVD truncated at the smallest rank whose estimated
    relative error is at most ``rtol``."""
    sanitize_in(A)
    if A.ndim != 2:
        raise ValueError(f"A must be a 2D matrix, but is {A.ndim}-dimensional")
    if not isinstance(rtol, float) or rtol <= 0:
        raise ValueError(f"rtol must be a positive float, but is {rtol}")
    return _hsvd(A, maxrank=maxrank, rtol=rtol, compute_sv=compute_sv, safetyshift=safetyshift)


def hsvd(
    A: DNDarray,
    maxrank: Optional[int] = None,
    maxmergedim: Optional[int] = None,
    rtol: Optional[float] = None,
    safetyshift: int = 0,
    no_of_merges: int = 2,
    compute_sv: bool = False,
    silent: bool = True,
    warnings_off: bool = False,
):
    """Generic hierarchical SVD: a fixed rank when ``rtol`` is None, else a
    relative error (capped at ``maxrank``)."""
    sanitize_in(A)
    return _hsvd(A, maxrank=maxrank, rtol=rtol, compute_sv=compute_sv, safetyshift=safetyshift, no_of_merges=no_of_merges)


def rsvd(A: DNDarray, rank: int, n_oversamples: int = 10, power_iter: int = 0, qr_procs_to_merge: int = 2):
    """Randomized SVD: ``(U, S, V)`` of rank at most ``rank``, from a range
    sampled with ``rank + n_oversamples`` Gaussian columns and ``power_iter``
    power iterations.  U is split along rows when A is, S and V are whole.
    Integer input works in float32."""
    sanitize_in(A)
    if not isinstance(rank, int) or rank < 1:
        raise ValueError(f"rank must be a positive integer, but is {rank}")
    if not isinstance(n_oversamples, int) or n_oversamples < 0:
        raise ValueError(f"n_oversamples must be a non-negative integer, but is {n_oversamples}")
    if not isinstance(power_iter, int) or power_iter < 0:
        raise ValueError(f"power_iter must be a non-negative integer, but is {power_iter}")
    from .. import random

    m, n = A.shape
    ell = min(rank + n_oversamples, m, n)
    dtype = A.dtype if types.heat_type_is_inexact(A.dtype) else types.float32
    omega = random.randn(n, ell, dtype=dtype, device=A.device, comm=A.comm)
    k = min(rank, min(ell, m))
    u_k, s_k, v_k = _rsvd_jit(A._dense(), omega.larray, power_iter, k, dtype.torch_type())
    U = DNDarray.from_dense(u_k, A.split if A.split == 0 else None, A.device, A.comm)
    S = DNDarray.from_dense(s_k, None, A.device, A.comm)
    V = DNDarray.from_dense(v_k, None, A.device, A.comm)
    return U, S, V


def _rsvd_jit(dense: torch.Tensor, omega: torch.Tensor, power_iter: int, k: int, dtype: torch.dtype):
    """The randomized factorization of the dense matrix: range sampling,
    power iterations, orthonormal bases, ``Q^T A``, its SVD and the rank-k
    truncation (the reference compiles this as one program, hence the name).
    ``dense`` is not copied when it already has the working dtype.  Each
    step runs under a profiler label, so that a profile splits the time:
    ``rsvd.range`` (the products of A or A^T with the basis),
    ``rsvd.gram`` (the orthonormalizations), ``rsvd.project`` (``Q^T A``)
    and ``rsvd.small_svd``."""
    with full_f32_matmul():
        dense = dense.to(dtype)
        with record_function("rsvd.range"):
            y = dense @ omega.to(dtype)
        q = _gram_orthonormalize(y)
        for _ in range(power_iter):
            with record_function("rsvd.range"):
                z = dense.T @ q
            q = _gram_orthonormalize(z)
            with record_function("rsvd.range"):
                y = dense @ q
            q = _gram_orthonormalize(y)
        with record_function("rsvd.project"):
            b = q.T @ dense
        with record_function("rsvd.small_svd"):
            u_b, s, vt = torch.linalg.svd(b, full_matrices=False)
            u = q @ u_b
    return u[:, :k], s[:k], vt[:k].T


def _gram_orthonormalize(y: torch.Tensor, passes: int = 2) -> torch.Tensor:
    """An orthonormal basis of the tall matrix y by symmetric (Loewdin) Gram
    orthogonalization, ``q V diag(lam^-1/2) V^T`` with ``(lam, V) = eigh(q^T
    q)``, twice (the CholeskyQR2 recipe).  The product does not depend on
    the signs eigh gives its vectors.  Directions whose eigenvalue is at most
    eps of y's type times the largest (a rank-deficient y) become zero
    columns, not amplified noise.  The Gram matrices are full-precision
    products, as the reference's HIGHEST ones are."""
    q = y
    with record_function("rsvd.gram"):
        for _ in range(passes):
            lam, v = torch.linalg.eigh(q.T @ q)
            cutoff = torch.finfo(q.dtype).eps * torch.clamp(torch.max(lam), min=1e-30)
            inv_sqrt = torch.where(lam > cutoff, 1.0 / torch.sqrt(torch.clamp(lam, min=1e-30)), 0.0)
            q = q @ ((v * inv_sqrt[None, :]) @ v.T)
    return q


def _hsvd(
    A: DNDarray,
    maxrank: Optional[int],
    rtol: Optional[float],
    compute_sv: bool,
    safetyshift: int,
    no_of_merges: int = 2,
):
    m, n = A.shape
    dtype = A.larray_padded.dtype if types.heat_type_is_inexact(A.dtype) else torch.float32
    if maxrank is None:
        maxrank = min(m, n)
    trunc = min(maxrank + safetyshift, m)
    u, u_local, s, v, discarded_sq, total_sq = _hsvd_body(A, dtype, trunc, no_of_merges, compute_sv)

    if rtol is None:
        k = min(maxrank, trunc)
        sv = s[:k]
        approx_sq = torch.sum(sv.float() ** 2)
    else:
        # the smallest k whose discarded energy (leaf and merge truncations
        # plus the dropped tail of s) is at most rtol^2 ||A||_F^2: a host
        # decision, taken from values every rank holds bit for bit
        sq = s.float() ** 2
        resid = torch.sum(sq) - torch.cumsum(sq, 0) + discarded_sq
        ok = (resid <= (rtol**2) * total_sq).cpu().numpy()
        k = int(np.argmax(ok)) + 1 if ok.any() else int(s.shape[0])
        k = min(k, maxrank)
        sv = s[:k]
        approx_sq = torch.sum(sv**2)
    rel_err = torch.sqrt(torch.clamp(total_sq - approx_sq, min=0.0) / torch.clamp(total_sq, min=1e-30))

    k = sv.shape[0]
    if u_local:
        U = A._like(u[:, :k], (m, k), 0)
    else:
        U = DNDarray.from_dense(u[:, :k], 0 if A.split == 0 else None, A.device, A.comm)
    if not compute_sv:
        return U, rel_err
    S = DNDarray.from_dense(sv, None, A.device, A.comm)
    V = DNDarray.from_dense(v[:, :k], 1 if A.split == 1 else None, A.device, A.comm)
    return U, S, V, rel_err


def _hsvd_body(A: DNDarray, dtype, trunc: int, no_of_merges: int, compute_v: bool):
    """The factorization at full working width: ``(u, u_local, s, v,
    discarded_sq, total_sq)``.  ``u_local`` says u is this rank's padded
    chunk of rows (else the whole u); v (n, w) is whole, or None."""
    m, n = A.shape
    comm = A.comm
    p = comm.size if A.split == 1 else 1
    tree = p > 1 and n >= p
    with full_f32_matmul():
        if not tree and m >= n:
            return _single_leaf(A, dtype, trunc, compute_v)
        if tree:
            factors, discarded_sq, total_sq = _leaf_level(A, dtype, trunc)
        else:
            dense = A._dense().to(dtype)
            factors, discarded_sq, total_sq = _level([dense], trunc)

        # merge tree: levels of no_of_merges-way merges, in block order
        while len(factors) > 1:
            cats = [torch.cat(factors[i : i + no_of_merges], dim=1) for i in range(0, len(factors), no_of_merges)]
            factors, disc, _ = _level(cats, trunc)
            discarded_sq = discarded_sq + disc

        us = factors[0]
        if us.shape[0] >= us.shape[1]:
            # the final factorization through the Gram matrix of the small
            # (m, <= trunc) factor; directions below its noise floor (eps of
            # the working type, relative) are dropped with their columns
            lam, v_eig = _eigh_desc(us.T @ us)
            lam = torch.clamp(lam, min=0.0)
            s, inv_s = _floored_sqrt(lam, torch.finfo(us.dtype).eps)
            u = (us @ v_eig) * inv_s[None, :]
        else:
            u, s, _ = torch.linalg.svd(us, full_matrices=False)

        v = None
        if compute_v:
            # V = A^T U diag(1/s)
            inv_sv = torch.where(s > 0, 1.0 / torch.clamp(s, min=1e-30), 0.0)
            if tree:
                rows = (A.larray_padded.to(dtype).T @ u) * inv_sv[None, :]
                v = comm.all_gather(rows, axis=0)[:n]
            else:
                v = (dense.T @ u) * inv_sv[None, :]
    return u, False, s, v, discarded_sq, total_sq


def _single_leaf(A: DNDarray, dtype, trunc: int, compute_v: bool):
    """One leaf, m >= n: the Gram matrix gives everything.  eigh(G) is
    (sigma^2, V), and U = A V / sigma has orthonormal columns, so neither a
    second factorization nor a second pass over A for V is needed."""
    m, n = A.shape
    if A.split == 0:
        x, n_true = A.larray_padded.to(dtype), A.lshape[0]
    else:
        x, n_true = A._dense().to(dtype), m
    g = _gram(x, n_true)
    if A.split == 0:
        A.comm.psum(g)
    lam, v = _eigh_desc(g)
    kk = min(trunc, n)
    discarded_sq = torch.sum(torch.clamp(lam[kk:].float(), min=0.0))
    total_sq = torch.sum(torch.clamp(lam.float(), min=0.0))
    s, inv_s = _floored_sqrt(torch.clamp(lam[:kk], min=0.0), torch.finfo(x.dtype).eps)
    u = (x @ v[:, :kk]) * inv_s[None, :]
    return u, A.split == 0, s, v[:, :kk] if compute_v else None, discarded_sq, total_sq


def _gram(x: torch.Tensor, n_true: int) -> torch.Tensor:
    """``x[:n_true].T @ x[:n_true]``: the hand-written kernel where its gate
    admits x (float32, at most 512 columns), else a product in full
    precision (float64 input, wider matrices)."""
    if kernels.gram_unsupported(x.shape[1], x.dtype) is None:
        return kernels.gram_partials(x.contiguous(), n_true)
    xv = x[:n_true]
    return xv.T @ xv


def _eigh_desc(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eigenvalues of a symmetric matrix in descending order, and their vectors."""
    lam, v = torch.linalg.eigh(g)
    return lam.flip(0), v.flip(1)


def _floored_sqrt(lam: torch.Tensor, eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(sqrt(lam), 1 / sqrt(lam))`` of descending eigenvalues, both 0 where
    lam is at most eps times the largest (the Gram matrix's noise floor)."""
    keep = lam > eps * torch.clamp(lam[0], min=1e-30)
    root = torch.sqrt(lam)
    return torch.where(keep, root, 0.0), torch.where(keep, 1.0 / torch.clamp(root, min=1e-30), 0.0)


def _truncated_us(blk: torch.Tensor, trunc: int):
    """The truncated ``U * s`` factor of a block, the squared energy the
    truncation discards and the block's own (tall blocks through the Gram
    matrix, wide ones through an SVD)."""
    m, n = blk.shape
    if m >= n:
        lam, v = _eigh_desc(blk.T @ blk)
        kk = min(trunc, n)
        disc = torch.sum(torch.clamp(lam[kk:].float(), min=0.0))
        blk_sq = torch.sum(torch.clamp(lam.float(), min=0.0))  # tr(G) = ||blk||_F^2
        return blk @ v[:, :kk], disc, blk_sq
    u, s, _ = torch.linalg.svd(blk, full_matrices=False)
    kk = min(trunc, s.shape[0])
    return u[:, :kk] * s[:kk][None, :], torch.sum(s[kk:].float() ** 2), torch.sum(s.float() ** 2)


def _level(blocks: List[torch.Tensor], trunc: int):
    """One level of the tree: each block's truncated factor, in order, and
    the level's summed discarded and total energies."""
    outs = []
    disc = torch.zeros((), dtype=torch.float32, device=blocks[0].device)
    total = torch.zeros((), dtype=torch.float32, device=blocks[0].device)
    for blk in blocks:
        us, d, sq = _truncated_us(blk, trunc)
        outs.append(us)
        disc = disc + d
        total = total + sq
    return outs, disc, total


def _leaf_level(A: DNDarray, dtype, trunc: int):
    """The leaves of a column-split array: each rank truncates its own
    column block; every rank receives all the leaf factors, in rank order
    (ranks without columns hold no leaf), and their energies, summed in the
    same order on every rank."""
    comm = A.comm
    m, n = A.shape
    # rank r's canonical chunk of columns is the r-th leaf
    leaves = _col_slices(n, comm.size)
    cols = [s.stop - s.start for s in leaves] + [0] * (comm.size - len(leaves))
    local = A.larray.to(dtype)
    zero = torch.zeros((), dtype=torch.float32, device=local.device)
    if cols[comm.rank]:
        us, d, sq = _truncated_us(local, trunc)
    else:
        us, d, sq = local.new_zeros((m, 0)), zero, zero
    factors = comm.all_gather_varying(us, [min(trunc, c) for c in cols], axis=1)
    energies = comm.all_gather(torch.stack([d, sq])[None, :], axis=0)
    disc, total = zero, zero
    for r in range(len(leaves)):
        disc = disc + energies[r, 0]
        total = total + energies[r, 1]
    return factors[: len(leaves)], disc, total


def _col_slices(n: int, p: int) -> List[slice]:
    """The leaves of n columns over p ranks: blocks of ceil(n / p) columns,
    the last one shorter, as many as it takes (at most p)."""
    per = -(-n // p)
    return [slice(start, min(start + per, n)) for start in range(0, n, per)]
