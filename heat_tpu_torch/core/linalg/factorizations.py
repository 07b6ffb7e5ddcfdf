"""Distributed dense factorizations of split square matrices (counterpart
of heat_tpu/core/linalg/factorizations.py).

The matrix stays split along rows from end to end; no rank ever holds the
n x n matrix:

* :func:`cholesky_dist`: blocked right-looking Cholesky.  Panel j's
  diagonal block is broadcast from its owner and factored on every rank,
  each rank solves its own rows of the panel, and the trailing update is
  one local product against the all-gathered (n - (j + 1) b, b) panel.
* The LU with partial pivoting (:func:`_lu_factor`): physical rows never
  move; the permutation lives in a replicated logical-to-physical map.
  Each panel is all-gathered, permuted logically and LU-factored on every
  rank (pivoting inside the tall panel needs no communication), and the
  trailing update gathers only the b pivot rows, by a psum of each rank's
  own pivot rows.  The pivot parity comes from the panel's IPIV vector, so
  ``det`` walks no permutation.
* :func:`solve_dist`, :func:`det_dist`, :func:`inv_dist`: blocked forward
  and backward substitution over the factors (psums of each rank's own
  products against its block of the solution); the inverse solves against
  the split identity.

Padding: the matrix is squared up to (n_pad, n_pad), n_pad the canonical
padded extent, with the identity on the padded diagonal.  The padded
matrix is block-diagonal, so its factors and determinant are those of the
true matrix.  Each rank runs its own branch of a round; only the
collectives are common.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .. import types
from ..dndarray import DNDarray, _pad_along
from .basics import _mm

__all__ = ["cholesky_dist", "det_dist", "inv_dist", "solve_dist", "supports_dist_factor"]


def supports_dist_factor(a: DNDarray) -> bool:
    """Whether ``a`` takes the distributed route: a split square matrix on
    more than one rank."""
    return a.ndim == 2 and a.shape[0] == a.shape[1] and a.split is not None and a.comm.size > 1


def _square_padded(a: DNDarray) -> Tuple[torch.Tensor, int, int]:
    """This rank's (b, n_pad) rows of the padded square matrix, the identity
    on the padded diagonal: ``(rows, n, n_pad)``."""
    x = a if a.split == 0 else a.resplit(0)
    if not types.heat_type_is_inexact(x.dtype):
        x = x.astype(types.float32)
    comm = x.comm
    n = a.shape[0]
    buf = _pad_along(x._masked(0), 1, comm.padded_extent(n))
    if buf is x.larray_padded:  # the factorizations write into it
        buf = buf.clone()
    b, n_pad = buf.shape
    rows = torch.arange(comm.rank * b, (comm.rank + 1) * b, device=buf.device)
    pad = torch.nonzero(rows >= n)[:, 0]
    buf[pad, rows[pad]] = 1
    return buf, n, n_pad


# ----------------------------------------------------------------------
# Cholesky
# ----------------------------------------------------------------------
def cholesky_dist(a: DNDarray) -> DNDarray:
    """The lower-triangular Cholesky factor of a split SPD matrix, split
    along rows."""
    buf, n, n_pad = _square_padded(a)
    comm = a.comm
    p, r = comm.size, comm.rank
    b = n_pad // p
    for j in range(p):
        c0, c1 = j * b, (j + 1) * b
        ajj = comm.bcast(buf[:, c0:c1].contiguous() if r == j else buf.new_empty((b, b)), root=j)
        ljj = torch.linalg.cholesky(ajj)
        if r > j:  # my rows of the panel: L[r, j] = A[r, j] L_jj^-T
            panel = torch.linalg.solve_triangular(ljj.mH, buf[:, c0:c1], upper=True, left=False)
        elif r == j:
            panel = ljj
        else:
            panel = torch.zeros_like(ljj)
        buf[:, c0:c1] = panel
        if j + 1 < p:
            # the trailing update against the gathered panel rows below the block
            below = comm.all_gather(panel[None].contiguous(), axis=0)[j + 1:].reshape(-1, b)
            if r > j:
                buf[:, c1:] -= _mm(panel, below.mH)
    row = torch.arange(r * b, (r + 1) * b, device=buf.device)
    lower = torch.arange(n_pad, device=buf.device)[None, :] <= row[:, None]
    out = torch.where(lower, buf, torch.zeros((), dtype=buf.dtype, device=buf.device))[:, :n].contiguous()
    return DNDarray(out, (n, n), types.canonical_heat_type(out.dtype), 0, a.device, comm)


# ----------------------------------------------------------------------
# LU with partial pivoting (physical rows pinned, logical permutation)
# ----------------------------------------------------------------------
def _ipiv_permutation(ipiv: np.ndarray, m: int) -> np.ndarray:
    """The permutation ``perm`` with ``panel[perm] = L U`` from LAPACK's
    1-based sequential row interchanges."""
    perm = np.arange(m)
    for i, t in enumerate(ipiv - 1):
        perm[i], perm[t] = perm[t], perm[i]
    return perm


def _lu_factor(a: DNDarray):
    """The distributed LU: ``(factors, phys_of_log, sign, logdet, n, n_pad)``
    with this rank's (b, n_pad) rows of the in-place factors, the
    replicated logical-to-physical row map, and det's sign and log|det|."""
    buf, n, n_pad = _square_padded(a)
    comm = a.comm
    p, r = comm.size, comm.rank
    b = n_pad // p
    dev = buf.device
    phys_of_log = torch.arange(n_pad, device=dev)
    mine = torch.arange(r * b, (r + 1) * b, device=dev)  # my physical rows
    real = buf.real.dtype if buf.is_complex() else buf.dtype
    logdet = torch.zeros((), dtype=real, device=dev)
    sign = torch.ones((), dtype=buf.dtype, device=dev)
    for j in range(p):
        c0, c1 = j * b, (j + 1) * b
        strip = comm.all_gather(buf[:, c0:c1].contiguous(), axis=0)  # (n_pad, b) in physical order
        active = strip[phys_of_log[c0:]]  # logical rows c0.. of the panel
        lu, ipiv, _ = torch.linalg.lu_factor_ex(active)  # a singular panel factors too: its zero pivot gives det 0
        ipiv = ipiv.cpu().numpy()
        swaps = int(np.count_nonzero(ipiv != np.arange(1, ipiv.shape[0] + 1)))
        diag = torch.diagonal(lu[:b])
        sign = sign * torch.prod(torch.sgn(diag)) * (-1 if swaps % 2 else 1)
        logdet = logdet + torch.sum(torch.log(torch.abs(diag)))
        perm = torch.as_tensor(_ipiv_permutation(ipiv, active.shape[0]), device=dev)
        phys_of_log = torch.cat([phys_of_log[:c0], phys_of_log[c0:][perm]])
        log_of_phys = torch.empty_like(phys_of_log)
        log_of_phys[phys_of_log] = torch.arange(n_pad, device=dev)
        li = log_of_phys[mine]  # the logical position of each of my rows
        placed = torch.nonzero(li >= c0)[:, 0]  # my rows at or below the panel's block
        buf[placed, c0:c1] = lu[li[placed] - c0]
        if j + 1 < p:
            in_blk = torch.nonzero((li >= c0) & (li < c1))[:, 0]
            contrib = buf.new_zeros((b, n_pad - c1))
            contrib[li[in_blk] - c0] = buf[in_blk, c1:]
            urows = comm.psum(contrib)  # the b pivot rows' trailing columns
            ljj = torch.tril(lu[:b], -1) + torch.eye(b, dtype=lu.dtype, device=dev)
            u_trail = torch.linalg.solve_triangular(ljj, urows, upper=False, unitriangular=True)
            lower = torch.nonzero(li >= c1)[:, 0]
            if lower.numel():
                buf[lower, c1:] -= _mm(lu[li[lower] - c0], u_trail)
            buf[in_blk, c1:] = u_trail[li[in_blk] - c0]
    return buf, phys_of_log, sign, logdet, n, n_pad


def det_dist(a: DNDarray) -> DNDarray:
    """The determinant of a split square matrix by the distributed LU:
    ``sign * exp(log|det|)``, as the reference forms it."""
    _, _, sign, logdet, _, _ = _lu_factor(a)
    val = sign * torch.exp(logdet).to(sign.dtype)
    return DNDarray.from_dense(val, None, a.device, a.comm)


# ----------------------------------------------------------------------
# blocked substitution over the distributed factors
# ----------------------------------------------------------------------
def _lu_solve(comm, lu_loc: torch.Tensor, b_loc: torch.Tensor, phys_of_log: torch.Tensor) -> torch.Tensor:
    """This rank's (b, k) rows of ``x`` with ``A x = B``: ``lu_loc`` this
    rank's physical rows of the factors, ``b_loc`` its canonical rows of B."""
    p, r = comm.size, comm.rank
    b, n_pad = lu_loc.shape
    k = b_loc.shape[1]
    dev = lu_loc.device
    mine = torch.arange(r * b, (r + 1) * b, device=dev)
    log_of_phys = torch.empty_like(phys_of_log)
    log_of_phys[phys_of_log] = torch.arange(n_pad, device=dev)
    li = log_of_phys[mine]

    def logical_rows(cols: slice, c0: int) -> torch.Tensor:
        """Logical rows c0..c0+b of the factors' columns ``cols`` (a psum of
        each rank's own rows)."""
        own = torch.nonzero((li >= c0) & (li < c0 + b))[:, 0]
        part = lu_loc[:, cols]
        contrib = part.new_zeros((b, part.shape[1]))
        contrib[li[own] - c0] = part[own]
        return comm.psum(contrib)

    y_loc = b_loc.new_zeros((b, k))
    for j in range(p):  # forward: L y = P B
        c0, c1 = j * b, (j + 1) * b
        src = phys_of_log[c0:c1]
        own = torch.nonzero(src // b == r)[:, 0]
        contrib = b_loc.new_zeros((b, k))
        contrib[own] = b_loc[src[own] - r * b]
        rhs = comm.psum(contrib)
        if j > 0:
            lrow = logical_rows(slice(0, c0), c0)  # (b, c0)
            part = _mm(lrow[:, r * b:(r + 1) * b], y_loc) if r < j else b_loc.new_zeros((b, k))
            rhs = rhs - comm.psum(part)
        ljj = torch.tril(logical_rows(slice(c0, c1), c0), -1) + torch.eye(b, dtype=lu_loc.dtype, device=dev)
        y_blk = torch.linalg.solve_triangular(ljj, rhs, upper=False, unitriangular=True)
        if r == j:
            y_loc = y_blk
    x_loc = b_loc.new_zeros((b, k))
    for j in reversed(range(p)):  # backward: U x = y
        c0, c1 = j * b, (j + 1) * b
        rhs = comm.bcast(y_loc.clone(), root=j)
        if j + 1 < p:
            urow = logical_rows(slice(c1, n_pad), c0)  # (b, n_pad - c1)
            part = _mm(urow[:, r * b - c1:(r + 1) * b - c1], x_loc) if r > j else b_loc.new_zeros((b, k))
            rhs = rhs - comm.psum(part)
        ujj = torch.triu(logical_rows(slice(c0, c1), c0))
        x_blk = torch.linalg.solve_triangular(ujj, rhs, upper=True)
        if r == j:
            x_loc = x_blk
    return x_loc


def solve_dist(a: DNDarray, bb: DNDarray) -> DNDarray:
    """Solve ``a x = bb`` with the distributed LU factors; ``x`` is split
    along rows (a vector where ``bb`` is one)."""
    lu_buf, phys_of_log, _, _, n, _ = _lu_factor(a)
    vec = bb.ndim == 1
    B = bb if bb.split in (0, None) else bb.resplit(0)
    if B.split is None:
        B = DNDarray.from_dense(B.larray, 0, B.device, B.comm, B.dtype)
    if not types.heat_type_is_inexact(B.dtype):
        B = B.astype(types.float32)
    b_loc = B._masked(0).to(lu_buf.dtype)
    b_loc = b_loc.reshape(b_loc.shape[0], -1)
    x = _lu_solve(a.comm, lu_buf, b_loc, phys_of_log)
    k = x.shape[1]
    out = DNDarray(x, (n, k), types.canonical_heat_type(x.dtype), 0, a.device, a.comm)
    return out._like(x[:, 0], (n,), 0) if vec else out


def inv_dist(a: DNDarray) -> DNDarray:
    """The inverse by the distributed LU and blocked substitution against
    the split identity."""
    from .. import factories

    n = a.shape[0]
    dtype = types.float64 if a.dtype == types.float64 else types.float32
    eye = factories.eye(n, comm=a.comm, split=0, dtype=dtype, device=a.device)
    return solve_dist(a, eye)
