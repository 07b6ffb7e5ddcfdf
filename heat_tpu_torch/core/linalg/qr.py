"""QR decomposition (counterpart of heat_tpu/core/linalg/qr.py).

Three routes, chosen by the JAX package's gates:

* **TS-QR** for a 2-D matrix split along rows over more than one rank,
  each rank holding at least as many padded rows as there are columns:
  every rank factors its own rows (the canonical padding rows zeroed, so
  they drop out), one ``all_gather`` brings the p (n, n) R factors to every
  rank, each rank factors their stack (the same bits everywhere: the same
  inputs through the same solver), and corrects its local Q by its block of
  that Q.  Only the p small R factors travel; the matrix stays where it is.
* **Block modified Gram-Schmidt** for a matrix split along columns over
  more than one rank with m >= n: in round i rank i orthonormalises its
  column block (padded columns zeroed) and broadcasts it (``comm.bcast``),
  and every later rank projects it out of its own columns at once (the
  right-looking, stabilised order).
* Otherwise ``torch.linalg.qr`` of the dense view, with the JAX package's
  output splits.

Float32 products run in IEEE float32 (no TF32), as the JAX package's run
at ``Precision.HIGHEST``.
"""

from __future__ import annotations

import collections

import torch

from .. import types
from ..dndarray import DNDarray
from ..sanitation import sanitize_in
from .basics import _mm

__all__ = ["qr"]

QR = collections.namedtuple("QR", "Q, R")


def qr(A: DNDarray, mode: str = "reduced", procs_to_merge: int = 2) -> QR:
    """The reduced QR decomposition of a 2-D (or batched) array:
    ``QR(Q, R)``, with ``Q`` None for ``mode="r"``.  ``procs_to_merge`` is
    accepted for the reference's signature; the R factors merge in one
    round."""
    sanitize_in(A)
    if mode not in ("reduced", "r"):
        raise ValueError(f"mode must be 'reduced' or 'r', got {mode!r}")
    if A.ndim < 2:
        raise ValueError(f"Array A must be at least two-dimensional, but is {A.ndim}-dimensional")
    if not types.heat_type_is_realfloating(A.dtype) and not types.heat_type_is_complexfloating(A.dtype):
        A = A.astype(types.float32)
    m, n = A.shape[-2], A.shape[-1]
    comm = A.comm
    p = comm.size
    if A.ndim == 2 and A.split == 0 and p > 1 and comm.padded_extent(m) // p >= n:
        q_loc, r = _tsqr(A, mode == "reduced")
        R = DNDarray(r, (n, n), A.dtype, None, A.device, comm)
        return QR(None if mode == "r" else A._like(q_loc, (m, n), 0, A.dtype), R)
    if A.ndim == 2 and A.split == 1 and p > 1 and m >= n:
        q_loc, r_loc = _block_gram_schmidt(A)
        R = A._like(r_loc, (n, n), 1, A.dtype)
        return QR(None if mode == "r" else A._like(q_loc, (m, n), 1, A.dtype), R)
    # the dense view: wide split=1 matrices, batches, a world of one
    dense = A._dense()
    if mode == "r":
        r = torch.linalg.qr(dense, mode="r").R
        return QR(None, DNDarray.from_dense(r, None if A.ndim == 2 else A.split, A.device, comm, A.dtype))
    q, r = torch.linalg.qr(dense, mode="reduced")
    r_split = A.split
    if A.ndim == 2 and A.split == 0:
        r_split = None
    return QR(DNDarray.from_dense(q, A.split, A.device, comm, A.dtype),
              DNDarray.from_dense(r, r_split, A.device, comm, A.dtype))


def _tsqr(A: DNDarray, compute_q: bool):
    """One level of TS-QR: ``(local Q rows, R)``, R the same on every rank."""
    comm = A.comm
    n = A.shape[1]
    a_loc = A._masked(0)  # the canonical padding rows drop out of both QRs
    q1, r1 = torch.linalg.qr(a_loc, mode="reduced")  # (rows, n), (n, n)
    r_all = comm.all_gather(r1.contiguous(), axis=0)  # (p n, n)
    q2, r2 = torch.linalg.qr(r_all, mode="reduced" if compute_q else "r")
    if not compute_q:
        return None, r2
    return _mm(q1, q2[comm.rank * n:(comm.rank + 1) * n]), r2


def _block_gram_schmidt(A: DNDarray):
    """Block modified Gram-Schmidt over column blocks: ``(local Q columns,
    local R columns)`` of the (m, n) Q and the (n, n) R, both split along
    columns."""
    comm = A.comm
    m, n = A.shape
    p, rank = comm.size, comm.rank
    nb = A.larray_padded.shape[1]
    a_cur = A._masked(0)  # padded columns project nothing
    lo = rank * nb
    colmask = (torch.arange(lo, lo + nb, device=a_cur.device) < n).to(a_cur.dtype)
    q_loc = torch.zeros_like(a_cur)
    r_loc = torch.zeros((p * nb, nb), dtype=a_cur.dtype, device=a_cur.device)
    for i in range(p):
        if rank == i:
            qi, rii = torch.linalg.qr(a_cur, mode="reduced")  # (m, nb), (nb, nb)
            # a padded column has a zero R column but an arbitrary Q column
            qi = qi * colmask[None, :]
            q_loc = qi
            r_loc[i * nb:(i + 1) * nb] = rii * colmask[None, :]
        else:
            qi = torch.empty_like(a_cur)
        qi = comm.bcast(qi.contiguous(), root=i)
        if rank > i:
            rij = _mm(qi.mH, a_cur)
            a_cur = a_cur - _mm(qi, rij)
            r_loc[i * nb:(i + 1) * nb] = rij
    # rows of R past the true column count are zero: cut to the global extent
    return q_loc, r_loc[:n]
