"""Exact SVD (counterpart of heat_tpu/core/linalg/svd.py).

A tall matrix split along rows goes through :func:`qr` (TS-QR over more
than one rank) and the SVD of the small R; a short-fat matrix split along
columns through its transpose; anything else through ``torch.linalg.svd``
of the dense view.  Returns ``SVD(U, S, V)`` with ``A = U diag(S) V^T``
(V, not V^H, as the reference).
"""

from __future__ import annotations

import collections

import torch

from .. import types
from ..dndarray import DNDarray
from ..sanitation import sanitize_in
from .basics import matmul, transpose
from .qr import qr

__all__ = ["svd"]

SVD = collections.namedtuple("SVD", "U, S, V")


def svd(A: DNDarray, full_matrices: bool = False, compute_uv: bool = True, qr_procs_to_merge: int = 2):
    """The thin singular value decomposition ``SVD(U, S, V)``, or ``S``
    alone without ``compute_uv``.  ``full_matrices=True`` raises, as the
    reference's does."""
    sanitize_in(A)
    if full_matrices:
        raise NotImplementedError("full_matrices=True is not supported (as in the reference, svd.py:49)")
    if A.ndim != 2:
        raise ValueError(f"A must be 2-dimensional, but is {A.ndim}-dimensional")
    if not types.heat_type_is_inexact(A.dtype):
        A = A.astype(types.float32)
    m, n = A.shape
    if A.split == 0 and m >= n:
        Q, R = qr(A, mode="reduced", procs_to_merge=qr_procs_to_merge)
        u_r, s, vh = torch.linalg.svd(R._dense(), full_matrices=False)
        S = DNDarray.from_dense(s, None, A.device, A.comm)
        if not compute_uv:
            return S
        U = matmul(Q, DNDarray.from_dense(u_r, None, A.device, A.comm, A.dtype))
        return SVD(U, S, DNDarray.from_dense(vh.mT, None, A.device, A.comm, A.dtype))
    if A.split == 1 and n > m:
        res = svd(transpose(A), full_matrices=full_matrices, compute_uv=compute_uv,
                  qr_procs_to_merge=qr_procs_to_merge)
        return res if not compute_uv else SVD(res.V, res.S, res.U)
    dense = A._dense()
    if not compute_uv:
        return DNDarray.from_dense(torch.linalg.svdvals(dense), None, A.device, A.comm)
    u, s, vh = torch.linalg.svd(dense, full_matrices=False)
    return SVD(
        DNDarray.from_dense(u, 0 if A.split == 0 else None, A.device, A.comm, A.dtype),
        DNDarray.from_dense(s, None, A.device, A.comm),
        DNDarray.from_dense(vh.mT, 1 if A.split == 1 else None, A.device, A.comm, A.dtype),
    )
