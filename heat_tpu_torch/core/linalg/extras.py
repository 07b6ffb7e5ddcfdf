"""The rest of numpy.linalg (counterpart of heat_tpu/core/linalg/extras.py).

Everything runs on the dense view of its operands through ``torch.linalg``
(cuSOLVER and cuBLAS on the card), on the operands' own device: ``eig`` and
``eigvals`` too, where the JAX package moves to the CPU because XLA's TPU
has no general eigensolver.  A split square matrix takes the distributed
factorizations (``cholesky``, ``solve``); a tall matrix split along rows
takes the TS-QR route in ``lstsq`` and ``pinv``, with only the small R
replicated.  A result's split follows the JAX package's placement rule
(:func:`_auto_split`).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..dndarray import DNDarray
from .basics import _mm

__all__ = [
    "cholesky",
    "cond",
    "eig",
    "eigh",
    "eigvals",
    "eigvalsh",
    "lstsq",
    "matrix_power",
    "matrix_rank",
    "multi_dot",
    "pinv",
    "slogdet",
    "solve",
    "tensorinv",
    "tensorsolve",
]


def _d(x) -> torch.Tensor:
    """The dense tensor of an operand, integers and bools as float32."""
    if isinstance(x, DNDarray):
        d = x._dense()
    else:
        d = torch.as_tensor(np.asarray(x))
    if not (d.is_floating_point() or d.is_complex()):
        d = d.to(torch.float32)
    return d


def _ref(*xs) -> Optional[DNDarray]:
    for x in xs:
        if isinstance(x, DNDarray):
            return x
    return None


def _auto_split(result: torch.Tensor, ref: DNDarray) -> Optional[int]:
    """The split of a dense result derived from ``ref`` (the JAX package's
    ``napi._auto_split``): ``ref``'s split where the shape, or the split
    axis's extent at its place, survived; else the largest axis where it
    has at least one row per rank; else none."""
    if ref.split is None:
        return None
    shape = tuple(result.shape)
    if shape == tuple(ref.shape):
        return ref.split
    if ref.split < result.ndim and shape[ref.split] == ref.shape[ref.split]:
        return ref.split
    if result.ndim:
        axis = int(np.argmax(shape))
        if shape[axis] >= ref.comm.size:
            return axis
    return None


def _wrap(result: torch.Tensor, *operands) -> DNDarray:
    ref = _ref(*operands)
    if ref is None:
        return DNDarray.from_dense(result, None)
    return DNDarray.from_dense(result, _auto_split(result, ref), ref.device, ref.comm)


def cholesky(a):
    """The lower-triangular Cholesky factor of an SPD matrix; a split
    square matrix on more than one rank by the distributed blocked
    Cholesky (rows stay split)."""
    from .factorizations import cholesky_dist, supports_dist_factor

    if isinstance(a, DNDarray) and supports_dist_factor(a):
        return cholesky_dist(a)
    return _wrap(torch.linalg.cholesky(_d(a)), a)


def cond(x, p=None):
    """The condition number with respect to the norm ``p``."""
    return _wrap(torch.linalg.cond(_d(x), p=p), x)


def eigh(a, UPLO: str = "L"):
    """Eigenvalues and eigenvectors of a symmetric (Hermitian) matrix."""
    w, v = torch.linalg.eigh(_d(a), UPLO=UPLO)
    return _wrap(w, a), _wrap(v, a)


def eigvalsh(a, UPLO: str = "L"):
    """Eigenvalues of a symmetric (Hermitian) matrix."""
    return _wrap(torch.linalg.eigvalsh(_d(a), UPLO=UPLO), a)


def eig(a):
    """Eigenvalues and eigenvectors of a general matrix (complex), on the
    operand's device."""
    w, v = torch.linalg.eig(_d(a))
    return _wrap(w, a), _wrap(v, a)


def eigvals(a):
    """Eigenvalues of a general matrix (complex), on the operand's device."""
    return _wrap(torch.linalg.eigvals(_d(a)), a)


def _qr_full_rank(r_small: torch.Tensor) -> bool:
    """Whether R's diagonal shows full rank numerically (one small host
    read): the TS-QR routes hold only at full rank."""
    rd = torch.abs(torch.diagonal(r_small)).cpu()
    n = rd.shape[0]
    eps = torch.finfo(r_small.dtype).eps
    return bool(rd.min() > rd.max() * eps * max(n, 1) * 16)


def _tall_split0(a) -> bool:
    """A tall matrix split along rows on more than one rank, each rank
    holding at least as many rows as there are columns."""
    return (isinstance(a, DNDarray) and a.ndim == 2 and a.split == 0 and a.comm.size > 1
            and a.shape[0] // a.comm.size >= a.shape[1])


def lstsq(a, b, rcond=None):
    """The least-squares solution of ``a x = b``: ``(x, residuals, rank,
    singular values)``, JAX's contract (the residuals always given).  A tall
    row-split system takes the TS-QR, ``x = R^-1 Q^T b`` with only the small
    R replicated, where R shows full rank; anything else the SVD."""
    ref = _ref(a, b)
    if rcond is None and _tall_split0(a) and isinstance(b, DNDarray):
        from .. import arithmetics
        from . import basics
        from .qr import qr as ht_qr

        q, rm = ht_qr(a)
        r_small = rm._dense()
        if _qr_full_rank(r_small):
            qtb = basics.matmul(basics.transpose(q), b)._dense()  # a local product and one all-reduce
            x = torch.linalg.solve_triangular(r_small, qtb[:, None] if b.ndim == 1 else qtb, upper=True)
            if b.ndim == 1:
                x = x[:, 0]
            # the residual from each rank's rows, one all-reduce: A is not gathered
            diff = b - basics.matmul(a, DNDarray.from_dense(x, None, a.device, a.comm))
            resid = arithmetics.sum(diff * diff, axis=0)._dense()
            resid = resid.reshape(1) if b.ndim == 1 else resid
            rank = torch.tensor(a.shape[1], dtype=torch.int64)
            sv = torch.linalg.svdvals(r_small)
            return _wrap(x, ref), _wrap(resid, ref), _wrap(rank, ref), _wrap(sv, ref)
    A, B = _d(a), _d(b)
    dtype = torch.promote_types(A.dtype, B.dtype)
    A, B = A.to(dtype), B.to(dtype)
    vec = B.ndim == 1
    if vec:
        B = B[:, None]
    m, n = A.shape
    if rcond is None:
        rcond = torch.finfo(dtype).eps * max(n, m)
    elif rcond < 0:
        rcond = torch.finfo(dtype).eps
    u, s, vh = torch.linalg.svd(A, full_matrices=False)
    mask = (s > 0) & (s >= rcond * s[0])
    rank = mask.sum()
    s_inv = torch.where(mask, 1 / torch.where(mask, s, torch.ones_like(s)), torch.zeros_like(s)).to(dtype)
    x = _mm(vh.mH, s_inv[:, None] * _mm(u.mH, B))
    resid = torch.linalg.vector_norm(B - _mm(A, x), dim=0) ** 2
    if vec:
        x = x.reshape(-1)
    return _wrap(x, ref), _wrap(resid, ref), _wrap(rank, ref), _wrap(s, ref)


def matrix_power(a, n: int):
    """The matrix raised to the integer power ``n``."""
    return _wrap(torch.linalg.matrix_power(_d(a), n), a)


def matrix_rank(a, tol=None):
    """The rank by the singular values above ``tol`` times the largest
    (by default the dtype's epsilon times the larger extent)."""
    return _wrap(torch.linalg.matrix_rank(_d(a), rtol=tol), a)


def multi_dot(arrays):
    """The chained matrix product in the cheapest association order."""
    return _wrap(torch.linalg.multi_dot([_d(x) for x in arrays]), *list(arrays))


def pinv(a, rcond=None, hermitian: bool = False):
    """The Moore-Penrose pseudo-inverse: singular values at or below
    ``rcond`` times the largest dropped (by default JAX's 10 max(m, n)
    eps).  A tall full-rank row-split matrix: ``R^-1 Q^T`` over the TS-QR,
    Q staying split."""
    if rcond is None and not hermitian and _tall_split0(a):
        from . import basics
        from .qr import qr as ht_qr

        q, rm = ht_qr(a)
        r_small = rm._dense()
        if _qr_full_rank(r_small):
            rinv = DNDarray.from_dense(torch.linalg.inv(r_small), None, a.device, a.comm)
            return basics.matmul(rinv, basics.transpose(q))
    A = _d(a)
    if rcond is None:
        rcond = 10.0 * max(A.shape[-2:]) * torch.finfo(A.dtype).eps
    return _wrap(torch.linalg.pinv(A, rtol=rcond, hermitian=hermitian), a)


def slogdet(a):
    """The sign and the log of the absolute value of the determinant."""
    sign, logabs = torch.linalg.slogdet(_d(a))
    return _wrap(sign, a), _wrap(logabs, a)


def solve(a, b):
    """The solution of ``a x = b``: a split square ``a`` on more than one
    rank by the distributed LU and blocked substitution, anything else by
    ``torch.linalg.solve``."""
    from .factorizations import solve_dist, supports_dist_factor

    if isinstance(a, DNDarray) and supports_dist_factor(a) and isinstance(b, DNDarray) and b.ndim in (1, 2):
        return solve_dist(a, b)
    A, B = _d(a), _d(b)
    dtype = torch.promote_types(A.dtype, B.dtype)
    return _wrap(torch.linalg.solve(A.to(dtype), B.to(dtype)), _ref(a, b))


def tensorinv(a, ind: int = 2):
    """The inverse of an N-D array taken as a matrix over its first ``ind``
    axes."""
    return _wrap(torch.linalg.tensorinv(_d(a), ind=ind), a)


def tensorsolve(a, b, axes=None):
    """The solution ``x`` of ``tensordot(a, x, x.ndim) = b``."""
    A, B = _d(a), _d(b)
    dtype = torch.promote_types(A.dtype, B.dtype)
    return _wrap(torch.linalg.tensorsolve(A.to(dtype), B.to(dtype), dims=axes), _ref(a, b))
