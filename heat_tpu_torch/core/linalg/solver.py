"""Iterative and triangular solvers (counterpart of
heat_tpu/core/linalg/solver.py).

``cg`` and ``lanczos`` run on the dense operator on its device, products in
IEEE float32 (the JAX package's ``Precision.HIGHEST``).  The JAX package
runs each as one compiled loop; here the loop is a Python loop of device
operations that reads nothing back per step: ``cg`` freezes its carry with
``torch.where`` once the stop test holds and looks at the test on the host
only every :data:`_CG_CHECK_EVERY` steps, so ``x`` is the one the
reference's ``while_loop`` returns.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import types
from ..dndarray import DNDarray
from ..sanitation import sanitize_in, store_out
from .basics import full_f32_matmul

__all__ = ["cg", "lanczos", "solve_triangular"]

_CG_CHECK_EVERY = 16  # CG steps between host reads of the stop test
#: steps the last ``cg`` call took while its stop test held (its work)
CG_STEPS = 0


def _cg_loop(A: torch.Tensor, b: torch.Tensor, x0: torch.Tensor, max_iter: int) -> torch.Tensor:
    """Conjugate gradients while ``it < max_iter`` and ``sqrt(rs) >= 1e-10``
    (the reference's stop test, solver.py:46)."""
    global CG_STEPS
    with full_f32_matmul():
        r = b - A @ x0
        x, p, rs = x0, r, torch.vdot(r, r)
        taken = torch.zeros((), dtype=torch.int64, device=b.device)
        for it in range(max_iter):
            active = torch.sqrt(rs.real) >= 1e-10
            if it % _CG_CHECK_EVERY == 0 and not bool(active):
                break
            Ap = A @ p
            alpha = rs / torch.vdot(p, Ap)
            x_new = x + alpha * p
            r_new = r - alpha * Ap
            rs_new = torch.vdot(r_new, r_new)
            p_new = r_new + (rs_new / rs) * p
            # once the test fails the carry stays as it was
            x = torch.where(active, x_new, x)
            r = torch.where(active, r_new, r)
            p = torch.where(active, p_new, p)
            rs = torch.where(active, rs_new, rs)
            taken += active
    CG_STEPS = int(taken)
    return x


def cg(A: DNDarray, b: DNDarray, x0: DNDarray, out: Optional[DNDarray] = None) -> DNDarray:
    """Conjugate gradients for a symmetric positive definite system
    ``A x = b`` from ``x0``, at most ``len(b)`` steps."""
    if not isinstance(A, DNDarray) or not isinstance(b, DNDarray) or not isinstance(x0, DNDarray):
        raise TypeError(f"A, b and x0 need to be DNDarrays, but were {type(A)}, {type(b)}, {type(x0)}")
    if A.ndim != 2:
        raise RuntimeError("A needs to be a 2D matrix")
    if b.ndim != 1:
        raise RuntimeError("b needs to be a 1D vector")
    if x0.ndim != 1:
        raise RuntimeError("c needs to be a 1D vector")
    Ad = A._dense()
    if not types.heat_type_is_inexact(A.dtype):
        Ad = Ad.to(torch.float32)
    bd = b._dense().to(Ad.dtype)
    x0d = x0._dense().to(Ad.dtype)
    result = DNDarray.from_dense(_cg_loop(Ad, bd, x0d, len(b)), b.split, b.device, b.comm)
    if out is not None:
        return store_out(result, out)
    return result


def lanczos(
    A: DNDarray,
    m: int,
    v0: Optional[DNDarray] = None,
    V_out: Optional[DNDarray] = None,
    T_out: Optional[DNDarray] = None,
) -> Tuple[DNDarray, DNDarray]:
    """Lanczos tridiagonalisation of a symmetric (Hermitian) matrix: m
    Krylov steps with full reorthogonalisation, ``(V (n, m), T (m, m))``,
    T in float32.  Without ``v0`` the start vector is drawn by
    ``random.randn``, the reference's draw for the same seed."""
    if not isinstance(A, DNDarray):
        raise TypeError(f"A needs to be a DNDarray, but was {type(A)}")
    if not isinstance(m, int) or m <= 0:
        raise TypeError(f"m must be a positive integer, got {m}")
    if A.ndim != 2 or A.shape[0] != A.shape[1]:
        raise RuntimeError("A needs to be a square matrix")
    n = A.shape[0]
    dense = A._dense()
    is_complex = types.heat_type_is_complexfloating(A.dtype)
    if v0 is None:
        from .. import random as ht_random

        v = ht_random.randn(n, dtype=types.float32, device=A.device, comm=A.comm)._dense().to(dense.dtype)
        v = v / torch.linalg.vector_norm(v)
    else:
        v = v0._dense().to(dense.dtype)
    V, T = _lanczos_loop(dense, v, m, is_complex)
    V_res = DNDarray.from_dense(V, A.split, A.device, A.comm)
    T_res = DNDarray.from_dense(T, None, A.device, A.comm)
    if V_out is not None:
        V_res = store_out(V_res, V_out)
    if T_out is not None:
        T_res = store_out(T_res, T_out)
    return V_res, T_res


def _lanczos_loop(A: torch.Tensor, v: torch.Tensor, m: int, is_complex: bool):
    """The Krylov loop; each step projects against the whole (n, m) basis,
    whose unfilled columns are zero (the reference's fixed-shape form)."""
    n = A.shape[0]
    V = torch.zeros((n, m), dtype=A.dtype, device=A.device)
    V[:, 0] = v
    T = torch.zeros((m, m), dtype=torch.float32, device=A.device)
    beta = torch.zeros((), dtype=V.real.dtype if is_complex else A.dtype, device=A.device)
    v_prev = torch.zeros_like(v)

    def alpha_of(vj, w):
        a = torch.vdot(vj, w)
        return a.real if is_complex else a

    with full_f32_matmul():
        for j in range(m - 1):
            vj = V[:, j].clone()
            w = A @ vj
            alpha = alpha_of(vj, w)
            w = w - alpha * vj - beta * v_prev
            w = w - V @ (V.conj().T @ w)
            T[j, j] = alpha.to(torch.float32)
            beta_new = torch.linalg.vector_norm(w)
            T[j, j + 1] = beta_new.to(torch.float32)
            T[j + 1, j] = beta_new.to(torch.float32)
            V[:, j + 1] = torch.where(beta_new > 1e-10, w / torch.clamp(beta_new, min=1e-30).to(A.dtype), w)
            beta, v_prev = beta_new, vj
        vj = V[:, m - 1]
        T[m - 1, m - 1] = alpha_of(vj, A @ vj).to(torch.float32)
    return V, T


def solve_triangular(A: DNDarray, b: DNDarray) -> DNDarray:
    """Solve ``A x = b`` for an upper-triangular ``A`` (or a batch of them);
    ``b`` a matrix, or a vector for a 2-D ``A``."""
    sanitize_in(A)
    sanitize_in(b)
    if A.ndim < 2 or A.shape[-1] != A.shape[-2]:
        raise ValueError("A must be a (batch of) square upper triangular matrix")
    a_dense, b_dense = A._dense(), b._dense()
    if not types.heat_type_is_inexact(A.dtype):
        a_dense, b_dense = a_dense.to(torch.float32), b_dense.to(torch.float32)
    dtype = torch.promote_types(a_dense.dtype, b_dense.dtype)
    vec = b_dense.ndim == A.ndim - 1
    rhs = b_dense[..., None] if vec else b_dense
    result = torch.linalg.solve_triangular(a_dense.to(dtype), rhs.to(dtype), upper=True)
    if vec:
        result = result[..., 0]
    return DNDarray.from_dense(result, b.split, b.device, b.comm)
