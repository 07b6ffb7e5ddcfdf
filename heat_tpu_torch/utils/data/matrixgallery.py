"""Test matrices (counterpart of heat_tpu/utils/data/matrixgallery.py):
the same draws of ``random`` (bitwise the reference's), then torch's
products and factorizations, so the matrices hold the reference's
invariants (Hermitian, orthonormal columns, the given singular values or
rank) within rounding."""

from __future__ import annotations

from typing import Tuple

import torch

from ...core import factories, random, types
from ...core.dndarray import DNDarray
from ...core.linalg.basics import full_f32_matmul

__all__ = ["hermitian", "parter", "random_known_rank", "random_known_singularvalues", "random_orthogonal"]


def hermitian(n: int, dtype=types.complex64, split=None, device=None, comm=None,
              positive_definite: bool = False) -> DNDarray:
    """A random Hermitian matrix (heat's matrixgallery.py:19); with
    ``positive_definite`` ``a a^H + n I``."""
    dtype = types.canonical_heat_type(dtype)
    if types.heat_type_is_complexfloating(dtype):
        re = random.randn(n, n, device=device, comm=comm)._dense()
        im = random.randn(n, n, device=device, comm=comm)._dense()
        a = torch.complex(re, im).to(dtype.torch_type())
    else:
        a = random.randn(n, n, device=device, comm=comm)._dense().to(dtype.torch_type())
    with full_f32_matmul():
        if positive_definite:
            h = a @ a.conj().T + n * torch.eye(n, dtype=a.dtype, device=a.device)
        else:
            h = (a + a.conj().T) / 2
    return DNDarray.from_dense(h, split, device, comm)


def parter(n: int, split=None, device=None, comm=None) -> DNDarray:
    """The Parter matrix ``1 / (i - j + 0.5)`` (heat's matrixgallery.py:60)."""
    i = torch.arange(n, dtype=torch.float32)[:, None]
    j = torch.arange(n, dtype=torch.float32)[None, :]
    return factories.array(1.0 / (i - j + 0.5), split=split, device=device, comm=comm)


def random_orthogonal(m: int, n: int, split=None, device=None, comm=None) -> DNDarray:
    """A random m x n matrix of orthonormal columns (heat's
    matrixgallery.py:90): the Q of a normal draw."""
    if m < n:
        raise ValueError(f"m must be >= n, got {m} < {n}")
    a = random.randn(m, n, device=device, comm=comm)._dense()
    q, _ = torch.linalg.qr(a)
    return DNDarray.from_dense(q, split, device, comm)


def random_known_singularvalues(m: int, n: int, singular_values, split=None, device=None, comm=None,
                                dtype=types.float32) -> Tuple[DNDarray, Tuple[DNDarray, DNDarray, DNDarray]]:
    """A random matrix ``U diag(s) V^T`` with the given singular values and
    its factors (heat's matrixgallery.py:130)."""
    sv = singular_values._dense() if isinstance(singular_values, DNDarray) else torch.as_tensor(singular_values)
    k = sv.shape[0]
    if k > min(m, n):
        raise ValueError(f"number of singular values ({k}) must be <= min(m, n)")
    U = random_orthogonal(m, k, device=device, comm=comm)
    V = random_orthogonal(n, k, device=device, comm=comm)
    u, v = U._dense(), V._dense()
    with full_f32_matmul():
        a = ((u * sv.to(u.device, u.dtype)[None, :]) @ v.T).to(types.canonical_heat_type(dtype).torch_type())
    return DNDarray.from_dense(a, split, device, comm), (U, factories.array(sv, device=device, comm=comm), V)


def random_known_rank(m: int, n: int, rank: int, quantile_function=None, split=None, device=None, comm=None,
                      dtype=types.float32) -> Tuple[DNDarray, Tuple[DNDarray, DNDarray, DNDarray]]:
    """A random matrix of the given rank (heat's matrixgallery.py:170):
    singular values ``quantile_function`` of uniform draws (by default
    ``-log(u)``), sorted descending."""
    if rank > min(m, n):
        raise ValueError(f"rank must be <= min(m, n), got {rank}")
    u = random.rand(rank, device=device, comm=comm)._dense()
    if quantile_function is None:
        sv = -torch.log(torch.clamp(u, min=1e-30))
    else:
        sv = torch.tensor([quantile_function(float(x)) for x in u.cpu()], device=u.device)
    sv = torch.sort(sv, descending=True).values
    return random_known_singularvalues(m, n, sv, split=split, device=device, comm=comm, dtype=dtype)
