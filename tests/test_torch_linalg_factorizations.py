"""The port's ``cholesky``, ``det``, ``inv`` and ``solve`` of square matrices
against heat_tpu on the same seeded numpy inputs, at the reference test's
tolerances (tests/test_factorizations.py: float64 rtol 1e-8, atol 1e-8 or
1e-9; the determinant relative 1e-8; an exact zero row gives exactly 0).

The port runs on one CPU rank, where ``supports_dist_factor`` sends every
matrix to torch.linalg; the reference runs its distributed factorizations
on the suite's 8 devices.  The port's distributed routes (blocked Cholesky,
the LU with partial pivoting, the blocked substitution) run in the gloo
world of tests/test_torch_gloo.py.  A result's split depends on the route,
so it is held against the reference on a world of one, as the port's."""

import jax
import numpy as np
import pytest

import heat_tpu as hj
import heat_tpu_torch as ht
from heat_tpu_torch.core.linalg import factorizations


@pytest.fixture(autouse=True)
def _port_on_cpu():
    ht.use_device("cpu")


ONE = None


def _one():
    global ONE
    if ONE is None:
        ONE = hj.Communication(jax.devices()[:1])
    return ONE


def _spd(n, seed):
    a = np.random.default_rng(seed).standard_normal((n, n))
    return a @ a.T + n * np.eye(n)


@pytest.mark.parametrize("n", [32, 35])
@pytest.mark.parametrize("split", [None, 0, 1])
def test_cholesky(n, split):
    A = _spd(n, n)
    got = ht.linalg.cholesky(ht.array(A, split=split))
    np.testing.assert_allclose(got.numpy(), np.linalg.cholesky(A), rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(got.numpy(), hj.linalg.cholesky(hj.array(A, split=split)).numpy(), rtol=1e-8,
                               atol=1e-8)
    assert got.split == hj.linalg.cholesky(hj.array(A, split=split, comm=_one())).split
    f32 = ht.linalg.cholesky(ht.array(A.astype(np.float32), split=split))
    assert f32.dtype == ht.float32
    np.testing.assert_allclose(f32.numpy(), np.linalg.cholesky(A), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n", [32, 33, 35])
def test_det(n):
    A = np.random.default_rng(n).standard_normal((n, n))
    want = np.linalg.det(A)
    for split in (None, 0, 1):
        d = ht.linalg.det(ht.array(A, split=split))
        assert d.dtype == ht.float64 and d.shape == ()
        assert abs(float(d) - want) / max(abs(want), 1e-12) < 1e-8
        np.testing.assert_allclose(float(d), float(hj.linalg.det(hj.array(A, split=split))), rtol=1e-8)
    B = A.copy()
    B[[0, 1]] = B[[1, 0]]
    np.testing.assert_allclose(float(ht.linalg.det(ht.array(B, split=0))), -want, rtol=1e-8)


def test_det_singular_ties_batches_and_integers():
    A = np.random.default_rng(0).standard_normal((32, 32))
    A[2] = 0.0
    assert float(ht.linalg.det(ht.array(A, split=0))) == 0.0
    # equal pivot candidates: the first maximal row is the pivot, as LAPACK's
    # and jax.lax.linalg.lu's, so the sign is the reference's
    T = np.array([[1.0, 2.0, 0.0, 1.0], [-1.0, 0.0, 3.0, 2.0], [1.0, -2.0, 1.0, 0.0], [-1.0, 1.0, 2.0, 5.0]])
    for split in (None, 0):
        got, want = float(ht.linalg.det(ht.array(T, split=split))), float(hj.linalg.det(hj.array(T, split=split)))
        assert np.sign(got) == np.sign(want) == np.sign(np.linalg.det(T))
        np.testing.assert_allclose(got, want, rtol=1e-12)
    batch = np.random.default_rng(1).standard_normal((3, 4, 4))
    for split in (None, 0):
        got, want = ht.linalg.det(ht.array(batch, split=split)), hj.linalg.det(hj.array(batch, split=split))
        assert got.split == want.split
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-10)
    ints = np.array([[2, 1], [1, 3]], np.int32)
    got = ht.linalg.det(ht.array(ints))
    assert got.dtype.__name__ == hj.linalg.det(hj.array(ints)).dtype.__name__ == "float32"
    np.testing.assert_allclose(float(got), 5.0, rtol=1e-6)
    with pytest.raises(RuntimeError):
        ht.linalg.det(ht.array(np.ones((3, 4))))
    with pytest.raises(RuntimeError):
        ht.linalg.inv(ht.array(np.ones(4)))


@pytest.mark.parametrize("n", [32, 33])
@pytest.mark.parametrize("split", [None, 0, 1])
def test_inv_and_solve(n, split):
    rng = np.random.default_rng(n)
    A = rng.standard_normal((n, n)) + n * np.eye(n)
    inv = ht.linalg.inv(ht.array(A, split=split))
    np.testing.assert_allclose(inv.numpy(), np.linalg.inv(A), rtol=1e-8, atol=1e-9)
    assert inv.split == hj.linalg.inv(hj.array(A, split=split, comm=_one())).split
    b = rng.standard_normal((n, 3))
    x = ht.linalg.solve(ht.array(A, split=split), ht.array(b, split=0))
    np.testing.assert_allclose(x.numpy(), np.linalg.solve(A, b), rtol=1e-8, atol=1e-9)
    np.testing.assert_allclose(x.numpy(), hj.linalg.solve(hj.array(A, split=split), hj.array(b, split=0)).numpy(),
                               rtol=1e-8, atol=1e-9)
    bv = rng.standard_normal(n)
    xv = ht.linalg.solve(ht.array(A, split=split), ht.array(bv, split=0))
    assert xv.shape == (n,)
    np.testing.assert_allclose(xv.numpy(), np.linalg.solve(A, bv), rtol=1e-8, atol=1e-9)


def test_ipiv_permutation_and_the_gate():
    # LAPACK's 1-based interchanges 3, 3, 3 on 4 rows: swap 0<->2, 1<->2, then 2 stays
    perm = factorizations._ipiv_permutation(np.array([3, 3, 3]), 4)
    rows = np.arange(4)
    for i, t in enumerate([2, 2, 2]):
        rows[[i, t]] = rows[[t, i]]
    np.testing.assert_array_equal(perm, rows)
    sq = ht.array(np.eye(4), split=0)
    assert not factorizations.supports_dist_factor(sq)  # a world of one
    assert not factorizations.supports_dist_factor(ht.array(np.ones((4, 3)), split=0))
