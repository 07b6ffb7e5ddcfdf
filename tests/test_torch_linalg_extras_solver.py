"""The port's 15 numpy.linalg extras and its solvers (``cg``, ``lanczos``,
``solve_triangular``) against heat_tpu on the same seeded numpy inputs.

Tolerances are the reference tests' (tests/test_linalg_extras_io.py,
tests/test_linalg.py:176-198, tests/test_types_linalg_sweep.py:103-118):
float64 rtol 1e-10 for eigenvalues, products and slogdet, 1e-8 for the
solves and lstsq, 1e-6 for pinv, cond and tensorinv, the general
eigenvalues rtol 1e-4/atol 1e-5; eigenvectors up to a per-column sign;
ranks bitwise.  ``lanczos`` draws its start vector through the port's
``random.randn``, bitwise the reference's for the same seed, so V and T are
compared entry by entry (float32 rtol 1e-4, atol 1e-4, the Krylov
recurrence's rounding over 24 steps)."""

import jax
import numpy as np
import pytest

import heat_tpu as hj
import heat_tpu_torch as ht


@pytest.fixture(autouse=True)
def _port_on_cpu():
    ht.use_device("cpu")


@pytest.fixture(scope="module")
def spd():
    a = np.random.default_rng(0).standard_normal((5, 5))
    return a @ a.T + 5 * np.eye(5)


def _same(got, want, rtol, atol=0.0, sign_free=False, split=True):
    assert got.dtype.__name__ == want.dtype.__name__, (got.dtype, want.dtype)
    assert got.shape == want.shape and (not split or got.split == want.split), (got.split, want.split)
    g, w = got.numpy(), np.asarray(want.numpy())
    if sign_free:
        s = np.sign(np.sum(g * w, axis=0))
        s[s == 0] = 1
        g = g * s
    np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)


@pytest.mark.parametrize("split", [None, 0])
def test_cholesky_solve_pinv(spd, split):
    a, r = ht.array(spd, split=split), hj.array(spd, split=split)
    L = ht.linalg.cholesky(a).numpy()
    np.testing.assert_allclose(L @ L.T, spd, rtol=1e-10)
    b = np.arange(5.0)
    _same(ht.linalg.solve(a, ht.array(b)), hj.linalg.solve(r, hj.array(b)), rtol=1e-8)
    np.testing.assert_allclose(ht.linalg.solve(a, ht.array(b)).numpy(), np.linalg.solve(spd, b), rtol=1e-8)
    np.testing.assert_allclose(ht.linalg.pinv(a).numpy(), np.linalg.pinv(spd), rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(ht.linalg.pinv(a).numpy(), hj.linalg.pinv(r).numpy(), rtol=1e-6, atol=1e-8)


def test_eigh_eig_family(spd):
    a, r = ht.array(spd), hj.array(spd)
    w, v = ht.linalg.eigh(a)
    rw, rv = hj.linalg.eigh(r)
    _same(w, rw, rtol=1e-10)
    _same(v, rv, rtol=1e-8, atol=1e-10, sign_free=True)
    _same(ht.linalg.eigvalsh(a), hj.linalg.eigvalsh(r), rtol=1e-10)
    _same(ht.linalg.eigh(a, UPLO="U")[0], hj.linalg.eigh(r, UPLO="U")[0], rtol=1e-10)
    g = np.random.default_rng(1).standard_normal((4, 4))
    wg, vg = ht.linalg.eig(ht.array(g))
    assert wg.dtype == ht.complex128 and vg.dtype == ht.complex128
    np.testing.assert_allclose(np.sort_complex(wg.numpy()), np.sort_complex(np.linalg.eigvals(g)), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(g @ vg.numpy(), vg.numpy() * wg.numpy()[None, :], atol=1e-10)
    np.testing.assert_allclose(np.sort_complex(ht.linalg.eigvals(ht.array(g)).numpy()),
                               np.sort_complex(hj.linalg.eigvals(hj.array(g)).numpy()), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("split", [None, 0])
def test_lstsq_rank_cond_slogdet_power(spd, split):
    rng = np.random.default_rng(2)
    A = rng.standard_normal((8, 3))
    b = rng.standard_normal(8)
    got = ht.linalg.lstsq(ht.array(A, split=split), ht.array(b, split=split))
    want = hj.linalg.lstsq(hj.array(A, split=split), hj.array(b, split=split))
    np.testing.assert_allclose(got[0].numpy(), np.linalg.lstsq(A, b, rcond=None)[0], rtol=1e-8)
    # the reference's 8 devices take another route (8 rows are too few for
    # its TS-QR there), so the splits are held at the port's world of one
    one = hj.Communication(jax.devices()[:1])
    want_one = hj.linalg.lstsq(hj.array(A, split=split, comm=one), hj.array(b, split=split, comm=one))
    for g, w, w1 in zip(got, want, want_one):
        _same(g, w, rtol=1e-8, split=False)
        assert g.split == w1.split
    B = rng.standard_normal((8, 2))
    for g, w in zip(ht.linalg.lstsq(ht.array(A), ht.array(B)), hj.linalg.lstsq(hj.array(A), hj.array(B))):
        _same(g, w, rtol=1e-8)
    _same(ht.linalg.matrix_rank(ht.array(spd)), hj.linalg.matrix_rank(hj.array(spd)), rtol=0)
    low = A @ rng.standard_normal((3, 6))
    assert int(ht.linalg.matrix_rank(ht.array(low))) == int(hj.linalg.matrix_rank(hj.array(low))) == 3
    _same(ht.linalg.cond(ht.array(spd)), hj.linalg.cond(hj.array(spd)), rtol=1e-6)
    _same(ht.linalg.cond(ht.array(spd), p="fro"), hj.linalg.cond(hj.array(spd), p="fro"), rtol=1e-6)
    for g, w in zip(ht.linalg.slogdet(ht.array(spd, split=split)), hj.linalg.slogdet(hj.array(spd, split=split))):
        _same(g, w, rtol=1e-10)
    _same(ht.linalg.matrix_power(ht.array(spd, split=split), 3), hj.linalg.matrix_power(hj.array(spd, split=split), 3),
          rtol=1e-10)
    _same(ht.linalg.matrix_power(ht.array(spd), -2), hj.linalg.matrix_power(hj.array(spd), -2), rtol=1e-8)


def test_multi_dot_tensor_solve_and_float32():
    rng = np.random.default_rng(3)
    A, B, C = rng.standard_normal((3, 5)), rng.standard_normal((5, 7)), rng.standard_normal((7, 2))
    _same(ht.linalg.multi_dot([ht.array(A), ht.array(B, split=0), ht.array(C)]),
          hj.linalg.multi_dot([hj.array(A), hj.array(B, split=0), hj.array(C)]), rtol=1e-10)
    T = rng.standard_normal((2, 3, 6))
    bb = rng.standard_normal((2, 3))
    _same(ht.linalg.tensorsolve(ht.array(T), ht.array(bb)), hj.linalg.tensorsolve(hj.array(T), hj.array(bb)),
          rtol=1e-8)
    Ti = rng.standard_normal((4, 6, 8, 3))
    _same(ht.linalg.tensorinv(ht.array(Ti), ind=2), hj.linalg.tensorinv(hj.array(Ti), ind=2), rtol=1e-6)
    s32 = (A @ A.T + 3 * np.eye(3)).astype(np.float32)
    _same(ht.linalg.cholesky(ht.array(s32)), hj.linalg.cholesky(hj.array(s32)), rtol=1e-5, atol=1e-6)
    ints = np.array([[4, 1], [1, 3]], np.int32)
    _same(ht.linalg.slogdet(ht.array(ints))[1], hj.linalg.slogdet(hj.array(ints))[1], rtol=1e-6)


def test_cg_matches_the_reference():
    rng = np.random.default_rng(20)
    n = 10
    a = rng.standard_normal((n, n)).astype(np.float32)
    spd = (a @ a.T + n * np.eye(n)).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    got = ht.linalg.cg(ht.array(spd, split=0), ht.array(b, split=0), ht.zeros(n, split=0))
    want = hj.linalg.cg(hj.array(spd, split=0), hj.array(b, split=0), hj.zeros(n, split=0))
    np.testing.assert_allclose(spd @ got.numpy(), b, rtol=1e-3, atol=1e-3)
    _same(got, want, rtol=1e-5, atol=1e-6)
    sq = np.random.default_rng(4).standard_normal((6, 6))
    spd64 = sq @ sq.T + 6 * np.eye(6)
    b64 = np.arange(6.0)
    out = ht.zeros(6, dtype=ht.float64)
    got = ht.linalg.cg(ht.array(spd64, split=0), ht.array(b64, split=0), ht.zeros(6), out=out)
    assert got is out
    np.testing.assert_allclose(got.numpy(), np.linalg.solve(spd64, b64), rtol=1e-6, atol=1e-8)
    with pytest.raises(RuntimeError):
        ht.linalg.cg(ht.array(b64), ht.array(b64), ht.array(b64))


def test_cg_stops_where_the_reference_stops(monkeypatch):
    """An exact solve stops the loop early: the frozen carry gives the
    reference's x whatever step the host reads the test at."""
    from heat_tpu_torch.core.linalg import solver

    spd = np.diag(np.arange(1.0, 41.0))
    b = np.ones(40)
    want = hj.linalg.cg(hj.array(spd), hj.array(b), hj.zeros(40, dtype=hj.float64)).numpy()
    for every in (1, 3, 16):
        monkeypatch.setattr(solver, "_CG_CHECK_EVERY", every)
        got = ht.linalg.cg(ht.array(spd), ht.array(b), ht.zeros(40, dtype=ht.float64)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("split", [None, 0])
def test_lanczos_matches_the_reference(split):
    rng = np.random.default_rng(21)
    a = rng.standard_normal((24, 24)).astype(np.float32)
    sym = ((a + a.T) / 2).astype(np.float32)
    ht.random.seed(7)
    hj.random.seed(7)
    V, T = ht.linalg.lanczos(ht.array(sym, split=split), 24)
    rV, rT = hj.linalg.lanczos(hj.array(sym, split=split), 24)
    _same(T, rT, rtol=1e-4, atol=1e-4)
    _same(V, rV, rtol=1e-4, atol=1e-4)
    evals = np.sort(np.linalg.eigvalsh(T.numpy()))
    np.testing.assert_allclose(evals[-3:], np.sort(np.linalg.eigvalsh(sym))[-3:], rtol=1e-2, atol=1e-2)
    v0 = ht.array(np.ones(24, np.float32) / np.sqrt(24.0))
    V_out, T_out = ht.zeros((24, 5), split=split), ht.zeros((5, 5))
    V2, T2 = ht.linalg.lanczos(ht.array(sym, split=split), 5, v0=v0, V_out=V_out, T_out=T_out)
    rV2, rT2 = hj.linalg.lanczos(hj.array(sym, split=split), 5, v0=hj.array(np.ones(24, np.float32) / np.sqrt(24.0)))
    assert V2 is V_out and T2 is T_out
    _same(V2, rV2, rtol=1e-5, atol=1e-6)
    _same(T2, rT2, rtol=1e-5, atol=1e-6)
    with pytest.raises(TypeError):
        ht.linalg.lanczos(ht.array(sym), 0)
    with pytest.raises(RuntimeError):
        ht.linalg.lanczos(ht.array(a[:, :5]), 3)


def test_solve_triangular():
    sq = np.random.default_rng(5).standard_normal((6, 6))
    U = np.triu(sq) + 3 * np.eye(6)
    for b in (np.arange(6.0).reshape(6, 1), np.arange(6.0)):
        got = ht.linalg.solve_triangular(ht.array(U, split=0), ht.array(b, split=0))
        want = hj.linalg.solve_triangular(hj.array(U, split=0), hj.array(b, split=0))
        _same(got, want, rtol=1e-8, atol=1e-10)
        np.testing.assert_allclose(got.numpy(), np.linalg.solve(U, b), rtol=1e-8, atol=1e-10)
    batch = np.triu(np.random.default_rng(6).standard_normal((2, 4, 4))) + 2 * np.eye(4)
    bb = np.ones((2, 4, 3))
    _same(ht.linalg.solve_triangular(ht.array(batch), ht.array(bb, split=2)),
          hj.linalg.solve_triangular(hj.array(batch), hj.array(bb, split=2)), rtol=1e-10)
    with pytest.raises(ValueError):
        ht.linalg.solve_triangular(ht.array(np.ones((3, 4))), ht.array(np.ones(3)))
