"""The port's hierarchical SVD (heat_tpu_torch.linalg.hsvd_rank, hsvd_rtol,
hsvd) against heat_tpu's on the same numpy inputs: those of
tests/test_linalg.py (the low-rank matrix, the rank-deficient one, the
float64 one) and of tests/test_kernels.py (the kernel's tall Gaussian).

The port runs on one CPU rank, where its Gram kernel is its plain version,
and the reference on a one-device Communication: a world of the same size,
so that a column-split array's merge tree has the same leaves in both (the
tree over three ranks is held in tests/test_torch_gloo.py).  eigh may choose opposite signs
for a singular vector in the two packages, so U and V are compared up to a
per-column sign.  Tolerances: S rtol 1e-4 (1e-8 for the float64 case),
U and V atol 1e-4, rel_err atol 1e-5 (below 1e-3 in both where it is float32
rounding), the rtol path's rank equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import heat_tpu as hj
import heat_tpu_torch as ht
from heat_tpu.core.linalg.svdtools import _hsvd_rank_jit
from heat_tpu_torch.core import kernels


@pytest.fixture(autouse=True)
def _port_on_cpu():
    ht.use_device("cpu")


def _ref(a, split):
    """The reference's array in a world of one device, the port's size."""
    return hj.array(a, split=split, comm=hj.Communication(jax.devices()[:1]))


def _signed_like(got, want):
    """got's columns flipped to agree in sign with want's."""
    signs = np.sign(np.sum(got * want, axis=0))
    signs[signs == 0] = 1
    return got * signs


def _assert_same_factors(got, want, k=None, s_rtol=1e-4, atol=1e-4):
    """(U, S, V, rel_err) of the port against the reference's; the first k
    columns of U and V (all by default) up to sign."""
    (gu, gs, gv, ge), (wu, ws, wv, we) = got, want
    ws = np.asarray(ws.numpy())
    assert gs.shape == ws.shape
    k = ws.shape[0] if k is None else k
    np.testing.assert_allclose(gs.numpy()[:k], ws[:k], rtol=s_rtol)
    for g, w in ((gu.numpy(), wu.numpy()), (gv.numpy(), wv.numpy())):
        assert g.shape == w.shape
        np.testing.assert_allclose(_signed_like(g[:, :k], w[:, :k]), w[:, :k], atol=atol)
    if float(we) > 1e-2:
        np.testing.assert_allclose(float(ge), float(we), atol=1e-5)
    else:
        # sqrt(max(|A|^2 - sum S^2, 0)) / |A| of an exactly low-rank matrix
        # is the square root of float32 rounding in either package (about
        # 1e-4 relative, or 0 where the difference rounds below 0): both are
        # held to the reference test's own bound instead
        assert float(ge) < 1e-3 and float(we) < 1e-3


def _lowrank():
    # tests/test_linalg.py::test_hsvd_lowrank
    rng = np.random.default_rng(16)
    u = np.linalg.qr(rng.standard_normal((64, 5)))[0]
    v = np.linalg.qr(rng.standard_normal((24, 5)))[0]
    s = np.array([10.0, 5.0, 2.0, 1.0, 0.5])
    return ((u * s) @ v.T).astype(np.float32), s


@pytest.mark.parametrize("split", [None, 0, 1])
def test_hsvd_rank_lowrank(split):
    a, _ = _lowrank()
    got = ht.linalg.hsvd_rank(ht.array(a, split=split), 5, compute_sv=True)
    want = hj.linalg.hsvd_rank(_ref(a, split), 5, compute_sv=True)
    _assert_same_factors(got, want)
    U, err = ht.linalg.hsvd_rank(ht.array(a, split=split), 5)
    assert U.split == (0 if split == 0 else None) and U.shape == (64, 5)
    assert float(err) < 1e-3
    proj = U.numpy() @ (U.numpy().T @ a)
    np.testing.assert_allclose(proj, a, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("split", [None, 0, 1])
def test_hsvd_rtol_lowrank(split):
    a, s = _lowrank()
    got = ht.linalg.hsvd_rtol(ht.array(a, split=split), 1e-3, compute_sv=True)
    want = hj.linalg.hsvd_rtol(_ref(a, split), 1e-3, compute_sv=True)
    assert got[1].shape == want[1].shape  # the same rank k
    _assert_same_factors(got, want)
    np.testing.assert_allclose(got[1].numpy(), s[: got[1].shape[0]], rtol=1e-3)
    assert got[2].split == (1 if split == 1 else None)


@pytest.mark.parametrize("split", [None, 0])
def test_hsvd_rank_deficient(split):
    # tests/test_linalg.py::test_hsvd_rank_deficient: directions below the
    # Gram noise floor are dropped, so only the first five are compared
    rng = np.random.default_rng(0)
    a = (rng.standard_normal((2000, 5)) @ rng.standard_normal((5, 64))).astype(np.float32)
    got = ht.linalg.hsvd_rank(ht.array(a, split=split), 10, compute_sv=True, safetyshift=5)
    want = hj.linalg.hsvd_rank(_ref(a, split), 10, compute_sv=True, safetyshift=5)
    _assert_same_factors(got, want, k=5)
    u, s, v, _ = got
    assert np.isfinite(u.numpy()).all() and np.isfinite(v.numpy()).all()
    rec = u.numpy() @ np.diag(s.numpy()) @ v.numpy().T
    assert np.linalg.norm(a - rec) / np.linalg.norm(a) < 1e-4


def test_hsvd_float64_high_condition():
    # tests/test_linalg.py::test_hsvd_float64_high_condition: float64 goes
    # through a float64 product, not the float32 kernel
    rng = np.random.default_rng(3)
    q1, _ = np.linalg.qr(rng.standard_normal((400, 12)))
    q2, _ = np.linalg.qr(rng.standard_normal((32, 12)))
    sv = np.logspace(0, -4, 12)
    a = (q1 * sv) @ q2.T
    before = kernels.GRAM_LAUNCHES
    got = ht.linalg.hsvd_rank(ht.array(a, split=0), 12, compute_sv=True, safetyshift=0)
    want = hj.linalg.hsvd_rank(_ref(a, 0), 12, compute_sv=True, safetyshift=0)
    assert kernels.GRAM_LAUNCHES == before
    assert got[1].dtype == ht.float64
    _assert_same_factors(got, want, s_rtol=1e-8)
    np.testing.assert_allclose(got[1].numpy(), sv, rtol=1e-8)
    rec = got[0].numpy() @ np.diag(got[1].numpy()) @ got[2].numpy().T
    assert np.linalg.norm(a - rec) / np.linalg.norm(a) < 1e-8


def test_hsvd_rank_against_the_reference_kernel_path():
    # tests/test_kernels.py::TestSyrk::test_hsvd_uses_it_and_matches: the
    # reference's public call and its program with the Pallas kernel run
    # through the interpreter
    rng = np.random.default_rng(4)
    xh = rng.standard_normal((3 * 2048 + 11, 64)).astype(np.float32)
    got = ht.linalg.hsvd_rank(ht.array(xh, split=0), 10, compute_sv=True)
    want = hj.linalg.hsvd_rank(_ref(xh, 0), 10, compute_sv=True)
    _assert_same_factors(got, want)
    u2, s2, v2, e2 = _hsvd_rank_jit(jnp.asarray(xh), 15, 1, 2, 10, True, "float32", syrk_ok=True)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(s2), rtol=1e-4)
    np.testing.assert_allclose(_signed_like(got[2].numpy(), np.asarray(v2)), np.asarray(v2), atol=1e-4)
    np.testing.assert_allclose(float(got[3]), float(e2), atol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), np.linalg.svd(xh, compute_uv=False)[:10], rtol=1e-4)


@pytest.mark.parametrize("split", [None, 0, 1])
def test_generic_hsvd(split):
    a, _ = _lowrank()
    for kwargs in ({"maxrank": 4}, {"rtol": 1e-2}, {"maxrank": 3, "rtol": 1e-6}):
        got = ht.linalg.hsvd(ht.array(a, split=split), compute_sv=True, **kwargs)
        want = hj.linalg.hsvd(_ref(a, split), compute_sv=True, **kwargs)
        _assert_same_factors(got, want)


def test_wide_matrix_takes_the_dense_route():
    # m < n: the reference's wide leaf (an SVD of the block), then the final
    # Gram factorization of its factor
    rng = np.random.default_rng(7)
    a = (rng.standard_normal((24, 6)) @ rng.standard_normal((6, 90))).astype(np.float32)
    for split in (None, 0, 1):
        got = ht.linalg.hsvd_rank(ht.array(a, split=split), 4, compute_sv=True)
        want = hj.linalg.hsvd_rank(_ref(a, split), 4, compute_sv=True)
        _assert_same_factors(got, want)
        assert got[0].split == (0 if split == 0 else None)


def test_integer_input_is_factorized_in_float32():
    rng = np.random.default_rng(8)
    a = rng.integers(-5, 6, (120, 9)).astype(np.int32)
    got = ht.linalg.hsvd_rank(ht.array(a, split=0), 3, compute_sv=True)
    want = hj.linalg.hsvd_rank(_ref(a, 0), 3, compute_sv=True)
    assert got[1].dtype == ht.float32
    _assert_same_factors(got, want)


def test_one_gram_per_call(monkeypatch):
    calls = []
    real = kernels.gram_partials

    def counting(x, n_true):
        calls.append(n_true)
        return real(x, n_true)

    monkeypatch.setattr(kernels, "gram_partials", counting)
    x = ht.array(np.random.default_rng(9).standard_normal((500, 16)).astype(np.float32), split=0)
    ht.linalg.hsvd_rank(x, 4, compute_sv=True)
    ht.linalg.hsvd_rtol(x, 0.5)
    assert calls == [500, 500]


def test_refusals():
    x = ht.array(np.ones((10, 4), np.float32), split=0)
    with pytest.raises(ValueError, match="rank must be a positive integer"):
        ht.linalg.rsvd(x, 0)
    with pytest.raises(ValueError):
        ht.linalg.hsvd_rank(x, 0)
    with pytest.raises(ValueError):
        ht.linalg.hsvd_rtol(x, 1)
    with pytest.raises(ValueError):
        ht.linalg.hsvd_rank(ht.array(np.ones(10, np.float32)), 2)
    with pytest.raises(TypeError):
        ht.linalg.hsvd_rank(np.ones((10, 4)), 2)


@pytest.mark.parametrize("split", [None, 0, 1])
def test_transpose_moves_the_split(split):
    a = np.arange(63, dtype=np.float32).reshape(9, 7)
    t = ht.array(a, split=split).T
    assert t.shape == (7, 9)
    assert t.split == (None if split is None else 1 - split)
    np.testing.assert_array_equal(t.numpy(), a.T)
    np.testing.assert_array_equal(ht.linalg.transpose(t).numpy(), a)
