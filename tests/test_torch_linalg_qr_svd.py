"""The port's ``qr``, ``svd`` and ``PCA(svd_solver="full")`` against heat_tpu
on the same seeded numpy inputs (the port on one CPU rank, the reference on
the suite's 8 devices, where it takes TS-QR for split 0 and block
Gram-Schmidt for split 1; the port's distributed routes run in
tests/test_torch_gloo.py).

Two correct QR (or SVD) codes may choose opposite signs for a column, so R
is compared by magnitude, as the reference's own test does
(tests/test_linalg.py:52), U and V up to a per-column sign, and the
factorisations by what they must satisfy: ``Q R = A`` and ``Q^T Q = I`` at
the reference test's tolerances (rtol/atol 1e-4 in float32, atol 1e-10 in
float64; tests/test_linalg.py:46-49, :88-90), ``U diag(S) V^T = A`` (rtol
1e-3, atol 1e-4) and S rtol 1e-4 (:112-113).  Splits and types must be the
reference's."""

import jax
import numpy as np
import pytest

import heat_tpu as hj
import heat_tpu_torch as ht


@pytest.fixture(autouse=True)
def _port_on_cpu():
    ht.use_device("cpu")


def _signs(got, want, axis=0):
    """+-1 per column (axis=0) that turns got's columns into want's."""
    s = np.sign(np.sum(got * want, axis=axis))
    s[s == 0] = 1
    return s


def _check_qr(q, r, a, ref, atol, rtol):
    qn, rn = q.numpy(), r.numpy()
    np.testing.assert_allclose(qn @ rn, a, rtol=rtol, atol=atol)
    np.testing.assert_allclose(qn.T.conj() @ qn, np.eye(q.shape[1]), atol=atol)
    np.testing.assert_allclose(np.tril(rn, -1), 0.0, atol=atol)
    np.testing.assert_allclose(np.abs(rn), np.abs(ref.R.numpy()), rtol=rtol, atol=atol)
    assert (q.split, r.split) == (ref.Q.split, ref.R.split)
    assert q.dtype.__name__ == ref.Q.dtype.__name__ and r.dtype.__name__ == ref.R.dtype.__name__


@pytest.mark.parametrize("split", [None, 0, 1])
def test_qr_matches_reference(split):
    rng = np.random.default_rng(13)
    a = rng.standard_normal((64, 8) if split == 0 else (16, 12)).astype(np.float32)
    got, want = ht.qr(ht.array(a, split=split)), hj.qr(hj.array(a, split=split))
    _check_qr(got.Q, got.R, a, want, 1e-4, 1e-4)
    r_only = ht.linalg.qr(ht.array(a, split=split), mode="r")
    assert r_only.Q is None
    np.testing.assert_allclose(np.abs(r_only.R.numpy()), np.abs(want.R.numpy()), rtol=1e-4, atol=1e-4)
    # the R-only split depends on the route: held against the reference on a world of one, as the port's
    one = hj.Communication(jax.devices()[:1])
    assert r_only.R.split == hj.linalg.qr(hj.array(a, split=split, comm=one), mode="r").R.split


@pytest.mark.parametrize("m,n", [(37, 5), (13, 4), (23, 23), (50, 13), (6, 20)])
@pytest.mark.parametrize("split", [0, 1])
def test_qr_ragged_float64(m, n, split):
    x = np.random.default_rng(21).standard_normal((m, n))
    got, want = ht.qr(ht.array(x, split=split)), hj.qr(hj.array(x, split=split))
    k = min(m, n)
    qn, rn = got.Q.numpy(), got.R.numpy()
    np.testing.assert_allclose(qn @ rn, x, atol=1e-10)
    np.testing.assert_allclose(qn.T @ qn, np.eye(k), atol=1e-10)
    np.testing.assert_allclose(np.abs(rn), np.abs(want.R.numpy()), atol=1e-10)
    assert (got.Q.split, got.R.split) == (want.Q.split, want.R.split)


def test_qr_batched_integer_and_refusals():
    x = np.random.default_rng(3).integers(-9, 10, (3, 6, 4)).astype(np.int32)
    for split in (None, 0):
        got, want = ht.qr(ht.array(x, split=split)), hj.qr(hj.array(x, split=split))
        assert got.Q.dtype == ht.float32 and got.Q.split == want.Q.split and got.R.split == want.R.split
        np.testing.assert_allclose(got.Q.numpy() @ got.R.numpy(), x, atol=1e-4)
        np.testing.assert_allclose(np.abs(got.R.numpy()), np.abs(want.R.numpy()), rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError):
        ht.qr(ht.array(np.ones((4, 2))), mode="complete")
    with pytest.raises(ValueError):
        ht.qr(ht.array(np.ones(4)))
    with pytest.raises(TypeError):
        ht.qr(np.ones((4, 2)))


@pytest.mark.parametrize("split", [None, 0, 1])
@pytest.mark.parametrize("shape", [(40, 8), (8, 40)])
def test_svd_matches_reference(split, shape):
    a = np.random.default_rng(15).standard_normal(shape).astype(np.float32)
    got, want = ht.svd(ht.array(a, split=split)), hj.svd(hj.array(a, split=split))
    u, s, v = (t.numpy() for t in got)
    np.testing.assert_allclose(u @ np.diag(s) @ v.T, a, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(s, np.linalg.svd(a, compute_uv=False), rtol=1e-4)
    np.testing.assert_allclose(s, want.S.numpy(), rtol=1e-4)
    np.testing.assert_allclose(u * _signs(u, want.U.numpy()), want.U.numpy(), atol=1e-4)
    np.testing.assert_allclose(v * _signs(v, want.V.numpy()), want.V.numpy(), atol=1e-4)
    assert [t.split for t in got] == [t.split for t in want]
    assert [t.dtype.__name__ for t in got] == [t.dtype.__name__ for t in want]
    s_only = ht.linalg.svd(ht.array(a, split=split), compute_uv=False)
    assert isinstance(s_only, ht.DNDarray)
    np.testing.assert_allclose(s_only.numpy(), s, rtol=1e-4)


def test_svd_float64_integer_and_refusals():
    x = np.random.default_rng(5).standard_normal((30, 7))
    got = ht.svd(ht.array(x, split=0))
    np.testing.assert_allclose(got.U.numpy() @ np.diag(got.S.numpy()) @ got.V.numpy().T, x, atol=1e-12)
    np.testing.assert_allclose(got.S.numpy(), hj.svd(hj.array(x, split=0)).S.numpy(), rtol=1e-12)
    xi = np.arange(12, dtype=np.int32).reshape(4, 3)
    assert ht.svd(ht.array(xi)).S.dtype.__name__ == hj.svd(hj.array(xi)).S.dtype.__name__ == "float32"
    with pytest.raises(NotImplementedError):
        ht.svd(ht.array(x), full_matrices=True)
    with pytest.raises(ValueError):
        ht.svd(ht.array(np.ones((2, 3, 4))))


def _pca_data():
    rng = np.random.default_rng(3)
    basis = rng.standard_normal((3, 10)).astype(np.float32)
    coef = rng.standard_normal((200, 3)).astype(np.float32)
    return (coef @ basis + 0.01 * rng.standard_normal((200, 10))).astype(np.float32)


@pytest.mark.parametrize("split", [None, 0, 1])
@pytest.mark.parametrize("n_components", [3, None, 0.9])
def test_full_pca_matches_reference(split, n_components):
    """Components and projections up to sign (atol 1e-4), the spectrum and
    its ratios rtol 1e-4, as tests/test_torch_pca.py holds the other
    solvers."""
    x = _pca_data()
    got = ht.decomposition.PCA(n_components=n_components, svd_solver="full")
    want = hj.decomposition.PCA(n_components=n_components, svd_solver="full")
    t_got, t_want = got.fit_transform(ht.array(x, split=split)), want.fit_transform(hj.array(x, split=split))
    assert got.n_components_ == want.n_components_
    gc, wc = got.components_.numpy(), want.components_.numpy()
    signs = _signs(gc, wc, axis=1)
    np.testing.assert_allclose(gc * signs[:, None], wc, atol=1e-4)
    np.testing.assert_allclose(t_got.numpy() * signs[None, :], t_want.numpy(), atol=1e-4)
    np.testing.assert_allclose(got.singular_values_.numpy(), want.singular_values_.numpy(), rtol=1e-4)
    for name in ("explained_variance_", "explained_variance_ratio_"):
        np.testing.assert_allclose(getattr(got, name).numpy()[:3], getattr(want, name).numpy()[:3], rtol=1e-4)
    np.testing.assert_allclose(got.total_explained_variance_ratio_, want.total_explained_variance_ratio_, rtol=1e-5)
    np.testing.assert_allclose(got.inverse_transform(t_got).numpy(), want.inverse_transform(t_want).numpy(),
                               atol=1e-4)


def test_full_pca_state_from_the_reference():
    from heat_tpu.serving.model_io import export_state

    x = _pca_data()
    ref = hj.decomposition.PCA(n_components=3, svd_solver="full").fit(hj.array(x, split=0))
    doc = export_state(ref)
    doc = {**doc, "state": {k: (v.numpy() if hasattr(v, "numpy") else v) for k, v in doc["state"].items()}}
    est = ht.interop.from_reference_state(doc)
    assert est.svd_solver == "full" and est.n_components_ == 3
    np.testing.assert_array_equal(est.components_.numpy(), ref.components_.numpy())
    fresh = np.random.default_rng(9).standard_normal((31, 10)).astype(np.float32)
    np.testing.assert_allclose(est.transform(ht.array(fresh, split=0)).numpy(),
                               ref.transform(hj.array(fresh, split=0)).numpy(), atol=1e-4)
