"""The port's randomized SVD (heat_tpu_torch.linalg.rsvd) and randomized
PCA (``PCA(svd_solver="randomized")``) against heat_tpu's on the same numpy
inputs, seeded alike in both packages, so that both draw the same Gaussian
test matrix (within randn's 2 ulp in float32, 3 in float64).

The port runs on one CPU rank, the reference on a one-device Communication
(rsvd works on the dense matrix in both, so the world size changes no
result; the gloo world of three is in tests/test_torch_gloo.py).  eigh and
the small SVD may choose opposite signs for a singular vector in the two
packages, so U, V and the components are compared up to a per-column sign.

Tolerances:
- ``U diag(S) V^T`` against the reference's, and against the input where the
  input has exactly the requested rank: rtol and atol 1e-3, and the
  relative Frobenius error of the rank-deficient case below 1e-4 (the
  reference's own tests, tests/test_linalg.py:132-136 and :215-222);
- S: rtol 1e-4 of the reference's S in float32, 1e-10 in float64;
- U and V: atol 1e-3 of the reference's in float32, 1e-10 in float64;
- for rank-deficient input only the directions within the input's rank
  are compared; the others lie at float32's noise floor in both packages
  (below 1e-5 of the largest singular value), where they are rounding;
- PCA: components, transform and inverse_transform atol 1e-4, singular
  values, explained variance and its ratio rtol 1e-4, the total explained
  variance ratio atol 1e-5, n_components_ equal (those of
  tests/test_torch_pca.py)."""

import jax
import numpy as np
import pytest

import heat_tpu as hj
import heat_tpu_torch as ht
from heat_tpu.serving.model_io import export_state


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


def _both(a, split, rank, seed=0, **kw):
    """rsvd of the same input in both packages after the same seed: the
    port's (U, S, V) DNDarrays and the reference's factors as numpy."""
    ht.random.seed(seed)
    hj.random.seed(seed)
    got = ht.linalg.rsvd(ht.array(a, split=split), rank, **kw)
    want = hj.linalg.rsvd(_ref(a, split), rank, **kw)
    assert all(g.dtype.__name__ == w.dtype.__name__ for g, w in zip(got, want))
    return got, tuple(w.numpy() for w in want)


def _lowrank():
    """tests/test_linalg.py::test_rsvd's matrix: rank 6, 50 x 30."""
    rng = np.random.default_rng(17)
    return (rng.standard_normal((50, 6)) @ rng.standard_normal((6, 30))).astype(np.float32)


def _decaying64():
    """float64, 80 x 30, singular values 1 down to 1e-3."""
    rng = np.random.default_rng(5)
    qa, _ = np.linalg.qr(rng.standard_normal((80, 30)))
    qb, _ = np.linalg.qr(rng.standard_normal((30, 30)))
    return (qa * np.logspace(0, -3, 30)) @ qb.T


def _gaussian(m, n, seed):
    return np.random.default_rng(seed).standard_normal((m, n)).astype(np.float32)


# (name, matrix, rank, keyword arguments, exact): exact says A has rank
# ``rank``, so that U diag(S) V^T reproduces it
_CASES = [
    *[(f"reference_power_iter_{p}", _lowrank, 6, {"power_iter": p}, True) for p in (0, 1, 2)],
    *[(f"float64_power_iter_{p}", _decaying64, 6, {"power_iter": p}, False) for p in (0, 1)],
    # ell = rank + n_oversamples = 13 is cut to min(m, n) = 9: the sample
    # spans every column, and the factorization is exact
    ("int32", lambda: np.random.default_rng(8).integers(-5, 6, (120, 9)).astype(np.int32), 3, {}, False),
    ("oversampled_past_n", lambda: _gaussian(60, 20, 9), 8, {"n_oversamples": 20}, False),
    ("oversampled_past_m_wide", lambda: _gaussian(12, 40, 10), 8, {}, False),
]


@pytest.mark.parametrize("split", [None, 0])
@pytest.mark.parametrize("name,make,rank,kw,exact", _CASES, ids=[c[0] for c in _CASES])
def test_rsvd_matches_reference(split, name, make, rank, kw, exact):
    a = make()
    (U, S, V), (wu, ws, wv) = _both(a, split, rank, **kw)
    f64 = a.dtype == np.float64
    tol = 1e-10 if f64 else 1e-3
    k = min(rank, *a.shape)
    assert U.shape == wu.shape == (a.shape[0], k) and S.shape == ws.shape == (k,) and V.shape == wv.shape
    assert U.split == (0 if split == 0 else None) and S.split is None and V.split is None
    u, s, v = U.numpy(), S.numpy(), V.numpy()
    np.testing.assert_allclose(s, ws, rtol=1e-10 if f64 else 1e-4)
    np.testing.assert_allclose(_signed_like(u, wu), wu, atol=tol)
    np.testing.assert_allclose(_signed_like(v, wv), wv, atol=tol)
    rec = u @ np.diag(s) @ v.T
    np.testing.assert_allclose(rec, wu @ np.diag(ws) @ wv.T, rtol=1e-3, atol=1e-3)
    if exact:
        np.testing.assert_allclose(rec, a, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("split", [None, 0])
def test_rank_deficient_matches_reference(split):
    """tests/test_linalg.py::test_rsvd_rank_deficient: rank 4 asked for 6.
    The Gram passes drop what lies below float32's noise floor (eps times the
    largest eigenvalue) instead of amplifying it."""
    rng = np.random.default_rng(1)
    a = (rng.standard_normal((500, 4)) @ rng.standard_normal((4, 40))).astype(np.float32)
    (U, S, V), (wu, ws, wv) = _both(a, split, 6, n_oversamples=6)
    u, s, v = U.numpy(), S.numpy(), V.numpy()
    for uu, ss, vv in ((u, s, v), (wu, ws, wv)):
        assert np.linalg.norm(a - uu @ np.diag(ss) @ vv.T) / np.linalg.norm(a) < 1e-4
        assert np.all(ss[4:] < 1e-5 * ss[0])
    np.testing.assert_allclose(s[:4], ws[:4], rtol=1e-4)
    np.testing.assert_allclose(_signed_like(u[:, :4], wu[:, :4]), wu[:, :4], atol=1e-3)
    np.testing.assert_allclose(_signed_like(v[:, :4], wv[:, :4]), wv[:, :4], atol=1e-3)


_BAD_ARGUMENTS = [
    ({"rank": 0}, ValueError),
    ({"rank": 2.5}, ValueError),
    ({"rank": 2, "n_oversamples": -1}, ValueError),
    ({"rank": 2, "n_oversamples": 1.5}, ValueError),
    ({"rank": 2, "power_iter": -1}, ValueError),
    ({"rank": 2, "power_iter": 1.0}, ValueError),
]


@pytest.mark.parametrize("kw,exc", _BAD_ARGUMENTS)
def test_argument_errors_match_reference(kw, exc):
    a = _lowrank()
    with pytest.raises(exc) as got:
        ht.linalg.rsvd(ht.array(a), **kw)
    with pytest.raises(exc) as want:
        hj.linalg.rsvd(_ref(a, None), **kw)
    assert str(got.value) == str(want.value)


def test_rsvd_takes_dndarrays_only():
    with pytest.raises(TypeError):
        ht.linalg.rsvd(_lowrank(), 2)


def _pca_data():
    """tests/test_torch_pca.py's data: rank 3 plus 0.01 noise, 200 x 10."""
    rng = np.random.default_rng(3)
    basis = rng.standard_normal((3, 10)).astype(np.float32)
    coef = rng.standard_normal((200, 3)).astype(np.float32)
    return (coef @ basis + 0.01 * rng.standard_normal((200, 10))).astype(np.float32)


@pytest.mark.parametrize("split", [None, 0])
@pytest.mark.parametrize("n_components,n_oversamples,iterated_power", [(3, 10, "auto"), (2, 2, "auto"), (2, 2, 2)])
def test_randomized_pca_matches_reference(split, n_components, n_oversamples, iterated_power):
    data = _pca_data()
    kw = dict(n_components=n_components, svd_solver="randomized", random_state=0, n_oversamples=n_oversamples,
              iterated_power=iterated_power)
    got = ht.decomposition.PCA(**kw)
    want = hj.decomposition.PCA(**kw)
    t_got = got.fit_transform(ht.array(data, split=split))
    t_want = want.fit_transform(hj.array(data, split=split))
    assert got.n_components_ == want.n_components_ == n_components
    gc, wc = got.components_.numpy(), want.components_.numpy()
    assert gc.shape == wc.shape == (n_components, 10) and got.components_.split is None
    signs = np.sign(np.sum(gc * wc, axis=1))
    np.testing.assert_allclose(gc * signs[:, None], wc, atol=1e-4)
    np.testing.assert_allclose(got.mean_.numpy(), want.mean_.numpy(), atol=1e-6)
    for attr in ("singular_values_", "explained_variance_", "explained_variance_ratio_"):
        g, w = getattr(got, attr), getattr(want, attr)
        assert g.dtype.__name__ == w.dtype.__name__
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4, err_msg=attr)
    np.testing.assert_allclose(got.total_explained_variance_ratio_, want.total_explained_variance_ratio_, atol=1e-5)
    assert t_got.split == t_want.split
    np.testing.assert_allclose(t_got.numpy() * signs[None, :], t_want.numpy(), atol=1e-4)
    fresh = np.random.default_rng(11).standard_normal((37, 10)).astype(np.float32)
    np.testing.assert_allclose(got.transform(ht.array(fresh, split=split)).numpy() * signs[None, :],
                               want.transform(hj.array(fresh, split=split)).numpy(), atol=1e-4)
    np.testing.assert_allclose(got.inverse_transform(t_got).numpy(), want.inverse_transform(t_want).numpy(),
                               atol=1e-4)


@pytest.mark.parametrize("n_components", [0.9, 1.5])
def test_randomized_pca_refuses_a_float_n_components(n_components):
    x = _pca_data()
    with pytest.raises(ValueError) as got:
        ht.decomposition.PCA(n_components=n_components, svd_solver="randomized").fit(ht.array(x, split=0))
    with pytest.raises(ValueError) as want:
        hj.decomposition.PCA(n_components=n_components, svd_solver="randomized").fit(hj.array(x, split=0))
    assert str(got.value) == str(want.value)


def test_randomized_pca_state_transforms_like_the_reference():
    """A randomized PCA fitted by the reference, carried over as its model
    document, projects fresh rows as the reference does."""
    data = _pca_data()
    ref = hj.decomposition.PCA(n_components=3, svd_solver="randomized", random_state=4).fit(hj.array(data, split=0))
    doc = export_state(ref)
    doc = {**doc, "state": {k: (v.numpy() if hasattr(v, "numpy") else v) for k, v in doc["state"].items()}}
    est = ht.interop.from_reference_state(doc)
    assert isinstance(est, ht.decomposition.PCA) and est.svd_solver == "randomized"
    assert est.n_components_ == ref.n_components_ == 3
    assert est.total_explained_variance_ratio_ == pytest.approx(ref.total_explained_variance_ratio_)
    np.testing.assert_array_equal(est.components_.numpy(), ref.components_.numpy())
    fresh = np.random.default_rng(12).standard_normal((41, 10)).astype(np.float32)
    np.testing.assert_allclose(est.transform(ht.array(fresh, split=0)).numpy(),
                               ref.transform(hj.array(fresh, split=0)).numpy(), atol=1e-4)
