"""The port's PCA (hierarchical solver) against heat_tpu's, on the data of
tests/test_ml.py::test_pca, for an int and a float ``n_components``.

eigh may choose opposite signs for a component in the two packages, so
components and projections are compared up to a per-component sign.
Tolerances: components and transform atol 1e-4, explained_variance_ and its
ratio rtol 1e-4, n_components_ equal, inverse_transform atol 1e-4."""

import numpy as np
import pytest

import heat_tpu as hj
import heat_tpu_torch as ht


@pytest.fixture(autouse=True)
def _port_on_cpu():
    ht.use_device("cpu")


def _data():
    rng = np.random.default_rng(3)
    basis = rng.standard_normal((3, 10)).astype(np.float32)
    coef = rng.standard_normal((200, 3)).astype(np.float32)
    return (coef @ basis + 0.01 * rng.standard_normal((200, 10))).astype(np.float32)


def _signs(got, want):
    """+-1 per component (row) that turns got's components into want's."""
    s = np.sign(np.sum(got * want, axis=1))
    s[s == 0] = 1
    return s


@pytest.mark.parametrize("split", [None, 0, 1])
@pytest.mark.parametrize("n_components", [3, 0.9999])
def test_fit_transform_matches_reference(split, n_components):
    data = _data()
    got = ht.decomposition.PCA(n_components=n_components, svd_solver="hierarchical", random_state=0)
    want = hj.decomposition.PCA(n_components=n_components, svd_solver="hierarchical", random_state=0)
    t_got = got.fit_transform(ht.array(data, split=split))
    t_want = want.fit_transform(hj.array(data, split=split))
    assert got.n_components_ == want.n_components_
    gc, wc = got.components_.numpy(), want.components_.numpy()
    assert gc.shape == wc.shape == (got.n_components_, 10)
    signs = _signs(gc, wc)
    np.testing.assert_allclose(gc * signs[:, None], wc, atol=1e-4)
    assert t_got.shape == (200, got.n_components_)
    np.testing.assert_allclose(t_got.numpy() * signs[None, :], t_want.numpy(), atol=1e-4)
    np.testing.assert_allclose(got.mean_.numpy(), want.mean_.numpy(), atol=1e-6)
    np.testing.assert_allclose(got.singular_values_.numpy(), want.singular_values_.numpy(), rtol=1e-4)
    np.testing.assert_allclose(got.explained_variance_.numpy(), want.explained_variance_.numpy(), rtol=1e-4)
    np.testing.assert_allclose(
        got.explained_variance_ratio_.numpy(), want.explained_variance_ratio_.numpy(), rtol=1e-4
    )
    np.testing.assert_allclose(got.total_explained_variance_ratio_, want.total_explained_variance_ratio_, atol=1e-5)
    # the projections back are sign-free: each sign flip meets itself
    np.testing.assert_allclose(
        got.inverse_transform(t_got).numpy(), want.inverse_transform(t_want).numpy(), atol=1e-4
    )
    rec = got.inverse_transform(t_got).numpy()
    assert np.linalg.norm(rec - data) / np.linalg.norm(data) < 0.05
    assert got.total_explained_variance_ratio_ > 0.95


def test_transform_of_fresh_rows_and_split_of_results():
    data = _data()
    pca = ht.decomposition.PCA(n_components=2).fit(ht.array(data, split=0))
    ref = hj.decomposition.PCA(n_components=2).fit(hj.array(data, split=0))
    fresh = np.random.default_rng(11).standard_normal((37, 10)).astype(np.float32)
    got = pca.transform(ht.array(fresh, split=0))
    assert got.split == 0 and got.shape == (37, 2)
    signs = _signs(pca.components_.numpy(), ref.components_.numpy())
    np.testing.assert_allclose(got.numpy() * signs[None, :], ref.transform(hj.array(fresh, split=0)).numpy(), atol=1e-4)
    assert pca.components_.split is None and pca.mean_.split is None


def test_params_and_not_ported_options(monkeypatch):
    pca = ht.decomposition.PCA(n_components=2)
    assert pca.get_params()["svd_solver"] == "hierarchical" and pca.get_params()["n_components"] == 2
    x = ht.array(_data(), split=0)
    with pytest.raises(RuntimeError):
        pca.transform(x)
    with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
        ht.decomposition.PCA(n_components=2, svd_solver="full").fit(x)
    with pytest.raises(ValueError, match="randomized solver requires an integer n_components"):
        ht.decomposition.PCA(n_components=0.5, svd_solver="randomized").fit(x)
    with pytest.raises(NotImplementedError, match="Queue 1 item 15"):
        ht.decomposition.PCA(n_components=2, checkpoint_every=1, checkpoint_dir="ckpt")
    with pytest.raises(NotImplementedError, match="Queue 1 item 15"):
        ht.decomposition.PCA(resume_from="ckpt")
    with pytest.raises(NotImplementedError):
        ht.decomposition.PCA(whiten=True)
    with pytest.raises(ValueError):
        ht.decomposition.PCA(svd_solver="arpack")
    with pytest.raises(ValueError):
        ht.decomposition.PCA(n_components=1.5).fit(x)
    with pytest.raises(ValueError):
        ht.decomposition.PCA(n_components=1.0).fit(x)  # rtol 0, refused as the reference refuses it
    with pytest.raises(TypeError):
        ht.decomposition.PCA(n_components=2).fit(_data())
    fitted = ht.decomposition.PCA(n_components=2).fit(x)
    monkeypatch.setenv("HEAT_TPU_PREDICT_DTYPE", "bfloat16")
    with pytest.raises(NotImplementedError, match="Queue 1 item 18"):
        fitted.transform(x)


def _data64():
    rng = np.random.default_rng(11)
    basis = rng.standard_normal((2, 6))
    coef = rng.standard_normal((40, 2)) * np.array([1.3, 1.1])
    return coef @ basis + 0.05 * rng.standard_normal((40, 6))


@pytest.mark.parametrize("split", [None, 0, 1])
@pytest.mark.parametrize("n_components", [2, 0.9])
def test_float64_fit_matches_reference(split, n_components):
    """A float64 array fits as the reference's does (its sum of squares is
    taken in float32)."""
    data = _data64()
    got = ht.decomposition.PCA(n_components=n_components, svd_solver="hierarchical", random_state=0)
    want = hj.decomposition.PCA(n_components=n_components, svd_solver="hierarchical", random_state=0)
    got.fit(ht.array(data, split=split))
    want.fit(hj.array(data, split=split))
    assert got.n_components_ == want.n_components_
    np.testing.assert_allclose(got.singular_values_.numpy(), want.singular_values_.numpy(), rtol=1e-4)
    np.testing.assert_allclose(got.explained_variance_.numpy(), want.explained_variance_.numpy(), rtol=1e-4)
    np.testing.assert_allclose(
        got.explained_variance_ratio_.numpy(), want.explained_variance_ratio_.numpy(), rtol=1e-4
    )
    signs = _signs(got.components_.numpy(), want.components_.numpy())
    np.testing.assert_allclose(got.components_.numpy() * signs[:, None], want.components_.numpy(), atol=1e-4)
