"""Fitted state carried from heat_tpu into heat_tpu_torch: a model fitted by
the JAX package, exported as its serving document, predicts the same labels
(bitwise) in the port, or projects the same coordinates (atol 1e-4)."""

import numpy as np
import pytest

import heat_tpu as hj
import heat_tpu_torch as ht
from heat_tpu.serving.model_io import export_state


@pytest.fixture(autouse=True)
def _port_on_cpu():
    ht.use_device("cpu")


def _numpy_leaves(doc):
    state = {k: (v.numpy() if hasattr(v, "numpy") else v) for k, v in doc["state"].items()}
    return {**doc, "state": state}


@pytest.mark.parametrize("init", ["random", "kmeans++"])
def test_kmeans_state_predicts_bitwise(init):
    rng = np.random.default_rng(4)
    centres = rng.standard_normal((6, 8)) * 5.0
    x = (centres[rng.integers(0, 6, 700)] + rng.standard_normal((700, 8))).astype(np.float32)
    ref = hj.cluster.KMeans(n_clusters=6, init=init, random_state=1, max_iter=20).fit(hj.array(x, split=0))
    est = ht.interop.from_reference_state(_numpy_leaves(export_state(ref)))
    assert isinstance(est, ht.cluster.KMeans)
    assert est.n_clusters == 6 and est.max_iter == 20
    np.testing.assert_array_equal(est.cluster_centers_.numpy(), ref.cluster_centers_.numpy())
    fresh = (centres[rng.integers(0, 6, 257)] + rng.standard_normal((257, 8))).astype(np.float32)
    np.testing.assert_array_equal(
        est.predict(ht.array(fresh, split=0)).numpy(), ref.predict(hj.array(fresh, split=0)).numpy()
    )


def test_other_kinds_and_bad_documents_raise():
    with pytest.raises(NotImplementedError, match="Spectral"):
        ht.interop.from_reference_state({"kind": "Spectral", "params": {}, "state": {}})
    with pytest.raises(ValueError):
        ht.interop.from_reference_state({"state": {}})


@pytest.mark.parametrize("lam", [0.1, 5.0])
def test_lasso_state_predicts_bitwise(lam):
    rng = np.random.default_rng(6)
    x = rng.standard_normal((300, 7)).astype(np.float32)
    y = (x @ rng.standard_normal(7) + 1.5).astype(np.float32)
    ref = hj.regression.Lasso(lam=lam, max_iter=30).fit(hj.array(x, split=0), hj.array(y, split=0))
    est = ht.interop.from_reference_state(_numpy_leaves(export_state(ref)))
    assert isinstance(est, ht.regression.Lasso) and est.lam == lam and est.max_iter == 30
    np.testing.assert_array_equal(est.theta.numpy(), np.asarray(ref.theta.numpy()))
    fresh = rng.standard_normal((77, 7)).astype(np.float32)
    np.testing.assert_array_equal(est.predict(ht.array(fresh, split=0)).numpy(),
                                  np.asarray(ref.predict(hj.array(fresh, split=0)).numpy()))


@pytest.mark.parametrize("kind", ["BatchParallelKMeans", "BatchParallelKMedians"])
def test_batch_parallel_state_predicts_bitwise(kind):
    rng = np.random.default_rng(7)
    centres = rng.standard_normal((4, 5)) * 5.0
    x = (centres[rng.integers(0, 4, 500)] + rng.standard_normal((500, 5))).astype(np.float32)
    ref = getattr(hj.cluster, kind)(n_clusters=4, random_state=2).fit(hj.array(x, split=0))
    doc = {"kind": kind, "params": ref.get_params(),
           "state": {"cluster_centers": np.asarray(ref.cluster_centers_.numpy())}}
    est = ht.interop.from_reference_state(doc)
    assert isinstance(est, getattr(ht.cluster, kind)) and est.n_clusters == 4
    fresh = (centres[rng.integers(0, 4, 129)] + rng.standard_normal((129, 5))).astype(np.float32)
    np.testing.assert_array_equal(est.predict(ht.array(fresh, split=0)).numpy(),
                                  np.asarray(ref.predict(hj.array(fresh, split=0)).numpy()))


@pytest.mark.parametrize("n_components", [3, 0.99])
def test_pca_state_transforms_like_the_reference(n_components):
    rng = np.random.default_rng(5)
    basis = rng.standard_normal((4, 12)).astype(np.float32)
    x = (rng.standard_normal((300, 4)).astype(np.float32) @ basis + 0.05 * rng.standard_normal((300, 12))).astype(
        np.float32
    )
    ref = hj.decomposition.PCA(n_components=n_components).fit(hj.array(x, split=0))
    est = ht.interop.from_reference_state(_numpy_leaves(export_state(ref)))
    assert isinstance(est, ht.decomposition.PCA)
    assert est.n_components == n_components and est.n_components_ == ref.n_components_
    assert est.total_explained_variance_ratio_ == pytest.approx(ref.total_explained_variance_ratio_)
    np.testing.assert_array_equal(est.components_.numpy(), ref.components_.numpy())
    fresh = rng.standard_normal((77, 12)).astype(np.float32)
    np.testing.assert_allclose(
        est.transform(ht.array(fresh, split=0)).numpy(), ref.transform(hj.array(fresh, split=0)).numpy(), atol=1e-4
    )
