"""The port's main path as a whole, against heat_tpu: DNDarray of points,
KMeans fit, predict.

The reference fit runs both its default XLA loop and its Pallas kernel path
(the kernel is opt-in there, switched on as tests/test_kernels.py does).
Centres atol 5e-5, labels bitwise, inertia rtol 1e-4, equal n_iter_."""

import numpy as np
import pytest

import heat_tpu as hj
import heat_tpu_torch as ht
from heat_tpu.core import kernels as ref_kernels
from heat_tpu_torch.core import kernels


@pytest.fixture(autouse=True)
def _port_on_cpu():
    ht.use_device("cpu")


def _blobs(n, f, k, seed):
    rng = np.random.default_rng(seed)
    centres = rng.standard_normal((k, f)) * 6.0
    return (centres[rng.integers(0, k, n)] + rng.standard_normal((n, f))).astype(np.float32)


def _assert_same_fit(got, want):
    assert got.n_iter_ == want.n_iter_
    np.testing.assert_allclose(got.cluster_centers_.numpy(), want.cluster_centers_.numpy(), atol=5e-5)
    np.testing.assert_array_equal(got.labels_.numpy(), want.labels_.numpy())
    np.testing.assert_allclose(got.inertia_, want.inertia_, rtol=1e-4)


CASES = [(1003, 16, 8, 0), (517, 8, 5, 1)]


@pytest.mark.parametrize("ref_kernel", [False, True])
@pytest.mark.parametrize("n,f,k,seed", CASES)
def test_random_init_fit_and_predict(n, f, k, seed, ref_kernel, monkeypatch):
    monkeypatch.setattr(ref_kernels, "LLOYD_KERNEL", ref_kernel)
    x = _blobs(n, f, k, seed)
    want = hj.cluster.KMeans(n_clusters=k, init="random", random_state=seed, max_iter=30).fit(hj.array(x, split=0))
    got = ht.cluster.KMeans(n_clusters=k, init="random", random_state=seed, max_iter=30).fit(ht.array(x, split=0))
    _assert_same_fit(got, want)
    assert got.labels_.split == 0 and got.labels_.shape == (n,)
    fresh = _blobs(300, f, k, seed + 100)
    np.testing.assert_array_equal(
        got.predict(ht.array(fresh, split=0)).numpy(), want.predict(hj.array(fresh, split=0)).numpy()
    )


@pytest.mark.parametrize("n,f,k,seed", CASES)
def test_explicit_init_fit(n, f, k, seed):
    x = _blobs(n, f, k, seed)
    init = x[np.random.default_rng(seed + 7).choice(n, k, replace=False)]
    want = hj.cluster.KMeans(n_clusters=k, init=hj.array(init), max_iter=30).fit(hj.array(x, split=0))
    got = ht.cluster.KMeans(n_clusters=k, init=ht.array(init), max_iter=30).fit(ht.array(x, split=0))
    _assert_same_fit(got, want)


def test_unsplit_points_and_max_iter_cap():
    x = _blobs(400, 8, 6, 3)
    want = hj.cluster.KMeans(n_clusters=6, init="random", random_state=2, max_iter=2).fit(hj.array(x))
    got = ht.cluster.KMeans(n_clusters=6, init="random", random_state=2, max_iter=2).fit(ht.array(x))
    assert got.n_iter_ == want.n_iter_ == 2
    _assert_same_fit(got, want)


def test_fit_runs_one_lloyd_pass_per_iteration_plus_assignment(monkeypatch):
    calls = []
    real = kernels.lloyd_update

    def counting(x, centers, labels=False):
        calls.append(labels)
        return real(x, centers, labels=labels)

    monkeypatch.setattr(kernels, "lloyd_update", counting)
    km = ht.cluster.KMeans(n_clusters=8, init="random", random_state=0, max_iter=30).fit(
        ht.array(_blobs(1003, 16, 8, 0), split=0)
    )
    assert calls == [False] * km.n_iter_ + [True]


def test_params_and_not_ported_options():
    km = ht.cluster.KMeans(n_clusters=3, tol=1e-3)
    assert km.get_params()["n_clusters"] == 3 and km.get_params()["init"] == "random"
    km.set_params(max_iter=5)
    assert km.max_iter == 5
    x = ht.array(_blobs(50, 4, 3, 0), split=0)
    with pytest.raises(NotImplementedError):
        ht.cluster.KMeans(n_clusters=3, init="kmeans++").fit(x)
    with pytest.raises(NotImplementedError):
        ht.cluster.KMeans(n_clusters=3, checkpoint_every=2, checkpoint_dir="ckpt")
    with pytest.raises(ValueError):
        ht.cluster.KMeans(n_clusters=3, init=ht.array(np.zeros((2, 4), np.float32))).fit(x)
    with pytest.raises(ValueError):
        ht.cluster.KMeans(max_iter=0)
    monkeypatch = pytest.MonkeyPatch()
    monkeypatch.setenv("HEAT_TPU_PREDICT_DTYPE", "bfloat16")
    try:
        fitted = ht.cluster.KMeans(n_clusters=3, random_state=0).fit(x)
        with pytest.raises(NotImplementedError):
            fitted.predict(x)
    finally:
        monkeypatch.undo()
