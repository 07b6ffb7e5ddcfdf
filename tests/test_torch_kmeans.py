"""The port's main path as a whole, against heat_tpu: DNDarray of points,
KMeans fit, predict.

The reference fit runs both its default XLA loop and its Pallas kernel path
(the kernel is opt-in there, switched on as tests/test_kernels.py does).
Centres atol 5e-5, labels bitwise, inertia rtol 1e-4, equal n_iter_.
Float64 points (the reference's XLA step, the port's plain version): centres
atol 1e-12, labels bitwise, inertia rtol 1e-12."""

import numpy as np
import pytest
import torch

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
    # the resumable-fit options are validated as the reference validates them
    for resumable in ({"checkpoint_every": 2, "checkpoint_dir": "ckpt"}, {"resume_from": "ckpt"}):
        assert ht.cluster.KMeans(n_clusters=3, **resumable).get_params()["checkpoint_dir"] == resumable.get(
            "checkpoint_dir")
    for bad, match in (({"checkpoint_every": 0, "checkpoint_dir": "ckpt"}, "positive int"),
                       ({"checkpoint_every": 2}, "requires checkpoint_dir")):
        for m in (ht, hj):
            with pytest.raises(ValueError, match=match):
                m.cluster.KMeans(n_clusters=3, **bad)
    with pytest.raises(ValueError):
        ht.cluster.KMeans(n_clusters=3, init=ht.array(np.zeros((2, 4), np.float32))).fit(x)
    with pytest.raises(ValueError):
        ht.cluster.KMeans(max_iter=0)
    monkeypatch = pytest.MonkeyPatch()
    monkeypatch.setenv("HEAT_TPU_PREDICT_DTYPE", "bfloat16")
    try:
        fitted = ht.cluster.KMeans(n_clusters=3, random_state=0).fit(x)
        with pytest.raises(NotImplementedError, match="low-precision predict"):
            fitted.predict(x)
    finally:
        monkeypatch.undo()


# float64 points: the reference fits them by its XLA Lloyd step (its Pallas
# kernel takes float32 only); the port's plain version takes float64 on the
# CPU, as K1's float64 walk route does on the card
CASES_F64 = [(1003, 16, 8, 0), (517, 8, 5, 1), (700, 17, 12, 2)]


@pytest.mark.parametrize("split", [None, 0])
@pytest.mark.parametrize("n,f,k,seed", CASES_F64)
def test_float64_fit_matches_reference(n, f, k, seed, split):
    """Labels bitwise, centres atol 1e-12, inertia rtol 1e-12, the same
    n_iter_, everything back in float64."""
    x = _blobs(n, f, k, seed).astype(np.float64) * 1.5 + 0.25
    want = hj.cluster.KMeans(n_clusters=k, init="random", random_state=seed, max_iter=30).fit(hj.array(x, split=split))
    got = ht.cluster.KMeans(n_clusters=k, init="random", random_state=seed, max_iter=30).fit(ht.array(x, split=split))
    assert got._inertia.dtype == torch.float64  # before inertia_ reads it to the host
    assert got.n_iter_ == want.n_iter_
    assert got.cluster_centers_.dtype is ht.float64 and got.labels_.split == split
    np.testing.assert_allclose(got.cluster_centers_.numpy(), want.cluster_centers_.numpy(), rtol=0, atol=1e-12)
    np.testing.assert_array_equal(got.labels_.numpy(), want.labels_.numpy())
    np.testing.assert_allclose(got.inertia_, want.inertia_, rtol=1e-12)
    fresh = _blobs(300, f, k, seed + 100).astype(np.float64)
    np.testing.assert_array_equal(got.predict(ht.array(fresh, split=0)).numpy(),
                                  want.predict(hj.array(fresh, split=0)).numpy())


def test_integer_points_fit_in_float32():
    """The reference's rule: integer points are cast to float32."""
    x = np.rint(_blobs(400, 8, 4, 5) * 4).astype(np.int64)
    want = hj.cluster.KMeans(n_clusters=4, init="random", random_state=1, max_iter=20).fit(hj.array(x, split=0))
    got = ht.cluster.KMeans(n_clusters=4, init="random", random_state=1, max_iter=20).fit(ht.array(x, split=0))
    assert got.cluster_centers_.dtype is ht.float32
    _assert_same_fit(got, want)


def test_float64_gate():
    """float64 goes by the walk route (16 x 8 fits in shared memory; 128
    features do not), float32 keeps the tc route; the CPU plain version
    takes either."""
    assert kernels.lloyd_route(16, 8, dtype=torch.float64) == "walk"
    assert kernels.lloyd_route(16, 8, dtype=torch.float32) == "tc"
    assert kernels.lloyd_smem_bytes(16, 8, "walk", torch.float64) > kernels.lloyd_smem_bytes(16, 8, "walk")
    assert kernels.lloyd_unsupported(16, 8, torch.float64) is None
    assert "shared memory" in kernels.lloyd_unsupported(128, 8, torch.float64)
    assert "float32 or float64" in kernels.lloyd_unsupported(16, 8, torch.float16)
    x = torch.from_numpy(_blobs(100, 16, 8, 0).astype(np.float64))
    sums, counts, inertia, labels = kernels.lloyd_partials(x, x[:8].clone(), 97, labels=True)
    assert sums.dtype == torch.float64 and int(counts.sum()) == 97 and labels.shape == (100,)
