"""The estimators on the port's distances against heat_tpu's: KMedians,
KMedoids, KNeighborsClassifier, the graph Laplacian and the spherical
datasets, on the same seeded numpy inputs (the port on one CPU rank, the
reference on the suite's 8 devices).

Labels, n_iter_, neighbour votes and medoids are equal and KMedians'
centres bitwise (the data keep every point away from a tie; the medians
are order statistics the port finds exactly); inertia_ within rtol 1e-5;
the Laplacian within atol 1e-6; the spherical points bitwise (float64: the
port's normals are within an ulp of the reference's).  The world of
3 ranks is in tests/test_torch_gloo.py."""

import numpy as np
import pytest
import torch

import heat_tpu as hj
import heat_tpu_torch as ht
from heat_tpu.serving.model_io import export_state
from heat_tpu_torch.cluster import kmedians


@pytest.fixture(autouse=True)
def _port_on_cpu():
    ht.use_device("cpu")


@pytest.fixture
def blobs():
    """tests/test_ml.py's blobs."""
    rng = np.random.default_rng(0)
    c = np.array([[0.0, 0.0], [6.0, 6.0], [0.0, 7.0]], dtype=np.float32)
    pts = np.concatenate([rng.normal(c[i], 0.4, size=(40, 2)) for i in range(3)]).astype(np.float32)
    labels = np.repeat(np.arange(3), 40)
    perm = rng.permutation(len(pts))
    return pts[perm], labels[perm]


def _same_fit(got, want):
    assert got.n_iter_ == want.n_iter_
    np.testing.assert_array_equal(got.labels_.numpy(), want.labels_.numpy())
    assert got.labels_.split == want.labels_.split == 0
    np.testing.assert_array_equal(got.cluster_centers_.numpy(), want.cluster_centers_.numpy())
    np.testing.assert_allclose(got.inertia_, want.inertia_, rtol=1e-5)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("plus", [False, True])
@pytest.mark.parametrize("name", ["KMedians", "KMedoids"])
def test_fit_matches_the_reference(blobs, name, plus, seed):
    pts, _ = blobs
    init = ("kmedians++" if name == "KMedians" else "kmedoids++") if plus else "random"
    want = getattr(hj.cluster, name)(n_clusters=3, init=init, random_state=seed).fit(hj.array(pts, split=0))
    got = getattr(ht.cluster, name)(n_clusters=3, init=init, random_state=seed).fit(ht.array(pts, split=0))
    _same_fit(got, want)
    fresh = np.random.default_rng(seed + 10).normal(3.0, 3.0, (37, 2)).astype(np.float32)
    np.testing.assert_array_equal(got.predict(ht.array(fresh, split=0)).numpy(),
                                  want.predict(hj.array(fresh, split=0)).numpy())


@pytest.mark.parametrize("name", ["KMedians", "KMedoids"])
def test_unsplit_integer_points_and_one_iteration(blobs, name):
    pts, _ = blobs
    ints = np.round(pts * 3).astype(np.int32)
    for kw in ({}, {"max_iter": 1}):
        want = getattr(hj.cluster, name)(n_clusters=3, random_state=2, **kw).fit(hj.array(ints))
        got = getattr(ht.cluster, name)(n_clusters=3, random_state=2, **kw).fit(ht.array(ints))
        assert got.labels_.split is None
        assert got.n_iter_ == want.n_iter_
        np.testing.assert_array_equal(got.labels_.numpy(), want.labels_.numpy())
        np.testing.assert_array_equal(got.cluster_centers_.numpy(), want.cluster_centers_.numpy())


def test_median_of_an_even_count_is_the_midpoint():
    """Clusters of 4 and 6 members: one update moves each centre to the
    midpoint of its two middle values per feature, as the reference's loop
    (jnp.nanmedian) does, which torch.nanmedian (the lower one) does not.
    The reference's KMedians takes no array as init, so its loop is
    called on the same centres."""
    from heat_tpu.cluster.kmedians import _kmedians_loop

    a = np.array([[0.0, 1.0], [0.5, 1.5], [1.5, 0.25], [0.75, 3.0]], np.float32)
    b = np.array([[9.0, 9.0], [10.0, 9.5], [9.25, 11.0], [12.0, 10.0], [11.0, 12.5], [10.5, 8.0]], np.float32)
    x = np.concatenate([a, b])
    start = np.array([[0.0, 0.0], [10.0, 10.0]], np.float32)
    want, n_iter, _ = _kmedians_loop(x, start, 2, 1, 1e-4)
    got = ht.cluster.KMedians(n_clusters=2, init=ht.array(start), max_iter=1).fit(ht.array(x, split=0))
    assert got.n_iter_ == int(n_iter) == 1
    np.testing.assert_array_equal(got.cluster_centers_.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.cluster_centers_.numpy(), [[0.625, 1.25], [10.25, 9.75]])
    lower = torch.nanmedian(torch.tensor(a), dim=0).values.numpy()
    assert (lower != got.cluster_centers_.numpy()[0]).all()


def test_order_statistics_across_the_key_range():
    """The order-preserving keys sort as the values do (negative, -0.0,
    +0.0, the infinities; NaN last), and the bisection finds every order
    statistic of each centre's members exactly."""
    rng = np.random.default_rng(3)
    v = np.concatenate([rng.standard_normal(40) * 10.0 ** rng.integers(-30, 30, 40),
                        [0.0, -0.0, np.inf, -np.inf, np.nan, 1e-45, -1e-45]]).astype(np.float32)
    for dtype in (torch.float32, torch.float64, torch.float16):
        t = torch.tensor(v).to(dtype)
        key = kmedians._ordered(t)
        order = torch.argsort(key, stable=True)
        finite = t[order][~torch.isnan(t[order])]
        assert bool((finite[1:] >= finite[:-1]).all()) and bool(torch.isnan(t[order][-1]))
        back = kmedians._from_ordered(key.to(torch.int64), dtype)
        same = (back == t) | (torch.isnan(back) & torch.isnan(t))
        assert bool(same.all())
    x = torch.tensor(rng.standard_normal((50, 3)), dtype=torch.float32)
    labels = torch.tensor(rng.integers(0, 2, 50))
    members = labels[None, :] == torch.arange(2)[:, None]
    ranks = torch.tensor([[[0, 5], [10, 20], [3, 3]], [[1, 2], [7, 7], [0, 9]]])
    key = kmedians._ordered(x)
    keys = kmedians._order_statistics([key[m].T.contiguous() for m in members], ranks, lambda c: c)
    for j in range(2):
        ordered = torch.sort(x[members[j]], dim=0).values
        for f in range(3):
            for s in range(2):
                assert kmedians._from_ordered(keys[j, f, s], torch.float32) == ordered[ranks[j, f, s], f]


@pytest.mark.parametrize("name", ["KMedians", "KMedoids"])
def test_predict_stays_native_under_a_low_precision_request(blobs, name, monkeypatch):
    """The reference's bitwise kinds predict in native float32 whatever
    HEAT_TPU_PREDICT_DTYPE asks; so do the port's."""
    pts, _ = blobs
    est = getattr(ht.cluster, name)(n_clusters=3, random_state=0).fit(ht.array(pts, split=0))
    native = est.predict(ht.array(pts, split=0)).numpy()
    monkeypatch.setenv("HEAT_TPU_PREDICT_DTYPE", "bfloat16")
    np.testing.assert_array_equal(est.predict(ht.array(pts, split=0)).numpy(), native)
    ref = getattr(hj.cluster, name)(n_clusters=3, random_state=0).fit(hj.array(pts, split=0))
    np.testing.assert_array_equal(ref.predict(hj.array(pts, split=0)).numpy(), native)


def test_checkpoint_options_and_bad_input_raise():
    for cls in (ht.cluster.KMedians, ht.cluster.KMedoids):
        with pytest.raises(ValueError, match="positive int"):
            cls(n_clusters=2, checkpoint_every=1.5, checkpoint_dir="unused")
        assert cls(n_clusters=2, checkpoint_every=1, checkpoint_dir="unused").checkpoint_every == 1
        with pytest.raises(ValueError):
            cls(n_clusters=2).fit(np.zeros((4, 2)))
        with pytest.raises(ValueError):
            cls(n_clusters=2).fit(ht.zeros((4,)))
    assert ht.cluster.KMedians(init="kmedians++").init == "probability_based"
    assert ht.cluster.KMedoids(init="kmedoids++").init == "probability_based"


def _knn_data(seed):
    rng = np.random.default_rng(seed)
    centres = rng.standard_normal((4, 5)) * 4.0
    lab = rng.integers(0, 4, 203)
    train = (centres[lab] + rng.standard_normal((203, 5))).astype(np.float32)
    queries = (centres[rng.integers(0, 4, 61)] + 1.5 * rng.standard_normal((61, 5))).astype(np.float32)
    return train, lab, queries


@pytest.mark.parametrize("k", [1, 3, 5])
@pytest.mark.parametrize("qsplit", [None, 0])
@pytest.mark.parametrize("tsplit", [None, 0])
def test_knn_predicts_the_references_classes(tsplit, qsplit, k):
    train, lab, queries = _knn_data(k)
    want = hj.classification.KNeighborsClassifier(k).fit(hj.array(train, split=tsplit), hj.array(lab, split=tsplit))
    got = ht.classification.KNeighborsClassifier(k).fit(ht.array(train, split=tsplit), ht.array(lab, split=tsplit))
    pw, pg = want.predict(hj.array(queries, split=qsplit)), got.predict(ht.array(queries, split=qsplit))
    assert pg.split == pw.split and pg.dtype is ht.int64 and pw.dtype.__name__ == "int64"
    np.testing.assert_array_equal(pg.numpy(), pw.numpy())


def test_knn_with_one_hot_rows_ties_and_refusals():
    train, lab, queries = _knn_data(7)
    onehot = np.eye(4, dtype=np.float32)[lab]
    want = hj.classification.KNeighborsClassifier(4).fit(hj.array(train, split=0), hj.array(onehot, split=0))
    got = ht.classification.KNeighborsClassifier(4).fit(ht.array(train, split=0), ht.array(onehot, split=0))
    # four neighbours: two-two votes, decided by the first class
    np.testing.assert_array_equal(got.predict(ht.array(queries, split=0)).numpy(),
                                  want.predict(hj.array(queries, split=0)).numpy())
    with pytest.raises(RuntimeError):
        ht.classification.KNeighborsClassifier().predict(ht.array(queries))
    with pytest.raises(TypeError):
        ht.classification.KNeighborsClassifier().fit(train, ht.array(lab))
    with pytest.raises(ValueError):
        ht.classification.KNeighborsClassifier(300).fit(ht.array(train), ht.array(lab)).predict(ht.array(queries))


def test_knn_low_precision_raises(monkeypatch):
    train, lab, queries = _knn_data(8)
    knn = ht.classification.KNeighborsClassifier(3).fit(ht.array(train), ht.array(lab))
    monkeypatch.setenv("HEAT_TPU_PREDICT_DTYPE", "bfloat16")
    with pytest.raises(NotImplementedError, match="item 18"):
        knn.predict(ht.array(queries))


@pytest.mark.parametrize("split", [None, 0])
def test_one_hot_encoding(split):
    labels = np.array([2, 0, 1, 4, 4, 0, 3, 1, 2], np.int64)
    for values, num in ((labels, None), (labels, 6), (labels.astype(np.float32) + 0.7, None)):
        got = ht.classification.one_hot_encoding(ht.array(values, split=split), num)
        want = hj.classification.one_hot_encoding(hj.array(values, split=split), num)
        assert got.split == want.split and got.dtype is ht.float32
        np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("mode,key", [("fully_connected", "upper"), ("eNeighbour", "upper"), ("eNeighbour", "lower")])
@pytest.mark.parametrize("definition", ["simple", "norm_sym"])
@pytest.mark.parametrize("split", [None, 0])
def test_laplacian_matches_the_reference(blobs, split, definition, mode, key, weighted):
    """Every definition and mode within atol 1e-6 of the reference's
    unsplit Laplacian (one rank computes the same rows whatever the
    split), split like the reference's.  The reference's ring (split 0 on
    8 devices) rounds the rbf's cross term otherwise, up to 7e-6 of its
    value: the world of 3 ranks holds the port against that ring."""
    pts, _ = blobs
    kw = dict(definition=definition, mode=mode, threshold_key=key, threshold_value=0.5, weighted=weighted)

    def construct(pkg, s):
        return pkg.graph.Laplacian(lambda z: pkg.spatial.rbf(z, sigma=1.0), **kw).construct(pkg.array(pts[:20], split=s))

    got, want = construct(ht, split), construct(hj, split)
    assert got.split == want.split and got.shape == want.shape and got.dtype.__name__ == want.dtype.__name__
    np.testing.assert_allclose(got.numpy(), construct(hj, None).numpy(), rtol=0, atol=1e-6)
    if definition == "norm_sym" and mode == "fully_connected":
        L = got.numpy()
        np.testing.assert_allclose(np.diag(L), 1.0, atol=1e-5)  # tests/test_ml.py's checks
        np.testing.assert_allclose(L, L.T, atol=1e-5)


def test_laplacian_refusals():
    sim = ht.spatial.rbf
    with pytest.raises(NotImplementedError):
        ht.graph.Laplacian(sim, definition="norm_rw")
    with pytest.raises(NotImplementedError):
        ht.graph.Laplacian(sim, mode="kNN")
    with pytest.raises(ValueError):
        ht.graph.Laplacian(sim, mode="eNeighbour", threshold_key="middle")


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_spherical_dataset_is_the_references(dtype):
    for n, radius, offset, state in ((50, 1.0, 4.0, 1), (33, 1.5, 2.5, 7)):
        got = ht.utils.data.spherical.create_spherical_dataset(n, radius, offset, dtype=dtype, random_state=state)
        want = hj.utils.data.create_spherical_dataset(n, radius, offset, dtype=getattr(hj, dtype), random_state=state)
        assert got.split == want.split == 0 and got.shape == want.shape == (4 * n, 3)
        assert got.dtype.__name__ == want.dtype.__name__ == dtype
        g, w = got.numpy(), np.asarray(want.numpy())
        if dtype == "float32":
            np.testing.assert_array_equal(g, w)
        else:  # the port's float64 normals are within an ulp of the reference's: within an ulp of the data's scale
            np.testing.assert_allclose(g, w, rtol=0, atol=np.spacing(np.abs(w).max()))
        assert ht.random.get_state() == hj.random.get_state()


@pytest.mark.parametrize("stds", ["per cluster", "per feature", "matrix"])
@pytest.mark.parametrize("weights", [None, [1.0, 2.0, 3.5]])
def test_clusters_are_the_references(stds, weights):
    means = [[0.0, 1.0, 2.0], [5.0, 5.0, -5.0], [-4.0, 0.5, 3.0]]
    std = {"per cluster": [1.0, 0.5, 2.0],
           "per feature": np.array([[1.0, 2.0, 0.5], [0.3, 0.3, 0.3], [2.0, 1.0, 1.0]], np.float32),
           "matrix": np.array([np.eye(3) * 0.5, [[1.0, 0.2, 0.0], [0.0, 1.0, 0.1], [0.0, 0.0, 2.0]], np.eye(3)],
                              np.float32)}[stds]
    got = ht.utils.data.create_clusters(101, 3, 3, means, std, cluster_weight=weights, random_state=4)
    want = hj.utils.data.create_clusters(101, 3, 3, means, std, cluster_weight=weights, random_state=4)
    assert got.dtype.__name__ == want.dtype.__name__ and got.shape == want.shape and got.split == want.split
    g, w = got.numpy(), np.asarray(want.numpy())
    if stds == "matrix":  # a matrix product: within one ulp
        np.testing.assert_array_less(np.abs(g - w), np.spacing(np.abs(w)) + 1e-30)
    else:
        np.testing.assert_array_equal(g, w)


def _numpy_leaves(doc):
    state = {k: (v.numpy() if hasattr(v, "numpy") else v) for k, v in doc["state"].items()}
    return {**doc, "state": state}


@pytest.mark.parametrize("name", ["KMedians", "KMedoids", "KNeighborsClassifier"])
def test_reference_state_carries_over(blobs, name):
    pts, lab = blobs
    fresh = np.random.default_rng(4).normal(3.0, 3.0, (41, 2)).astype(np.float32)
    if name == "KNeighborsClassifier":
        ref = hj.classification.KNeighborsClassifier(3).fit(hj.array(pts, split=0), hj.array(lab, split=0))
    else:
        ref = getattr(hj.cluster, name)(n_clusters=3, random_state=0).fit(hj.array(pts, split=0))
    est = ht.interop.from_reference_state(_numpy_leaves(export_state(ref)))
    assert type(est).__name__ == name
    np.testing.assert_array_equal(est.predict(ht.array(fresh, split=0)).numpy(),
                                  ref.predict(hj.array(fresh, split=0)).numpy())
