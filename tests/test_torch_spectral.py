"""The port's Spectral against heat_tpu's on a world of one, both random
streams seeded alike: tutorial 6's blobs and variants (n_clusters None by
the eigengap, the euclidean metric, an eNeighbour graph), labels bitwise,
the Lanczos eigenvalues within rtol 1e-4, the embedding up to each
column's sign within atol 1e-4, or within 1e-6 over the eigenvalue's gap
to its neighbours where that is larger (an eigenvector turns by a
perturbation over the gap, and the two float32 Lanczos runs differ by
roundings of about 1e-7: 2.2e-7 at most, measured, times the gap), and the
subspace of the leading ``n_clusters`` columns, the one KMeans clusters,
as its projector by the same rule (the gap to the next eigenvalue); the
random stream advanced as the reference advances it."""

import jax
import numpy as np
import pytest

import heat_tpu as hj
import heat_tpu_torch as ht


@pytest.fixture(autouse=True)
def world_of_one():
    ht.use_device("cpu")
    saved = hj.get_comm()
    states = hj.random.get_state(), ht.random.get_state()
    hj.use_comm(hj.Communication(jax.devices()[:1]))
    try:
        yield
    finally:
        hj.use_comm(saved)
        hj.random.set_state(states[0])
        ht.random.set_state(states[1])


def _tutorial_blobs(rows=120):
    rng = np.random.default_rng(0)
    blobs = np.concatenate([rng.normal(-4, 0.6, (200, 2)), rng.normal(0, 0.6, (200, 2)),
                            rng.normal(4, 0.6, (200, 2))]).astype(np.float32)
    return rng.permutation(blobs)[:rows]


CONFIGS = {
    "tutorial": {"n_clusters": 3, "gamma": 0.5, "n_lanczos": 30},
    "eigengap": {"n_clusters": None, "gamma": 0.5, "n_lanczos": 30},
    "euclidean": {"n_clusters": 3, "metric": "euclidean", "n_lanczos": 20},
    "eneighbour": {"n_clusters": 3, "gamma": 0.5, "laplacian": "eNeighbour", "threshold": 1e-4,
                   "boundary": "lower", "n_lanczos": 25},
}


def _embedding_matches(got_vals, got_vecs, want_vals, want_vecs, k):
    np.testing.assert_allclose(got_vals, want_vals, rtol=1e-4, atol=1e-6)
    gaps = np.full(len(want_vals), np.inf)
    d = np.diff(want_vals)
    gaps[:-1] = np.minimum(gaps[:-1], d)
    gaps[1:] = np.minimum(gaps[1:], d)
    sign = np.sign((got_vecs * want_vecs).sum(0))
    sign[sign == 0] = 1
    bound = np.maximum(1e-4, 1e-6 / gaps)
    assert (np.abs(got_vecs * sign - want_vecs).max(0) <= bound).all(), (np.abs(got_vecs * sign - want_vecs).max(0),
                                                                           bound)
    lead_g, lead_w = got_vecs[:, :k], want_vecs[:, :k]
    np.testing.assert_allclose(lead_g @ lead_g.T, lead_w @ lead_w.T, atol=max(1e-4, 1e-6 / d[k - 1]))


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("split", [None, 0])
def test_spectral_matches_reference(name, split):
    x = _tutorial_blobs()
    hj.random.seed(0)
    ht.random.seed(0)
    theirs = hj.cluster.Spectral(**CONFIGS[name])
    want_vals, want_vecs = theirs._spectral_embedding(hj.array(x, split=split))
    mine = ht.cluster.Spectral(**CONFIGS[name])
    got_vals, got_vecs = mine._spectral_embedding(ht.array(x, split=split))
    assert got_vecs.split == want_vecs.split and got_vecs.shape == want_vecs.shape
    k = CONFIGS[name]["n_clusters"] or 3
    _embedding_matches(got_vals.numpy(), got_vecs.numpy(), np.asarray(want_vals), np.asarray(want_vecs.numpy()), k)

    hj.random.seed(0)
    ht.random.seed(0)
    want = hj.cluster.Spectral(**CONFIGS[name]).fit(hj.array(x, split=split))
    got = ht.cluster.Spectral(**CONFIGS[name])
    labels = got.fit_predict(ht.array(x, split=split))
    assert got.n_clusters == want.n_clusters
    assert labels.split == want.labels_.split and labels.dtype.__name__ == want.labels_.dtype.__name__
    np.testing.assert_array_equal(labels.numpy(), np.asarray(want.labels_.numpy()))
    assert ht.random.get_state()[:3] == hj.random.get_state()[:3]


def test_parameters_and_refusals_match_reference():
    kw = {"n_clusters": 4, "gamma": 2.0, "metric": "euclidean", "laplacian": "eNeighbour", "threshold": 0.3,
          "boundary": "lower", "n_lanczos": 50}
    mine, theirs = ht.cluster.Spectral(**kw), hj.cluster.Spectral(**kw)
    assert mine.get_params() == theirs.get_params()
    assert mine.predict(None) is None and mine.labels_ is None
    for m in (ht, hj):
        with pytest.raises(NotImplementedError):
            m.cluster.Spectral(metric="cosine")
        with pytest.raises(NotImplementedError):
            m.cluster.Spectral(assign_labels="discretize")
        with pytest.raises(ValueError):
            m.cluster.Spectral(n_clusters=2).fit(_tutorial_blobs())
        with pytest.raises(ValueError):
            m.cluster.Spectral(n_clusters=2).fit(m.array(_tutorial_blobs()[:, 0]))
