"""The port's BatchParallelKMeans and BatchParallelKMedians against
heat_tpu's: on a world of one (one batch) over float32, float64 and int32
points, seeds None, 1 and 3, split None and 0, labels bitwise and centres
within atol 5e-5, predict on fresh rows; the p-batch algorithm (keys
``split(key, p + 1)``, p batches of n // p rows, the merge of the p k
centres) assembled in one process against the reference on 3 devices; the
direct-form distances in row blocks within the block budget; the
refusals."""

import jax
import numpy as np
import pytest
import torch

import heat_tpu as hj
import heat_tpu_torch as ht
from heat_tpu_torch.cluster import batchparallelclustering as bp
from heat_tpu_torch.core import random as rnd

CLASSES = ["BatchParallelKMeans", "BatchParallelKMedians"]


@pytest.fixture(autouse=True)
def world_of_one():
    ht.use_device("cpu")
    saved = hj.get_comm()
    hj.use_comm(hj.Communication(jax.devices()[:1]))
    try:
        yield
    finally:
        hj.use_comm(saved)


def _blobs(n=1003, f=6, k=5, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    centres = rng.standard_normal((k, f)) * 6.0
    x = centres[rng.integers(0, k, n)] + rng.standard_normal((n, f))
    return (np.round(x * 4) if np.dtype(dtype).kind == "i" else x).astype(dtype)


def _same_fit(mine, theirs):
    np.testing.assert_allclose(mine.cluster_centers_.numpy(), np.asarray(theirs.cluster_centers_.numpy()), atol=5e-5)
    assert mine.cluster_centers_.split is None and mine.cluster_centers_.dtype.__name__ == \
        theirs.cluster_centers_.dtype.__name__
    assert mine.labels_.dtype == ht.int32 and mine.labels_.split == theirs.labels_.split
    np.testing.assert_array_equal(mine.labels_.numpy(), np.asarray(theirs.labels_.numpy()))


@pytest.mark.parametrize("cls", CLASSES)
@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int32])
@pytest.mark.parametrize("seed", [None, 1, 3])
def test_fit_and_predict_match_reference(cls, dtype, seed):
    x = _blobs(dtype=dtype)
    fresh = _blobs(n=211, seed=9, dtype=dtype)
    for split in (None, 0):
        mine = getattr(ht.cluster, cls)(n_clusters=5, random_state=seed).fit(ht.array(x, split=split))
        theirs = getattr(hj.cluster, cls)(n_clusters=5, random_state=seed).fit(hj.array(x, split=split))
        _same_fit(mine, theirs)
        np.testing.assert_array_equal(mine.predict(ht.array(fresh, split=split)).numpy(),
                                      np.asarray(theirs.predict(hj.array(fresh, split=split)).numpy()))
        assert mine.get_params() == theirs.get_params()


@pytest.mark.parametrize("cls", CLASSES)
@pytest.mark.parametrize("max_iter,tol", [(1, 1e-4), (300, 0.0), (4, 10.0)])
def test_stop_rules_match_reference(cls, max_iter, tol):
    x = _blobs(n=517, f=3, k=4, seed=5)
    mine = getattr(ht.cluster, cls)(n_clusters=4, max_iter=max_iter, tol=tol, random_state=2).fit(ht.array(x))
    theirs = getattr(hj.cluster, cls)(n_clusters=4, max_iter=max_iter, tol=tol, random_state=2).fit(hj.array(x))
    _same_fit(mine, theirs)


@pytest.mark.parametrize("cls", CLASSES)
def test_p_batches_and_the_merge_match_the_reference_on_three_devices(cls):
    """p = 3: batch r is rows [r n//3, (r+1) n//3) seeded by key r of
    split(PRNGKey(seed), 4), the remainder dropped, the 3 k centres merged
    with key 3 (what each rank of a world of 3 runs, assembled here)."""
    x = _blobs(n=1000, f=4, k=3, seed=6)
    medians = cls.endswith("Medians")
    keys = rnd._split(rnd._key_from_seed(7), 4)
    per = x.shape[0] // 3
    local = [bp._lloyd_batch(keys[r], torch.from_numpy(x[r * per:(r + 1) * per]), 3, 300, 1e-4, medians)
             for r in range(3)]
    final = bp._lloyd_batch(keys[3], torch.cat(local), 3, 300, 1e-4, medians)
    theirs = getattr(hj.cluster, cls)(n_clusters=3, random_state=7).fit(
        hj.array(x, split=0, comm=hj.Communication(jax.devices()[:3])))
    np.testing.assert_allclose(final.numpy(), np.asarray(theirs.cluster_centers_.numpy()), atol=5e-5)


def test_few_rows_take_one_batch_on_three_devices():
    x = _blobs(n=8, f=2, k=3, seed=8)
    mine = bp._lloyd_batch(rnd._key_from_seed(0), torch.from_numpy(x), 3, 300, 1e-4, False)
    theirs = hj.cluster.BatchParallelKMeans(n_clusters=3).fit(
        hj.array(x, split=0, comm=hj.Communication(jax.devices()[:3])))
    np.testing.assert_allclose(mine.numpy(), np.asarray(theirs.cluster_centers_.numpy()), atol=5e-5)


@pytest.mark.parametrize("cls", CLASSES)
def test_distances_run_in_blocks_within_the_budget(cls, monkeypatch):
    x = _blobs(n=301, f=4, k=3, seed=10)
    whole = getattr(ht.cluster, cls)(n_clusters=3, random_state=4).fit(ht.array(x))
    budget, widest = 3 * 4 * 16, [0]
    monkeypatch.setattr(bp, "_BLOCK_ELEMENTS", budget)
    real = bp._sq_dist

    def spy(xb, c):
        widest[0] = max(widest[0], xb.shape[0] * c.shape[0] * xb.shape[1])
        return real(xb, c)

    monkeypatch.setattr(bp, "_sq_dist", spy)
    blocked = getattr(ht.cluster, cls)(n_clusters=3, random_state=4).fit(ht.array(x))
    assert 0 < widest[0] <= budget
    # the sums add block by block: another order of the same additions
    np.testing.assert_allclose(blocked.cluster_centers_.numpy(), whole.cluster_centers_.numpy(), atol=5e-5)
    np.testing.assert_array_equal(blocked.labels_.numpy(), whole.labels_.numpy())


def test_refusals_match_reference():
    x = _blobs(n=40, f=2, k=2)
    for m in (ht, hj):
        for cls, bad in (("BatchParallelKMeans", "kmeans++"), ("BatchParallelKMedians", "k-means++")):
            with pytest.raises(ValueError):
                getattr(m.cluster, cls)(init=bad)
            with pytest.raises(TypeError):
                getattr(m.cluster, cls)(init=3)
            est = getattr(m.cluster, cls)(n_clusters=2)
            with pytest.raises(RuntimeError):
                est.predict(m.array(x))
            with pytest.raises(TypeError):
                est.fit(x)
            with pytest.raises(ValueError):
                est.fit(m.array(x[:, 0]))
            with pytest.raises(ValueError):
                est.fit(m.array(x, split=1))
    for init in ("random", "++"):
        assert ht.cluster.BatchParallelKMeans(init=init).init == init
