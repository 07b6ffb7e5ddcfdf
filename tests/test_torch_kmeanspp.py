"""KMeans' kmeans++ init in the port against heat_tpu's, and the prefix
sums it rides on.

The port draws as the reference does (one randint for the first centre,
then one rand(1) per added centre) and runs the greedy D^2 rounds on each
rank's own rows (``_kcluster._kmeanspp_indices``): its centres are the
reference's rows, bitwise, and the fit after them meets the KMeans contract
(labels bitwise, centres atol 5e-5, inertia rtol 1e-4, equal n_iter_).  The
world of 3 ranks is in tests/test_torch_gloo.py."""

import numpy as np
import pytest
import torch

import heat_tpu as hj
import heat_tpu_torch as ht
from heat_tpu.core import kernels as ref_kernels
from heat_tpu_torch.cluster import _kcluster


@pytest.fixture(autouse=True)
def _port_on_cpu():
    ht.use_device("cpu")


def _blobs(n, f, k, seed):
    """tests/test_torch_kmeans.py's blobs."""
    rng = np.random.default_rng(seed)
    centres = rng.standard_normal((k, f)) * 6.0
    return (centres[rng.integers(0, k, n)] + rng.standard_normal((n, f))).astype(np.float32)


def _interop_blobs(seed):
    """tests/test_torch_interop.py's 700 x 8 blobs of 6 clusters."""
    rng = np.random.default_rng(seed)
    centres = rng.standard_normal((6, 8)) * 5.0
    return (centres[rng.integers(0, 6, 700)] + rng.standard_normal((700, 8))).astype(np.float32)


def _data(case, seed):
    return (_blobs(1003, 16, 8, seed), 8) if case == "1003x16" else (_interop_blobs(seed), 6)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("case", ["1003x16", "700x8"])
def test_init_centres_are_the_references_rows(case, seed):
    x, k = _data(case, seed)
    ref = hj.cluster.KMeans(n_clusters=k, init="kmeans++", random_state=seed)
    ref._initialize_cluster_centers(hj.array(x, split=0))
    got = ht.cluster.KMeans(n_clusters=k, init="kmeans++", random_state=seed)
    got._initialize_cluster_centers(ht.array(x, split=0))
    want = ref._cluster_centers.numpy()
    np.testing.assert_array_equal(got._cluster_centers.numpy(), want)
    assert ht.random.get_state() == hj.random.get_state() == ("Threefry", seed, k, 0, 0.0)  # 1 + (k - 1) draws
    assert len({row.tobytes() for row in want}) == k  # k distinct rows of x
    assert all((x == row).all(1).any() for row in want)


@pytest.mark.parametrize("ref_kernel", [False, True])
@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("case", ["1003x16", "700x8"])
def test_kmeanspp_fit_and_predict(case, seed, ref_kernel, monkeypatch):
    monkeypatch.setattr(ref_kernels, "LLOYD_KERNEL", ref_kernel)
    x, k = _data(case, seed)
    want = hj.cluster.KMeans(n_clusters=k, init="kmeans++", random_state=seed, max_iter=30).fit(hj.array(x, split=0))
    got = ht.cluster.KMeans(n_clusters=k, init="kmeans++", random_state=seed, max_iter=30).fit(ht.array(x, split=0))
    assert got.n_iter_ == want.n_iter_
    np.testing.assert_allclose(got.cluster_centers_.numpy(), want.cluster_centers_.numpy(), atol=5e-5)
    np.testing.assert_array_equal(got.labels_.numpy(), want.labels_.numpy())
    np.testing.assert_allclose(got.inertia_, want.inertia_, rtol=1e-4)
    fresh = _blobs(300, x.shape[1], k, seed + 100)
    np.testing.assert_array_equal(got.predict(ht.array(fresh, split=0)).numpy(),
                                  want.predict(hj.array(fresh, split=0)).numpy())


@pytest.mark.parametrize("init", ["probability_based", "++"])
def test_aliases_unsplit_points_and_one_cluster(init):
    x = _blobs(517, 8, 5, 1)
    for k, split in ((5, None), (1, 0)):
        ref = hj.cluster.KMeans(n_clusters=k, init=init, random_state=3)
        ref._initialize_cluster_centers(hj.array(x, split=split))
        got = ht.cluster.KMeans(n_clusters=k, init=init, random_state=3)
        got._initialize_cluster_centers(ht.array(x, split=split))
        np.testing.assert_array_equal(got._cluster_centers.numpy(), ref._cluster_centers.numpy())
        assert ht.random.get_state() == hj.random.get_state()


def test_integer_points_are_seeded_as_float32():
    x = np.random.default_rng(2).integers(-20, 20, (300, 4))
    want = hj.cluster.KMeans(n_clusters=4, init="kmeans++", random_state=0, max_iter=10).fit(hj.array(x, split=0))
    got = ht.cluster.KMeans(n_clusters=4, init="kmeans++", random_state=0, max_iter=10).fit(ht.array(x, split=0))
    assert got.cluster_centers_.dtype == ht.float32
    np.testing.assert_allclose(got.cluster_centers_.numpy(), want.cluster_centers_.numpy(), atol=5e-5)
    np.testing.assert_array_equal(got.labels_.numpy(), want.labels_.numpy())


def test_the_draw_gathers_no_points(monkeypatch):
    """The rounds read only this rank's rows: no DNDarray is made dense and
    nothing is all-gathered."""

    def refuse(*args, **kwargs):
        raise AssertionError("the kmeans++ draw gathered the points")

    x = ht.array(_blobs(1003, 16, 8, 0), split=0)
    monkeypatch.setattr(ht.DNDarray, "_dense", refuse)
    monkeypatch.setattr(ht.Communication, "all_gather", refuse)
    idx = _kcluster._kmeanspp_indices(x, 5, [0.25, 0.5, 0.75])
    assert idx.dtype == torch.int64 and idx.shape == (4,) and int(idx[0]) == 5


def test_points_split_along_columns_are_refused():
    x = ht.array(_blobs(50, 4, 3, 0), split=1)
    with pytest.raises(NotImplementedError, match="split=1"):
        ht.cluster.KMeans(n_clusters=3, init="kmeans++", random_state=0).fit(x)


def test_pick_rule_at_the_ends():
    """u = 0 takes the first row (its cumulative sum is at least 0); a u no
    cumulative sum reaches takes the last row, as the reference's
    clip(searchsorted, 0, n - 1) does."""
    x = ht.array(_blobs(50, 4, 3, 0), split=0)
    assert _kcluster._kmeanspp_indices(x, 7, [0.0]).tolist() == [7, 0]
    assert _kcluster._kmeanspp_indices(x, 7, [2.0]).tolist() == [7, 49]


def test_scans_in_a_world_of_one():
    """The inclusive scan of one rank is its value, the exclusive one zero;
    a ppermute that names no pair for the only rank gives it zeros (it gave
    back its input before)."""
    comm = ht.get_comm()
    assert comm.size == 1
    x = torch.tensor([3.0, -1.5])
    assert torch.equal(comm.pscan(x), x)
    assert torch.equal(comm.exscan(x), torch.zeros(2))
    assert torch.equal(comm.ppermute(x, []), torch.zeros(2))
    assert torch.equal(comm.ppermute(x, [(0, 0)]), x)
    assert torch.equal(comm.exscan(torch.tensor([7], dtype=torch.int64)), torch.zeros(1, dtype=torch.int64))


@pytest.mark.parametrize("n", [0, 1, 1003, 4096, 4097, 20000])
def test_ordered_cumsum(n):
    """The fixed-order scan that kmeans++ and choice(p=...) run on the card
    (``arithmetics._blocked_scan``, called here on CPU tensors): blocks of
    4096 scanned row by row, each offset by torch's scan of the totals of
    the blocks before it; within float32 rounding of the float64
    cumulative sum, equal to torch.cumsum within the first block."""
    from heat_tpu_torch.core import arithmetics

    w = torch.from_numpy(np.random.default_rng(n).random(n).astype(np.float32))
    got = arithmetics._blocked_scan(w, 0, torch.cumsum, torch.add, 0)
    assert got.dtype == torch.float32 and got.shape == (n,)
    exact = np.cumsum(w.numpy().astype(np.float64))
    np.testing.assert_allclose(got.numpy(), exact, rtol=2e-6)
    head = min(n, 4096)
    assert torch.equal(got[:head], torch.cumsum(w[:head], 0))
    blocks = [torch.cumsum(w[i:i + 4096], 0) for i in range(0, n, 4096)]
    offsets = torch.cumsum(torch.stack([b[-1] for b in blocks]), 0) if blocks else None
    for i, block in enumerate(blocks):
        expect = block if i == 0 else offsets[i - 1] + block
        assert torch.equal(got[i * 4096:(i + 1) * 4096], expect)


@pytest.mark.parametrize("n,f", [(0, 16), (1, 16), (1003, 16), (1024, 16), (700, 8), (77, 5), (33, 128), (9, 200)])
def test_row_dots_as_one_matrix_product(n, f):
    """x @ c by rows grouped 128 // f at a time against a block-diagonal c,
    the rows left over by a vector product: integers exactly, floats within
    rounding of the float64 product."""
    rng = np.random.default_rng(n + f)
    ints = torch.from_numpy(rng.integers(-50, 50, (n, f)).astype(np.float32))
    c = torch.from_numpy(rng.integers(-50, 50, f).astype(np.float32))
    assert torch.equal(_kcluster._row_dots(ints, c), ints @ c)
    x = torch.from_numpy(rng.standard_normal((n, f)).astype(np.float32))
    got = _kcluster._row_dots(x, c)
    assert got.shape == (n,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), x.double().numpy() @ c.double().numpy(), rtol=1e-5, atol=1e-3)
