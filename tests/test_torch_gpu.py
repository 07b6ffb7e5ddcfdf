"""The port's CUDA Lloyd kernel on the card, held against its plain PyTorch
version at small shapes (chip_smoke.py does the same at full size).

Marked ``gpu``: run on a machine with a CUDA card by
``python -m pytest -m gpu tests/test_torch_gpu.py``; elsewhere every test
skips (decided in the fixture, not at import)."""

import numpy as np
import pytest
import torch

import heat_tpu_torch as ht
from heat_tpu_torch.core import kernels

pytestmark = pytest.mark.gpu


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    ht.use_device("gpu")
    yield torch.device("cuda", torch.cuda.current_device())
    ht.use_device("cpu")


def _near_tie_mismatches(x, c, got, want):
    """Label mismatches, after checking each is a near-tie of its two
    half-distances (within 1e-4 (1 + |d|))."""
    bad = torch.nonzero(got != want)[:, 0]
    if bad.numel():
        xb, cc = x[bad].double(), c.double()
        half = (cc * cc).sum(1)[None, :] - 2.0 * xb @ cc.T
        dg = half.gather(1, got[bad, None])[:, 0]
        dw = half.gather(1, want[bad, None])[:, 0]
        assert bool(((dg - dw).abs() <= 1e-4 * (1 + dw.abs())).all())
    return int(bad.numel())


@pytest.mark.parametrize(
    "rows,f,k,n_true",
    [(1003, 16, 8, 1003), (1003, 17, 30, 1003), (1003, 16, 8, 901), (4096, 128, 8, 4000), (777, 4, 3, 777), (300, 64, 40, 299)],
)
def test_kernel_matches_plain(card, rows, f, k, n_true):
    g = torch.Generator(device=card).manual_seed(rows + f + k)
    x = torch.randn(rows, f, device=card, generator=g)
    c = torch.randn(k, f, device=card, generator=g)
    before = kernels.LLOYD_LAUNCHES
    sums, counts, inertia, lab = kernels.lloyd_partials(x, c, n_true, labels=True)
    again = kernels.lloyd_partials(x, c, n_true, labels=True)
    assert kernels.LLOYD_LAUNCHES == before + 2
    ps, pc, pi, pl = kernels._lloyd_plain(x, c, n_true, True)
    torch.cuda.synchronize()
    assert _near_tie_mismatches(x, c, lab, pl) == 0
    assert torch.equal(counts, pc)
    torch.testing.assert_close(sums / counts.clamp(min=1)[:, None], ps / pc.clamp(min=1)[:, None], atol=1e-4, rtol=0)
    torch.testing.assert_close(inertia, pi, rtol=1e-4, atol=0)
    for a, b in zip((sums, counts, inertia, lab), again):
        assert torch.equal(a, b)  # bitwise reproducible


def test_kernel_refuses_what_it_cannot_take(card):
    x = torch.randn(64, 16, device=card)
    with pytest.raises(TypeError):
        kernels.lloyd_partials(x.double(), torch.randn(4, 16, device=card, dtype=torch.float64), 64)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.lloyd_partials(torch.randn(16, 64, device=card).T, torch.randn(4, 16, device=card), 64)
    with pytest.raises(ValueError, match="features"):
        kernels.lloyd_partials(torch.randn(64, 200, device=card), torch.randn(4, 200, device=card), 64)


def test_kmeans_on_the_card_matches_cpu(card):
    # blobs far apart and started from their true centres: no point is near
    # a boundary, so the card and the CPU take the same labels every step
    rng = np.random.default_rng(0)
    centres = (rng.standard_normal((8, 16)) * 10.0).astype(np.float32)
    x = (centres[rng.integers(0, 8, 5000)] + rng.standard_normal((5000, 16))).astype(np.float32)
    before = kernels.LLOYD_LAUNCHES
    got = ht.cluster.KMeans(n_clusters=8, init=ht.array(centres), max_iter=30).fit(ht.array(x, split=0))
    assert got.labels_.larray_padded.device.type == "cuda"
    assert kernels.LLOYD_LAUNCHES - before == got.n_iter_ + 1
    want = ht.cluster.KMeans(n_clusters=8, init=ht.array(centres, device="cpu"), max_iter=30).fit(
        ht.array(x, split=0, device="cpu")
    )
    assert got.n_iter_ == want.n_iter_
    np.testing.assert_allclose(got.cluster_centers_.numpy(), want.cluster_centers_.numpy(), atol=1e-4)
    np.testing.assert_array_equal(got.labels_.numpy(), want.labels_.numpy())
    np.testing.assert_allclose(got.inertia_, want.inertia_, rtol=1e-4)


def test_random_init_fit_on_the_card_is_consistent(card):
    """A random-init fit on the card: one launch per iteration plus the
    assignment, labels and inertia those of its own final centres, predict
    equal to labels_."""
    rng = np.random.default_rng(1)
    centres = rng.standard_normal((8, 16)) * 6.0
    x = (centres[rng.integers(0, 8, 20000)] + rng.standard_normal((20000, 16))).astype(np.float32)
    before = kernels.LLOYD_LAUNCHES
    km = ht.cluster.KMeans(n_clusters=8, init="random", random_state=0, max_iter=30).fit(ht.array(x, split=0))
    assert kernels.LLOYD_LAUNCHES - before == km.n_iter_ + 1
    pts = torch.from_numpy(x).to(card)
    _, _, inertia, labels = kernels._lloyd_plain(pts, km.cluster_centers_.larray, x.shape[0], True)
    assert _near_tie_mismatches(pts, km.cluster_centers_.larray, km.labels_.larray, labels) == 0
    np.testing.assert_allclose(km.inertia_, float(inertia), rtol=1e-4)
    np.testing.assert_array_equal(km.predict(ht.array(x[:4096], split=0)).numpy(), km.labels_.numpy()[:4096])


def test_rand_on_the_card_is_bitwise_the_hosts(card):
    for n in (1, 1003, 65539):
        ht.random.seed(n)
        on_card = ht.random.rand(n).larray_padded
        ht.random.seed(n)
        on_host = ht.random.rand(n, device="cpu").larray_padded
        assert on_card.device.type == "cuda"
        assert torch.equal(on_card.cpu().view(torch.int32), on_host.view(torch.int32))
