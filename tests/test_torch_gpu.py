"""The port's CUDA kernels on the card (the Lloyd step, the Gram matrix, the
FFT kernels and flash attention),
held against their plain PyTorch versions at small shapes (chip_smoke.py
does the same at full size), and the port's other paths on the card (the
sparse layer among them) against the port on the CPU.

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
    with pytest.raises(TypeError):  # float64 points take float64 centres (K1's float64 route)
        kernels.lloyd_partials(x.double(), torch.randn(4, 16, device=card), 64)
    with pytest.raises(TypeError):
        kernels.lloyd_partials(x.half(), torch.randn(4, 16, device=card, dtype=torch.float16), 64)
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


LLOYD_ROUTE_CASES = [
    (1003, 16, 8, 1003),  # the KMeans path's shape, one output tile
    (1003, 16, 30, 1000),  # four cluster tiles
    (4096, 128, 8, 4000),  # eight feature tiles, two ring stages
    (777, 4, 3, 777),  # 4 features zero-filled to 16
    (1000, 32, 24, 999),
    (1003, 20, 12, 1003),  # 20 features in a 32-wide row
    (33, 8, 64, 31),  # eight cluster tiles, one batch and a bit
    (5, 16, 8, 5),  # less than one batch
]


@pytest.mark.parametrize("rows,f,k,n_true", LLOYD_ROUTE_CASES)
def test_tc_route_matches_plain_and_walk(card, rows, f, k, n_true):
    assert kernels.lloyd_route(f, k) == "tc"
    g = torch.Generator(device=card).manual_seed(rows * k + f)
    x = torch.randn(rows, f, device=card, generator=g)
    c = torch.randn(k, f, device=card, generator=g)
    tc = kernels._lloyd_cuda(x, c, n_true, True, "tc")
    again = kernels._lloyd_cuda(x, c, n_true, True, "tc")
    walk = kernels._lloyd_cuda(x, c, n_true, True, "walk")
    ps, pc, pi, pl = kernels._lloyd_plain(x, c, n_true, True)
    torch.cuda.synchronize()
    assert _near_tie_mismatches(x, c, tc[3], pl) == 0
    assert torch.equal(tc[3], walk[3])  # one distance arithmetic on both routes
    assert torch.equal(tc[1], pc)
    torch.testing.assert_close(tc[0] / tc[1].clamp(min=1)[:, None], ps / pc.clamp(min=1)[:, None], atol=1e-4, rtol=0)
    torch.testing.assert_close(tc[2], pi, rtol=1e-4, atol=0)
    for a, b in zip(tc, again):
        assert torch.equal(a, b)  # bitwise reproducible


def test_wrapper_picks_the_route_by_shape_and_alignment(card):
    before = kernels.LLOYD_LAUNCHES
    flat = torch.randn(1003 * 16 + 1, device=card)
    c = torch.randn(8, 16, device=card)
    x = flat[1:].view(1003, 16)  # contiguous, 4 bytes past a 16-byte boundary
    got = kernels.lloyd_partials(x, c, 1003, labels=True)
    want = kernels._lloyd_cuda(x, c, 1003, True, "walk")
    assert kernels.LLOYD_LAUNCHES == before + 2
    for a, b in zip(got, want):
        assert torch.equal(a, b)  # the walk route took it
    with pytest.raises(ValueError, match="tc route"):
        kernels._lloyd_cuda(x, c, 1003, False, "tc")
    with pytest.raises(ValueError, match="tc route"):
        kernels._lloyd_cuda(torch.zeros(64, 17, device=card), torch.zeros(4, 17, device=card), 64, False, "tc")
    with pytest.raises(ValueError, match="tc route"):
        kernels._lloyd_cuda(torch.zeros(64, 16, device=card), torch.zeros(72, 16, device=card), 64, False, "tc")


@pytest.mark.parametrize("route", ["tc", "walk"])
def test_stamped_build_counts_every_phase(card, route):
    g = torch.Generator(device=card).manual_seed(3)
    x = torch.randn(1 << 16, 16, device=card, generator=g)
    c = torch.randn(8, 16, device=card, generator=g)
    before = kernels.LLOYD_LAUNCHES
    cycles = kernels.lloyd_phase_cycles(x, c, x.shape[0], route)
    assert kernels.LLOYD_LAUNCHES == before  # a measurement, not a launch of the main path
    assert tuple(cycles) == kernels.LLOYD_PHASES[route]
    busy = {"tc": ("stage", "distances", "count", "fragments", "sums"),
            "walk": ("stage", "distances", "count", "scan", "list", "sums")}[route]
    assert all(cycles[name] > 0 for name in busy)


THREEFRY_CASES = [(1, 0), (7, 0), (1003, 0), (65539, 0), (70001, (1 << 32) - 35000), (4099, 3 * (1 << 32) + 7)]


@pytest.mark.parametrize("n,start", THREEFRY_CASES)
def test_threefry_kernel_is_bitwise_the_plain_hash(card, n, start):
    from heat_tpu_torch.core import random as rnd

    key = (0x9E3779B9, 0x7F4A7C15)
    before = rnd.THREEFRY_LAUNCHES
    w0, w1 = rnd._threefry_cuda(key, n, card, start, False)
    u = rnd._threefry_cuda(key, n, card, start, True)
    assert rnd.THREEFRY_LAUNCHES == before + 2
    p0, p1 = rnd._random_bits_plain(key, n, card, start)
    assert torch.equal(w0, p0) and torch.equal(w1, p1)
    assert torch.equal(u.view(torch.int32), rnd._unit_f32_plain(p0, p1).view(torch.int32))
    if start >= 1 << 32:
        assert bool((p0 != 0).all())  # the counters' high word reached the hash


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_uniform_on_the_card_is_bitwise_its_plain_path(card, dtype):
    from heat_tpu_torch.core import random as rnd

    dt = getattr(ht, dtype)
    key = (12345, 678)
    for shape in ((1,), (1003,), (33, 65)):
        got = rnd._uniform(key, shape, dt, card)
        want = rnd._uniform(key, shape, dt, torch.device("cpu"))
        assert got.device.type == "cuda" and got.shape == want.shape
        assert torch.equal(got.cpu(), want)
    lo = rnd._uniform(key, (4097,), dt, card, -1.0 + 2.0**-20, 1.0)
    assert torch.equal(lo.cpu(), rnd._uniform(key, (4097,), dt, torch.device("cpu"), -1.0 + 2.0**-20, 1.0))


def test_random_bits_launch_on_the_card_only(card):
    from heat_tpu_torch.core import random as rnd

    before = rnd.THREEFRY_LAUNCHES
    rnd._random_bits((1, 2), 1000, card)
    assert rnd.THREEFRY_LAUNCHES == before + 1
    rnd._random_bits((1, 2), 1000, torch.device("cpu"))
    assert rnd.THREEFRY_LAUNCHES == before + 1
    ht.random.seed(4)
    ht.random.randn(3000)  # on the card: one hash launch
    assert rnd.THREEFRY_LAUNCHES == before + 2


GRAM_CASES = [
    (4233, 128, 4100),  # padding past n_true, poisoned below
    (3 * 2048 + 11, 64, 3 * 2048 + 11),
    (5000, 200, 5000),
    (2049, 512, 2049),
    (100, 128, 100),
    (1003, 37, 1000),  # n % 4 != 0: the kernel's 4-byte copies
]


def _gram_check(x, n_true):
    before = kernels.GRAM_LAUNCHES
    got = kernels.gram_partials(x, n_true)
    again = kernels.gram_partials(x, n_true)
    assert kernels.GRAM_LAUNCHES == before + 2
    want = kernels._gram_plain(x, n_true)
    torch.cuda.synchronize()
    rel = float((got.double() - want.double()).norm() / want.double().norm())
    assert rel <= 5e-6, rel
    assert torch.equal(got, got.T)  # exactly symmetric
    assert torch.equal(got, again)  # bitwise reproducible


@pytest.mark.parametrize("rows,n,n_true", GRAM_CASES)
def test_gram_kernel_matches_plain(card, rows, n, n_true):
    g = torch.Generator(device=card).manual_seed(rows + n)
    x = torch.randn(rows, n, device=card, generator=g)
    x[n_true:] = 1e6
    _gram_check(x, n_true)


def test_gram_kernel_on_unaligned_rows(card):
    # contiguous, but 4 bytes past a 16-byte boundary: the 4-byte copies
    flat = torch.randn(777 * 64 + 1, device=card)
    _gram_check(flat[1:].view(777, 64), 777)


def test_gram_kernel_on_offset_data(card):
    """2^22 x 128 rows of mean 10, uncentred as hsvd_rank receives them: the
    stress case of the tensor-core chains (chip_smoke.py runs it too)."""
    g = torch.Generator(device=card).manual_seed(22)
    x = torch.randn(1 << 22, 128, device=card, generator=g) + 10.0
    _gram_check(x, x.shape[0])


def test_gram_kernel_refuses_what_it_cannot_take(card):
    with pytest.raises(TypeError):
        kernels.gram_partials(torch.randn(64, 16, device=card, dtype=torch.float64), 64)
    with pytest.raises(ValueError, match="columns"):
        kernels.gram_partials(torch.randn(64, 513, device=card), 64)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.gram_partials(torch.randn(16, 64, device=card).T, 64)


def _spectrum_matrix(rows, cols, seed):
    rng = np.random.default_rng(seed)
    scale = np.linspace(6.0, 1.0, 8)[:, None]
    a = rng.standard_normal((rows, 8)) @ (rng.standard_normal((8, cols)) * scale) + 3.0
    return (a + 0.01 * rng.standard_normal((rows, cols))).astype(np.float32)


def test_hsvd_on_the_card_matches_cpu(card):
    a = _spectrum_matrix(20011, 64, 2)
    before = kernels.GRAM_LAUNCHES
    got = ht.linalg.hsvd_rank(ht.array(a, split=0), 6, compute_sv=True)
    assert kernels.GRAM_LAUNCHES == before + 1  # one Gram pass, through the kernel
    assert got[0].larray_padded.device.type == "cuda"
    want = ht.linalg.hsvd_rank(ht.array(a, split=0, device="cpu"), 6, compute_sv=True)
    np.testing.assert_allclose(got[1].numpy(), want[1].numpy(), rtol=1e-4)
    for g, w in ((got[0].numpy(), want[0].numpy()), (got[2].numpy(), want[2].numpy())):
        signs = np.sign(np.sum(g * w, axis=0))
        np.testing.assert_allclose(g * signs, w, atol=1e-4)
    np.testing.assert_allclose(float(got[3]), float(want[3]), atol=1e-5)
    k_card = ht.linalg.hsvd_rtol(ht.array(a, split=0), 1e-3)[0].shape[1]
    assert k_card == ht.linalg.hsvd_rtol(ht.array(a, split=0, device="cpu"), 1e-3)[0].shape[1]


def test_pca_on_the_card_matches_cpu(card):
    a = _spectrum_matrix(5003, 40, 3)
    before = kernels.GRAM_LAUNCHES
    got = ht.decomposition.PCA(n_components=5).fit(ht.array(a, split=0))
    assert kernels.GRAM_LAUNCHES == before + 1
    want = ht.decomposition.PCA(n_components=5).fit(ht.array(a, split=0, device="cpu"))
    gc, wc = got.components_.numpy(), want.components_.numpy()
    signs = np.sign(np.sum(gc * wc, axis=1))
    np.testing.assert_allclose(gc * signs[:, None], wc, atol=1e-4)
    np.testing.assert_allclose(got.explained_variance_ratio_.numpy(), want.explained_variance_ratio_.numpy(), rtol=1e-4)
    fresh = a[:300]
    t_got = got.transform(ht.array(fresh, split=0)).numpy() * signs[None, :]
    t_want = want.transform(ht.array(fresh, split=0, device="cpu")).numpy()
    assert np.all(np.abs(t_got - t_want) <= 1e-4 * (1 + np.abs(t_want)))


# ----------------------------------------------------------------------
# the FFT kernels K3-K6 against their plain versions, and ht.fft on the card
# ----------------------------------------------------------------------
from heat_tpu_torch.fft import _axis_pass, _leading  # noqa: E402


def _rel(got, want):
    got, want = got.double(), want.double()
    return float((got - want).abs().max() / want.abs().max().clamp(min=1e-30))


def _same_planes(got, want, tol=1e-5):
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert _rel(g, w) <= tol


@pytest.mark.parametrize("n,rest", [(128, (4, 64)), (100, (7, 11)), (37, (300,)), (512, (3, 129))])
def test_fft_stage_kernel_matches_plain(card, n, rest):
    g = torch.Generator(device=card).manual_seed(n)
    re = torch.randn(n, *rest, device=card, generator=g)
    im = torch.randn(n, *rest, device=card, generator=g)
    before = _leading.FFT_STAGE_LAUNCHES
    got = _leading._stage_fused(re, im, n, False, 1.0 / n)
    again = _leading._stage_fused(re, im, n, False, 1.0 / n)
    assert _leading.FFT_STAGE_LAUNCHES == before + 2
    want = _leading._stage_fused(re.cpu(), im.cpu(), n, False, 1.0 / n)
    _same_planes([t.cpu() for t in got], want)
    assert all(torch.equal(a, b) for a, b in zip(got, again))  # bitwise reproducible
    c = torch.complex(re, im)  # read in place from a complex64 tensor
    _same_planes([t.cpu() for t in _leading._stage_fused(c.real, c.imag, n, False, 1.0 / n)], want)


@pytest.mark.parametrize("k,b,m", [(128, 3, 128), (96, 5, 37), (64, 1, 200)])
def test_fft_blocked_stage_kernel_matches_plain(card, k, b, m):
    z = torch.randn(k, b, 2 * m, device=card, generator=torch.Generator(device=card).manual_seed(k + m))
    got = _leading._stage_fused_blocked(z, k, m, True, 1.0)
    want = _leading._stage_fused_blocked(z.cpu(), k, m, True, 1.0)
    _same_planes([t.cpu() for t in got], want)


@pytest.mark.parametrize("k,rest,m", [(128, (2,), 128), (64, (3, 5), 50), (33, (), 70)])
def test_fft_pair_kernels_match_plain(card, k, rest, m):
    g = torch.Generator(device=card).manual_seed(k + m)
    z = torch.randn(k, *rest, 2, m, device=card, generator=g)
    before = _leading.FFT_PAIR_LAUNCHES
    got = _leading._stage_pair_fused(z, k, False, 0.5)
    planes = _leading._stage_pair_fused(z, k, False, 0.5, planes=True)
    want = _leading._stage_pair_fused(z.cpu(), k, False, 0.5)
    assert _rel(got.cpu(), want) <= 1e-5
    _same_planes([p.cpu() for p in planes], [want[..., 0, :], want[..., 1, :]])
    assert planes[0]._base is planes[1]._base and planes[0]._base.dtype == torch.complex64
    re = torch.randn(k, *rest, m, device=card, generator=g)
    im = torch.randn(k, *rest, m, device=card, generator=g)
    entry = _leading._entry_pair_fused(re, im, k, True)
    assert _leading.FFT_PAIR_LAUNCHES == before + 3
    assert _rel(entry.cpu(), _leading._entry_pair_fused(re.cpu(), im.cpu(), k, True)) <= 1e-5


@pytest.mark.parametrize("m,n1,n2", [(8, 8, 128), (5, 7, 9), (64, 12, 130), (1, 3, 2)])
def test_fft_ext_kernel_matches_plain_exactly(card, m, n1, n2):
    g = torch.Generator(device=card).manual_seed(m * n1 * n2)
    zr, zi = (torch.randn(m, n1, 2 * n2, device=card, generator=g) for _ in range(2))
    nyr, nyi = (torch.randn(n1, n2, device=card, generator=g) for _ in range(2))
    before = _leading.FFT_EXT_LAUNCHES
    got = _leading._ext_fused(zr, zi, nyr, nyi)
    assert _leading.FFT_EXT_LAUNCHES == before + 1
    want = _leading._ext_fused(zr.cpu(), zi.cpu(), nyr.cpu(), nyi.cpu())
    for a, b in zip(got, want):  # an indexed copy after one subtraction: exact
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("n", [96, 127, 384, 512, 1000, 1024, 6])
@pytest.mark.parametrize("real", [False, True])
def test_fft_axis_kernel_matches_plain(card, n, real):
    g = torch.Generator(device=card).manual_seed(n)
    re = torch.randn(37, n, device=card, generator=g)
    im = None if real else torch.randn(37, n, device=card, generator=g)
    before = _axis_pass.FFT_AXIS_LAUNCHES
    got = _axis_pass.fused_axis_pass(re, im, inverse=not real)
    again = _axis_pass.fused_axis_pass(re, im, inverse=not real)
    assert _axis_pass.FFT_AXIS_LAUNCHES == before + 2
    want = _axis_pass.fused_axis_pass(re.cpu(), None if real else im.cpu(), inverse=not real)
    _same_planes([t.cpu() for t in got], want)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    if not real:
        c = torch.complex(re, im)
        _same_planes([t.cpu() for t in _axis_pass.fused_axis_pass(c.real, c.imag, True)], want)


def _kernel_check(kernel, plain):
    """A K3/K4/K6 wrapper against its plain version on the same card tensors:
    within 1e-5 (max abs error over max abs), and bitwise on a repeat."""
    def outs(r):
        return r if isinstance(r, tuple) else (r,)

    got, again, want = outs(kernel()), outs(kernel()), outs(plain())
    _same_planes([t.cpu() for t in got], [t.cpu() for t in want])
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def _operand(shape, card, g, offset):
    """A contiguous f32 tensor; with ``offset`` its data starts one float past
    an aligned address (only 4-byte aligned, as a view ``z[..., 1:]`` is)."""
    if not offset:
        return torch.randn(*shape, device=card, generator=g)
    flat = torch.randn(int(np.prod(shape)) + 1, device=card, generator=g)
    return flat[1:].view(shape)


def _wcat(n, like, inverse=False, scale=1.0):
    return _leading._w(_leading._w_cat, n, "float32", inverse, scale, like=like)


@pytest.mark.parametrize("n,rest,offset", [(1, (5,), False), (33, (129,), False), (100, (2, 65), True),
                                           (64, (128,), True), (8, (3,), True), (37, (257,), False)])
def test_fft_stage_kernel_on_ragged_and_unaligned_operands(card, n, rest, offset):
    """K3 where K = n is not a multiple of 8 (or is 1), M is one past a tile,
    and the planes are 4-byte aligned; and the same data read in place as
    the two views of one complex64 tensor (8-byte (re, im) copies)."""
    g = torch.Generator(device=card).manual_seed(n + len(rest))
    re, im = _operand((n, *rest), card, g, offset), _operand((n, *rest), card, g, offset)
    w = _wcat(n, re, False, 0.5)
    _kernel_check(lambda: _leading._stage_fused(re, im, n, False, 0.5), lambda: _leading._stage(re, im, w, n))
    c = torch.complex(re, im)
    _kernel_check(lambda: _leading._stage_fused(c.real, c.imag, n, False, 0.5), lambda: _leading._stage(re, im, w, n))


@pytest.mark.parametrize("k,b,m,offset", [(96, 5, 36, False), (40, 7, 37, False), (64, 3, 44, True), (17, 9, 4, False)])
def test_fft_blocked_stage_kernel_row_tiles_straddle_blocks(card, k, b, m, offset):
    """K3 on a cat operand whose 128-row tiles straddle its m-column blocks:
    16-byte copies where m is a multiple of 4, 4-byte ones otherwise."""
    g = torch.Generator(device=card).manual_seed(k * b + m)
    z = _operand((k, b, 2 * m), card, g, offset)
    w = _wcat(k, z, True)
    _kernel_check(lambda: _leading._stage_fused_blocked(z, k, m, True, 1.0),
                  lambda: _leading._stage(z[..., :m], z[..., m:], w, k))


@pytest.mark.parametrize("k,rest,m,offset", [(24, (3,), 44, False), (9, (2, 3), 13, True), (512, (1,), 129, False)])
def test_fft_pair_kernel_on_ragged_and_unaligned_operands(card, k, rest, m, offset):
    """K4 in cat layout and straight into complex64, on ragged and 4-byte
    aligned pair operands whose row tiles straddle blocks."""
    g = torch.Generator(device=card).manual_seed(k + m)
    z = _operand((k, *rest, 2, m), card, g, offset)
    b = int(np.prod(rest))
    w = _wcat(k, z, False, 0.5)
    z3 = z.reshape(k, b, 2 * m)

    def plain():
        return _leading._pair_plain(z3[..., :m].reshape(k, -1), z3[..., m:].reshape(k, -1), w, k)

    _kernel_check(lambda: _leading._stage_pair_fused(z, k, False, 0.5).reshape(b * m, 2 * k), plain)
    _kernel_check(lambda: tuple(p.reshape(b * m, k) for p in _leading._stage_pair_fused(z, k, False, 0.5, planes=True)),
                  lambda: (lambda o: (o[:, :k], o[:, k:]))(plain()))


def test_fft_stage_kernel_reads_and_writes_strided_planes(card):
    """K3/K4's C entry on element stride 2 that is not one complex64 tensor:
    planes of two different tensors, and an interleaved operand only 4-byte
    aligned (no 8-byte pair copies); outputs with element stride 2 in two
    tensors."""
    g = torch.Generator(device=card).manual_seed(5)
    K, M, n = 40, 300, 40
    x = _operand((K, M, 2), card, g, True)
    y = torch.randn(K, M, 2, device=card, generator=g)
    w = _wcat(n, x)
    for re, im in ((x[..., 0], x[..., 1]), (x[..., 0], y[..., 1]), (y[..., 0], y[..., 1])):
        def kernel(re=re, im=im):
            o_re = torch.empty(M, n, 2, device=card)
            o_im = torch.empty(M, n, 2, device=card)
            _leading._launch_stage(re.data_ptr(), im.data_ptr(), 2 * M, 2, M, 0, K, M, n, w, o_re.data_ptr(),
                                   o_im.data_ptr(), 2 * n, 2, card)
            return o_re[..., 0], o_im[..., 0]

        _kernel_check(kernel, lambda re=re, im=im: _leading._stage(re.contiguous(), im.contiguous(), w, n))


@pytest.mark.parametrize("n", [6, 127, 1000, 1024])
@pytest.mark.parametrize("real", [False, True])
def test_fft_axis_kernel_on_many_tiles_and_unaligned_rows(card, n, real):
    """K6 over several blocks' rows, on 4-byte aligned planes, and on the
    two views of one complex64 tensor (8-byte (re, im) reads)."""
    g = torch.Generator(device=card).manual_seed(n + real)
    rows = 300
    re = _operand((rows, n), card, g, True)
    im = None if real else _operand((rows, n), card, g, True)
    n1, n2 = _axis_pass._split_factors(n)
    consts = _axis_pass.on_device(_axis_pass._kernel_consts, n, True, device=card)
    _kernel_check(lambda: _axis_pass.fused_axis_pass(re, im, True),
                  lambda: _axis_pass._axis_pass_plain(re, im, n1, n2, consts))
    if not real:
        c = torch.complex(re, im)
        _kernel_check(lambda: _axis_pass.fused_axis_pass(c.real, c.imag, True),
                      lambda: _axis_pass._axis_pass_plain(re, im, n1, n2, consts))


def test_fft_kernels_refuse_what_they_cannot_take(card):
    d = torch.zeros(8, 4, device=card, dtype=torch.float64)
    with pytest.raises(TypeError):
        _leading._stage_fused(d, d, 8, False, 1.0)
    with pytest.raises(TypeError):
        _leading._ext_fused(d[None], d[None], d[:, :2], d[:, :2])
    with pytest.raises(ValueError):
        _axis_pass.fused_axis_pass(torch.zeros(2, 262, device=card), None, False)
    with pytest.raises(TypeError):
        _axis_pass.fused_axis_pass(torch.zeros(2, 96, device=card, dtype=torch.float64), None, False)


def _launches():
    return (_leading.FFT_STAGE_LAUNCHES, _leading.FFT_PAIR_LAUNCHES, _leading.FFT_EXT_LAUNCHES,
            _axis_pass.FFT_AXIS_LAUNCHES)


def _rel_np(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


def test_fft_on_the_card_matches_cpu(card):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((16, 12, 20)).astype(np.float32)
    before = _launches()
    y = ht.fft.fftn(ht.array(x, split=0))
    assert np.subtract(_launches(), before).tolist() == [1, 0, 1, 0]  # K3 and K5 once each
    assert y.larray_padded.device.type == "cuda" and y.larray_padded.dtype == torch.complex64
    want = np.fft.fftn(x.astype(np.float64))
    assert _rel_np(y.numpy(), want) < 5e-4
    np.testing.assert_allclose(y.numpy(), ht.fft.fftn(ht.array(x, split=0, device="cpu")).numpy(), atol=1e-3)
    before = _launches()
    z = ht.fft.fftn(y)
    back = ht.fft.ifftn(y)
    assert np.subtract(_launches(), before).tolist() == [0, 6, 0, 0]  # K4 three times a transform
    assert _rel_np(z.numpy(), np.fft.fftn(want)) < 5e-4
    assert _rel_np(back.numpy(), x) < 5e-4
    img = rng.standard_normal((40, 24)).astype(np.float32)
    before = _launches()
    f2 = ht.fft.fft2(ht.array(img))
    assert np.subtract(_launches(), before).tolist() == [0, 1, 0, 0]
    assert _rel_np(f2.numpy(), np.fft.fft2(img.astype(np.float64))) < 5e-4
    s = (rng.standard_normal((300, 1000)) + 1j * rng.standard_normal((300, 1000))).astype(np.complex64)
    before = _launches()
    f1 = ht.fft.fft(ht.array(s))
    assert np.subtract(_launches(), before).tolist() == [0, 0, 0, 1]
    assert _rel_np(f1.numpy(), np.fft.fft(s.astype(np.complex128))) < 5e-4


# ----------------------------------------------------------------------
# K7, flash attention, against its plain version, and ht.nn on the card
# ----------------------------------------------------------------------
from heat_tpu_torch.nn import _flash  # noqa: E402

FLASH_CASES = [  # (s, h, d, n_true)
    (1, 1, 1, 1), (127, 3, 16, 100), (1000, 1, 64, 999), (1000, 3, 128, 1000), (130, 2, 256, 64), (64, 2, 33, 64),
    (257, 2, 200, 0), (200, 5, 32, 199),
]


def _flash_check(q, k, v, scale, causal, n_true):
    before = _flash.FLASH_LAUNCHES
    got = _flash.flash_attention(q, k, v, scale, causal, n_true)
    again = _flash.flash_attention(q, k, v, scale, causal, n_true)
    assert _flash.FLASH_LAUNCHES == before + 2
    want = _flash._flash_plain(q, k, v, scale, causal, n_true)
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == torch.float32
    assert _rel(got, want) <= 1e-5
    assert torch.equal(got, again)  # bitwise reproducible


@pytest.mark.parametrize("s,h,d,n_true", FLASH_CASES)
@pytest.mark.parametrize("causal", [False, True])
def test_flash_kernel_matches_plain(card, s, h, d, n_true, causal):
    g = torch.Generator(device=card).manual_seed(s * h + d)
    q, k, v = (torch.randn(s, h, d, device=card, generator=g) for _ in range(3))
    _flash_check(q, k, v, 1.0 / np.sqrt(d), causal, n_true)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_kernel_with_a_peaked_softmax(card, causal):
    """(4096, 4, 64) with q scaled by 8 and n_true = s - 37: the stress case
    of the tensor-core chains (chip_smoke.py runs it too)."""
    g = torch.Generator(device=card).manual_seed(4096)
    q, k, v = (torch.randn(4096, 4, 64, device=card, generator=g) for _ in range(3))
    _flash_check(q * 8, k, v, 0.125, causal, 4096 - 37)


def test_flash_kernel_reads_strided_inputs(card):
    g = torch.Generator(device=card).manual_seed(3)
    base = torch.randn(3, 4, 300, 64, device=card, generator=g)  # (qkv, h, s, d): (s, h, d) views, strided
    q, k, v = (base[i].transpose(0, 1) for i in range(3))
    assert not q.is_contiguous()
    _flash_check(q, k, v, 0.125, True, 290)
    got = _flash.flash_attention(q, k, v, 0.125, True, 290)
    assert torch.equal(got, _flash.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), 0.125, True, 290))


def test_flash_kernel_refuses_what_it_cannot_take(card):
    x = torch.zeros(16, 2, 8, device=card)
    with pytest.raises(TypeError, match="float32"):
        _flash.flash_attention(x.double(), x.double(), x.double(), 1.0, False, 16)
    big = torch.zeros(4, 1, 257, device=card)
    with pytest.raises(ValueError, match="head dimension"):
        _flash.flash_attention(big, big, big, 1.0, False, 4)
    empty = torch.zeros(0, 2, 8, device=card)
    with pytest.raises(ValueError, match="s >= 1"):
        _flash.flash_attention(empty, empty, empty, 1.0, False, 0)


def test_attention_on_the_card_matches_cpu(card):
    rng = np.random.default_rng(7)
    qkv = [rng.standard_normal((300, 4, 32)).astype(np.float32) for _ in range(3)]
    for method in ("flash", "ring", "ulysses"):
        for split in (0, None):
            before = _flash.FLASH_LAUNCHES
            got = ht.nn.scaled_dot_product_attention(*(ht.array(x, split=split) for x in qkv), causal=True, method=method)
            assert _flash.FLASH_LAUNCHES - before == (1 if method == "flash" else 0)  # K7 once per flash call
            assert got.larray_padded.device.type == "cuda"
            want = ht.nn.scaled_dot_product_attention(*(ht.array(x, split=split, device="cpu") for x in qkv),
                                                      causal=True, method=method)
            np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=0)


def test_randn_on_the_card_matches_the_hosts(card):
    for n in (1, 1003, 65539):
        ht.random.seed(n)
        on_card = ht.random.randn(n).larray_padded
        ht.random.seed(n)
        on_host = ht.random.randn(n, device="cpu").larray_padded
        assert on_card.device.type == "cuda"
        diff = (on_card.cpu().view(torch.int32).long() - on_host.view(torch.int32).long()).abs().max()
        assert int(diff) <= 4  # ulp; the card's log and sqrt may round apart from the host's


@pytest.mark.parametrize("name", ["syrk", "flash_attn", "fft_stage", "fft_axis", "flash_attn_bwd"])
def test_tensor_core_kernels_use_the_tensor_cores(card, name):
    """The built SASS of each 3xTF32 kernel holds tensor-core instructions
    (HGMMA for wgmma, HMMA for mma.sync)."""
    import os
    import shutil
    import subprocess

    from heat_tpu_torch.core import _build

    cuobjdump = shutil.which("cuobjdump") or os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin",
                                                          "cuobjdump")
    if not os.path.exists(cuobjdump):
        pytest.skip("needs cuobjdump from the CUDA toolkit")
    lib = _build.build_all([name])[name]
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True, check=True).stdout
    words = [w for ln in sass.splitlines() if "MMA" in ln for w in ln.split(";")[0].split()]
    assert sum(w.startswith(("HGMMA.", "HMMA.")) for w in words) > 0


# ----------------------------------------------------------------------
# K7-bwd: the gradient of flash attention on the card (F4: the forward's
# output had no grad_fn there), the backward kernels against the plain
# backward, and the training path
# ----------------------------------------------------------------------
def _flash_grads(q, k, v, do, scale, causal, n_true):
    qs, ks, vs = (t.detach().clone().requires_grad_() for t in (q, k, v))
    out = _flash.flash_attention(qs, ks, vs, scale, causal, n_true)
    assert out.grad_fn is not None
    out.backward(do)
    return out.detach(), (qs.grad, ks.grad, vs.grad)


def _plain_grads(q, k, v, do, scale, causal, n_true):
    out, lse = _flash._flash_plain(q, k, v, scale, causal, n_true, with_lse=True)
    di = _flash._bwd_di_plain(out, do)
    dk, dv = _flash._bwd_dkv_plain(q, k, v, do, lse, di, scale, causal, n_true)
    return _flash._bwd_dq_plain(q, k, v, do, lse, di, scale, causal, n_true), dk, dv


def _rel3(got, want):
    err = max(float((a.double() - b.double()).abs().max()) for a, b in zip(got, want))
    return err / max(float(b.double().abs().max()) for b in want)


@pytest.mark.parametrize("s,h,d,n_true", FLASH_CASES)
@pytest.mark.parametrize("causal", [False, True])
def test_flash_gradient_on_the_card_matches_the_plain_backward(card, s, h, d, n_true, causal):
    g = torch.Generator(device=card).manual_seed(s * h + d + 1)
    q, k, v, do = (torch.randn(s, h, d, device=card, generator=g) for _ in range(4))
    scale = 1.0 / np.sqrt(d)
    before = (_flash.FLASH_LAUNCHES, dict(_flash.FLASH_BWD_LAUNCHES))
    _, got = _flash_grads(q, k, v, do, scale, causal, n_true)
    _, again = _flash_grads(q, k, v, do, scale, causal, n_true)
    assert _flash.FLASH_LAUNCHES == before[0] + 2
    route = _flash.bwd_route(s, h, d)  # tc at d <= 64: the pre-pass too
    launched = {"di", f"dkv_{route}", f"dq_{route}"} | ({"prep"} if route == "tc" else set())
    assert all(_flash.FLASH_BWD_LAUNCHES[key] == before[1][key] + 2 * (key in launched) for key in before[1])
    want = _plain_grads(q, k, v, do, scale, causal, n_true)
    torch.cuda.synchronize()
    assert all(a.shape == (s, h, d) and a.dtype == torch.float32 for a in got)
    assert _rel3(got, want) <= 1e-5
    assert all(torch.equal(a, b) for a, b in zip(got, again))  # bitwise reproducible


def test_flash_gradient_with_strided_inputs_and_a_stride_0_gradient(card):
    g = torch.Generator(device=card).manual_seed(5)
    base = torch.randn(3, 4, 300, 64, device=card, generator=g)
    q, k, v = (base[i].transpose(0, 1).requires_grad_() for i in range(3))
    out = _flash.flash_attention(q, k, v, 0.125, True, 290)
    out.sum().backward()  # an expanded, stride-0 gradient
    want = _plain_grads(*(t.detach() for t in (q, k, v)), torch.ones_like(out), 0.125, True, 290)
    assert _rel3((q.grad, k.grad, v.grad), want) <= 1e-5


def _route_grads(q, k, v, do, scale, causal, n_true, route):
    out, lse = _flash._flash_cuda(q, k, v, scale, causal, n_true, with_lse=True)
    di = _flash._bwd_di_cuda(out, do)
    return _flash._bwd_cuda(q, k, v, do, lse, di, scale, causal, n_true, route), (lse, di)


@pytest.mark.parametrize("s,h,d,n_true", [(1, 1, 1, 1), (127, 3, 16, 100), (1000, 1, 64, 999), (64, 2, 33, 64),
                                          (200, 5, 32, 199), (129, 2, 64, 0)])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("route", ["tc", "cuda_core"])
def test_flash_backward_routes_match_the_plain_backward(card, s, h, d, n_true, causal, route):
    """Each route of dK/dV and dQ at shapes both take (d <= 64), against the
    plain backward on the same lse and di, and a bitwise repeat."""
    g = torch.Generator(device=card).manual_seed(s * h + d + 3)
    q, k, v, do = (torch.randn(s, h, d, device=card, generator=g) for _ in range(4))
    scale = 1.0 / np.sqrt(d)
    before = dict(_flash.FLASH_BWD_LAUNCHES)
    got, (lse, di) = _route_grads(q, k, v, do, scale, causal, n_true, route)
    again, _ = _route_grads(q, k, v, do, scale, causal, n_true, route)
    assert _flash.FLASH_BWD_LAUNCHES[f"dkv_{route}"] == before[f"dkv_{route}"] + 2
    assert _flash.FLASH_BWD_LAUNCHES[f"dq_{route}"] == before[f"dq_{route}"] + 2
    dk, dv = _flash._bwd_dkv_plain(q, k, v, do, lse, di, scale, causal, n_true)
    want = (_flash._bwd_dq_plain(q, k, v, do, lse, di, scale, causal, n_true), dk, dv)
    torch.cuda.synchronize()
    assert _rel3(got, want) <= 1e-5
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("route", ["tc", "cuda_core"])
def test_flash_backward_routes_read_strided_inputs_and_a_stride_0_gradient(card, route):
    g = torch.Generator(device=card).manual_seed(7)
    base = torch.randn(3, 4, 300, 64, device=card, generator=g)
    q, k, v = (base[i].transpose(0, 1) for i in range(3))
    do = torch.randn((), device=card, generator=g).expand(300, 4, 64)
    got, (lse, di) = _route_grads(q, k, v, do, 0.125, True, 290, route)
    dk, dv = _flash._bwd_dkv_plain(q, k, v, do, lse, di, 0.125, True, 290)
    assert _rel3(got, (_flash._bwd_dq_plain(q, k, v, do, lse, di, 0.125, True, 290), dk, dv)) <= 1e-5


def test_flash_backward_prep_is_bitwise_its_plain_version(card):
    g = torch.Generator(device=card).manual_seed(8)
    base = torch.randn(3, 3, 300, 33, device=card, generator=g)
    q, k, v = (base[i].transpose(0, 1) for i in range(3))
    do = torch.randn((), device=card, generator=g).expand(300, 3, 33)
    lse, di = torch.randn(2, 3, 300, device=card, generator=g)
    before = _flash.FLASH_BWD_LAUNCHES["prep"]
    got = _flash._bwd_prep_cuda(q, k, v, do, lse, di)
    assert _flash.FLASH_BWD_LAUNCHES["prep"] == before + 1
    assert torch.equal(got.view(torch.int32), _flash._bwd_prep_plain(q, k, v, do, lse, di).view(torch.int32))
    with pytest.raises(ValueError, match="d <= 64"):
        _flash._bwd_prep_cuda(*[torch.zeros(4, 1, 65, device=card)] * 4, *torch.zeros(2, 1, 4, device=card))


def test_flash_gradient_within_float64(card):
    """(4096, 4, 64), causal, q scaled by 8 (a peaked softmax): within 1e-4
    of the plain backward in float64 (chip_smoke.py runs it too)."""
    g = torch.Generator(device=card).manual_seed(4097)
    q, k, v, do = (torch.randn(4096, 4, 64, device=card, generator=g) for _ in range(4))
    for qm in (1.0, 8.0):
        _, got = _flash_grads(q * qm, k, v, do, 0.125, True, 4096 - 37)
        want = _plain_grads(*(t.double() for t in (q * qm, k, v, do)), 0.125, True, 4096 - 37)
        assert _rel3(got, want) <= 1e-4


def test_sequence_parallel_gradients_on_the_card_match_the_cpu(card):
    rng = np.random.default_rng(9)
    q, k, v, g = (rng.standard_normal((300, 4, 32)).astype(np.float32) for _ in range(4))
    for fn, kw in ((ht.nn.ring_attention, {}), (ht.nn.ulysses_attention, {}),
                   (ht.nn.ulysses_attention, {"use_flash": True})):
        grads = []
        for dev in (card, torch.device("cpu")):
            ts = [torch.from_numpy(x).to(dev).requires_grad_() for x in (q, k, v)]
            (fn(*ts, causal=True, n_true=280, **kw) * torch.from_numpy(g).to(dev)).sum().backward()
            grads.append([t.grad.cpu() for t in ts])
        assert _rel3(*grads) <= 1e-5


def test_data_parallel_on_the_card_matches_the_cpu(card):
    import copy
    import torch.nn.functional as F

    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Conv2d(1, 4, 3, padding=1), torch.nn.ReLU(), torch.nn.Flatten(),
                                torch.nn.Linear(4 * 8 * 8, 10))
    rng = np.random.default_rng(1)
    x = rng.standard_normal((32, 1, 8, 8)).astype(np.float32)
    y = rng.integers(0, 10, 32)
    losses = []
    for dev in (card, torch.device("cpu")):
        m = copy.deepcopy(model).to(dev)
        dp = ht.nn.DataParallel(m, optimizer=ht.optim.Adam(m.parameters(), lr=1e-3))
        losses.append([dp.step(lambda p, t: F.cross_entropy(p, t), torch.from_numpy(x).to(dev),
                               torch.from_numpy(y).to(dev)) for _ in range(2)])
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-5)
    assert torch.backends.cudnn.allow_tf32 is False


# ----------------------------------------------------------------------
# rsvd, the randomized PCA and the DNDarray's operators on the card
# ----------------------------------------------------------------------
from heat_tpu_torch.core import random as rnd  # noqa: E402


@pytest.mark.parametrize("dtype,power_iter", [(np.float32, 0), (np.float32, 1), (np.float64, 1)])
def test_rsvd_on_the_card_matches_cpu(card, dtype, power_iter):
    """The test matrix hashed on the card (one threefry launch), then the
    factors within tests/test_torch_rsvd.py's tolerances of the CPU's."""
    a = _spectrum_matrix(20011, 64, 4).astype(dtype)
    f32 = dtype == np.float32
    ht.random.seed(3)
    before = rnd.THREEFRY_LAUNCHES
    U, S, V = ht.linalg.rsvd(ht.array(a, split=0), 6, power_iter=power_iter)
    assert rnd.THREEFRY_LAUNCHES == before + 1
    assert U.larray_padded.device.type == "cuda" and U.split == 0 and S.split is None and V.split is None
    ht.random.seed(3)
    want = ht.linalg.rsvd(ht.array(a, split=0, device="cpu"), 6, power_iter=power_iter)
    np.testing.assert_allclose(S.numpy(), want[1].numpy(), rtol=1e-4 if f32 else 1e-10)
    for g, w in ((U.numpy(), want[0].numpy()), (V.numpy(), want[2].numpy())):
        signs = np.sign(np.sum(g * w, axis=0))
        np.testing.assert_allclose(g * signs, w, atol=1e-3 if f32 else 1e-10)
    # two Gram passes in float32 leave U orthonormal to about 1e-5-1e-4 on
    # this spectrum, on the card and on the CPU (the JAX package's too); 1e-4
    # is the bound of the hsvd card check
    u = U.numpy().astype(np.float64)
    assert np.abs(u.T @ u - np.eye(6)).max() < (1e-4 if f32 else 1e-5)


def test_randomized_pca_on_the_card_matches_cpu(card):
    a = _spectrum_matrix(5003, 40, 5)
    before = rnd.THREEFRY_LAUNCHES
    kw = dict(n_components=5, svd_solver="randomized", random_state=2)
    got = ht.decomposition.PCA(**kw).fit(ht.array(a, split=0))
    assert rnd.THREEFRY_LAUNCHES == before + 1
    want = ht.decomposition.PCA(**kw).fit(ht.array(a, split=0, device="cpu"))
    # the components are rsvd's V and the explained variance S^2 / (n - 1):
    # held to V's atol 1e-3 and S's rtol 1e-4 (squared: 2e-4) of
    # tests/test_torch_rsvd.py, and each projection to 1e-3 of its centred
    # row's norm
    gc, wc = got.components_.numpy(), want.components_.numpy()
    signs = np.sign(np.sum(gc * wc, axis=1))
    np.testing.assert_allclose(gc * signs[:, None], wc, atol=1e-3)
    np.testing.assert_allclose(got.explained_variance_ratio_.numpy(), want.explained_variance_ratio_.numpy(), rtol=2e-4)
    fresh = a[:300]
    t_got = got.transform(ht.array(fresh, split=0)).numpy() * signs[None, :]
    t_want = want.transform(ht.array(fresh, split=0, device="cpu")).numpy()
    row_norms = np.linalg.norm(fresh - want.mean_.numpy(), axis=1)
    assert np.all(np.abs(t_got - t_want) <= 1e-3 * row_norms[:, None])


_CARD_OPERATORS = {
    "gt": lambda t: t > 0,
    "eq": lambda t: t == t,
    "ne_scalar": lambda t: t != 0.5,
    "rtruediv": lambda t: 2 / t,
    "rpow": lambda t: 2**t,
    "bool_plus_int": lambda t: (t > 0) + 1,
    "int_minus_bool": lambda t: 2 - (t > 0),
    "bool_minus_float": lambda t: (t > 0) - 1.5,
    "bool_div": lambda t: ht.div(t > 0, 3),
    "argmin_bool_0": lambda t: ht.argmin(t > 0, axis=0),
    "argmin_bool_1": lambda t: ht.argmin(t > 0, axis=1),
    "argmin_bool": lambda t: ht.argmin(t > 0),
}


@pytest.mark.parametrize("split", [None, 0])
@pytest.mark.parametrize("name", list(_CARD_OPERATORS))
def test_operators_on_the_card_match_cpu(card, split, name):
    """Results stay on the card in the CPU's dtype and split: bitwise for
    bool, integer and divided results, within an ulp for the power."""
    x = np.random.default_rng(6).standard_normal((1003, 5)).astype(np.float32)
    got = _CARD_OPERATORS[name](ht.array(x, split=split))
    want = _CARD_OPERATORS[name](ht.array(x, split=split, device="cpu"))
    assert got.larray_padded.device.type == "cuda"
    assert got.dtype is want.dtype and got.split == want.split
    if name == "rpow":
        np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=2.4e-7)
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_scalar_conversions_and_equal_on_the_card(card):
    x = np.random.default_rng(7).standard_normal((1003, 5)).astype(np.float32)
    a = ht.array(x, split=0)
    assert ht.equal(a, ht.array(x.copy(), split=0)) and not ht.equal(a, a + 1.0)
    assert bool(ht.array([0.0])) is False and float(ht.array([2.5])) == 2.5 and int(ht.array([[7]])) == 7
    assert np.asarray(a).dtype == np.float32 and ht.array(a, dtype=ht.float64).larray_padded.device.type == "cuda"


@pytest.mark.parametrize("split", [None, 0])
def test_array_of_a_card_array_moves_to_the_asked_device(card, split):
    x = np.random.default_rng(8).standard_normal((1003, 5)).astype(np.float32)
    a = ht.array(x, split=split)
    host = ht.array(a, device="cpu")
    assert host.larray_padded.device.type == "cpu" and host.device == "cpu" and host.split == split
    np.testing.assert_array_equal(host.numpy(), x)
    back = ht.array(host, device="gpu", dtype=ht.float64)
    assert back.larray_padded.device.type == "cuda" and back.dtype is ht.float64 and back.split == split
    np.testing.assert_array_equal(back.numpy(), x.astype(np.float64))
    assert ht.array(a, device="gpu") is a


# the rest of the seeded draws and the kmeans++ init on the card

from heat_tpu_torch.cluster import _kcluster  # noqa: E402


def _as_device(d):
    return torch.device("cuda", torch.cuda.current_device()) if d == "gpu" else torch.device("cpu")


_POOL = np.random.default_rng(9).standard_normal((5000, 3)).astype(np.float32)
_P = np.random.default_rng(10).random(5000)
_P[::7] = 0.0
_P /= _P.sum()
_CARD_DRAWS = {  # name: (draw on a device, threefry launches on the card)
    "randint int64": (lambda d: ht.random.randint(-(2**62) - 3, 2**62 + 2, size=(5000,), device=d), 2),
    "randint int64 full range": (lambda d: ht.random.randint(-(2**63), 2**63 - 1, size=(5000,), device=d), 2),
    "randint int32 clipped": (lambda d: ht.random.randint(-(2**31), 2**40, size=(5000,), dtype=ht.int32, device=d), 2),
    "random_integers": (lambda d: ht.random.random_integers(-3, 3, size=(5000,), device=d), 2),
    "uniform float32": (lambda d: ht.random.uniform(-3.7, 11.2, (5000,), device=d), 1),
    "uniform float64": (lambda d: ht.random.uniform(-3.7, 11.2, (5000,), dtype=ht.float64, device=d), 1),
    "random_sample": (lambda d: ht.random.random_sample((50, 100), device=d), 1),
    "permutation 1626": (lambda d: ht.random.permutation(1626, device=d), 2),
    "randperm int32": (lambda d: ht.random.randperm(5000, dtype=ht.int32, device=d), 2),
    "permutation of rows": (lambda d: ht.random.permutation(ht.array(_POOL, split=0, device=d)), 2),
    "choice, replace": (lambda d: ht.random.choice(5000, size=(64, 3), device=d), 2),
    "choice, no replace": (lambda d: ht.random.choice(ht.array(_POOL, device=d), size=100, replace=False,
                                                      device=d), 2),
    "choice, p, replace": (lambda d: ht.random.choice(5000, size=300, p=_P, device=d), 1),
    "choice, p float32, no replace": (lambda d: ht.random.choice(5000, size=300, p=_P.astype(np.float32),
                                                                 replace=False, device=d), 1),
}


@pytest.mark.parametrize("name", sorted(_CARD_DRAWS))
def test_draw_on_the_card_is_bitwise_the_hosts(card, name):
    draw, launches = _CARD_DRAWS[name]
    ht.random.seed(12)
    before = rnd.THREEFRY_LAUNCHES
    got = draw("gpu")
    assert rnd.THREEFRY_LAUNCHES - before == launches
    state = ht.random.get_state()
    ht.random.seed(12)
    want = draw("cpu")
    assert rnd.THREEFRY_LAUNCHES - before == launches and ht.random.get_state() == state
    assert got.larray_padded.device.type == "cuda" and got.dtype is want.dtype and got.split == want.split
    g, w = got.larray.cpu(), want.larray
    if g.is_floating_point():
        g, w = g.view(torch.uint8), w.view(torch.uint8)
    assert torch.equal(g, w)


def test_shuffle_and_bytes_on_the_card(card):
    ht.random.seed(13)
    x = ht.array(_POOL, split=0)
    before = rnd.THREEFRY_LAUNCHES
    ht.random.shuffle(x)
    card_bytes = ht.random.bytes(1003)
    assert rnd.THREEFRY_LAUNCHES - before == 4  # two sort rounds, randint's two keys
    assert x.larray_padded.device.type == "cuda"
    ht.random.seed(13)
    y = ht.array(_POOL, split=0, device="cpu")
    ht.random.shuffle(y)
    ht.use_device("cpu")
    assert ht.random.bytes(1003) == card_bytes
    assert torch.equal(x.larray.cpu(), y.larray)


def _card_blobs(n, seed):
    rng = np.random.default_rng(seed)
    centres = rng.standard_normal((8, 16)) * 6.0
    return (centres[rng.integers(0, 8, n)] + rng.standard_normal((n, 16))).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kmeanspp_on_the_card_picks_the_cpus_rows(card, seed):
    """The init's draws on the card (nine threefry launches at k = 8) pick
    the CPU path's rows at 20000 points, where each row's share of D^2
    (about 5e-5) is far above the float32 cumulative sums' resolution; the
    fit then launches K1 n_iter + 1 times."""
    x = _card_blobs(20000, seed)
    before = rnd.THREEFRY_LAUNCHES
    got = ht.cluster.KMeans(n_clusters=8, init="kmeans++", random_state=seed)
    got._initialize_cluster_centers(ht.array(x, split=0))
    assert rnd.THREEFRY_LAUNCHES - before == 9
    want = ht.cluster.KMeans(n_clusters=8, init="kmeans++", random_state=seed)
    want._initialize_cluster_centers(ht.array(x, split=0, device="cpu"))
    assert got._cluster_centers.larray_padded.device.type == "cuda"
    np.testing.assert_array_equal(got._cluster_centers.numpy(), want._cluster_centers.numpy())
    lloyd = kernels.LLOYD_LAUNCHES
    km = ht.cluster.KMeans(n_clusters=8, init="kmeans++", random_state=seed, max_iter=30).fit(ht.array(x, split=0))
    assert kernels.LLOYD_LAUNCHES - lloyd == km.n_iter_ + 1
    pts = torch.from_numpy(x).to(card)
    _, _, _, labels = kernels._lloyd_plain(pts, km.cluster_centers_.larray, x.shape[0], True)
    assert _near_tie_mismatches(pts, km.cluster_centers_.larray, km.labels_.larray, labels) == 0


def test_kmeanspp_round_on_the_card(card):
    """One round on the card: the running minimum takes the newest centre,
    the pick is a row index on the card, u = 0 takes row 0 and a u past
    every cumulative sum the last row."""
    x = ht.array(_card_blobs(3000, 5), split=0)
    local = x.larray
    x2 = (local * local).sum(1)
    d2 = torch.full_like(x2, float("inf"))
    d2, pick = _kcluster._kmeanspp_round(x, x2, d2, torch.tensor([17], device=card), 0.0)
    assert pick.device.type == "cuda" and pick.tolist() == [0]
    torch.testing.assert_close(d2, ((local - local[17]) ** 2).sum(1), rtol=1e-4, atol=5e-3)
    assert _kcluster._kmeanspp_round(x, x2, d2, pick, 2.0)[1].tolist() == [2999]


def test_prefix_sums_on_the_card(card):
    comm = ht.get_comm()
    v = torch.tensor([1.5, -2.0], device=card)
    assert torch.equal(comm.pscan(v), v) and torch.equal(comm.exscan(v), torch.zeros_like(v))


def test_ordered_cumsum_repeats_bitwise_on_the_card(card):
    """torch.cumsum of a CUDA vector may round differently run to run; the
    blocked scan that kmeans++, choice(p=...) and the weighted counts use
    (``arithmetics._CUMSUM`` on the card) adds in one order."""
    from heat_tpu_torch.core import arithmetics

    g = torch.Generator(device=card).manual_seed(3)
    w = torch.rand(1 << 22, device=card, generator=g) / (1 << 22)
    first = arithmetics._CUMSUM(w, 0)
    for _ in range(5):
        assert torch.equal(arithmetics._CUMSUM(w, 0), first)
    exact = torch.cumsum(w.double(), 0)
    assert float(((first.double() - exact).abs() / exact).max()) < 1e-5


# K1's float64 walk route and the array runtime on the card


@pytest.mark.parametrize("rows,f,k,n_true", [(1003, 16, 8, 1003), (1003, 17, 30, 1000), (4096, 64, 8, 4000),
                                             (777, 4, 3, 777), (33, 8, 64, 31)])
def test_float64_kernel_matches_plain(card, rows, f, k, n_true):
    """Labels bitwise, counts exact, sums and inertia within 1e-12 of the
    plain version; one launch, by the walk route."""
    g = torch.Generator(device=card).manual_seed(rows + f + k)
    x = torch.randn(rows, f, device=card, generator=g, dtype=torch.float64)
    c = torch.randn(k, f, device=card, generator=g, dtype=torch.float64)
    assert kernels.lloyd_route(f, k, True, torch.float64) == "walk"
    before = kernels.LLOYD_LAUNCHES
    sums, counts, inertia, lab = kernels.lloyd_partials(x, c, n_true, labels=True)
    assert kernels.LLOYD_LAUNCHES == before + 1
    ps, pc, pi, pl = kernels._lloyd_plain(x, c, n_true, True)
    assert torch.equal(lab, pl) and torch.equal(counts, pc)
    assert float((sums - ps).abs().max()) <= 1e-12 * float(ps.abs().max())
    assert abs(float(inertia) - float(pi)) <= 1e-12 * abs(float(pi))


def test_float64_kernel_refuses_mixes(card):
    x = torch.zeros(64, 16, device=card, dtype=torch.float64)
    with pytest.raises(TypeError):
        kernels.lloyd_partials(x, torch.zeros(8, 16, device=card), 64)
    with pytest.raises(TypeError):
        kernels.lloyd_partials(x.float(), torch.zeros(8, 16, device=card, dtype=torch.float64), 64)
    with pytest.raises(ValueError):
        kernels._lloyd_cuda(x, x[:8], 64, False, "tc")


def test_float64_kmeans_on_the_card_matches_cpu(card):
    rng = np.random.default_rng(4)
    centres = rng.standard_normal((8, 16)) * 6.0
    x = centres[rng.integers(0, 8, 5000)] + rng.standard_normal((5000, 16))
    before = kernels.LLOYD_LAUNCHES
    got = ht.cluster.KMeans(n_clusters=8, init="random", random_state=0, max_iter=30).fit(ht.array(x, split=0))
    assert kernels.LLOYD_LAUNCHES - before == got.n_iter_ + 1
    want = ht.cluster.KMeans(n_clusters=8, init="random", random_state=0, max_iter=30).fit(
        ht.array(x, split=0, device="cpu"))
    assert got.cluster_centers_.dtype is ht.float64 and got.n_iter_ == want.n_iter_
    np.testing.assert_array_equal(got.labels_.numpy(), want.labels_.numpy())
    np.testing.assert_allclose(got.cluster_centers_.numpy(), want.cluster_centers_.numpy(), rtol=0, atol=1e-12)


def test_runtime_on_the_card_matches_cpu(card):
    """Indexing, writes, resplits, casts and printing on the card give the
    CPU's results, bitwise."""
    rng = np.random.default_rng(8)
    base = rng.standard_normal((37, 11)).astype(np.float32)
    idx = np.array([36, 0, 5, 5, 17])
    for split in (None, 0, 1):
        a, h = ht.array(base, split=split), ht.array(base, split=split, device="cpu")
        assert a.larray_padded.is_cuda
        for key in (5, (slice(None), 3), slice(None, None, -3), base[:, 0] > 0, idx, (idx, slice(2, 9)), (None, 4)):
            got, want = a[key], h[key]
            assert got.split == want.split and got.shape == want.shape
            assert torch.equal(got.larray.cpu(), want.larray)
        a[3:30:4] = 1.5
        h[3:30:4] = 1.5
        a[idx[:3]] = ht.array(np.ones((3, 11), np.float32))
        h[idx[:3]] = ht.array(np.ones((3, 11), np.float32), device="cpu")
        assert torch.equal(a.larray.cpu(), h.larray)
        for t in (None, 0, 1):
            assert torch.equal(a.resplit(t).larray.cpu(), h.resplit(t).larray)
        for name in ("int8", "uint16", "uint64", "float16", "bfloat16", "float64", "complex64", "bool"):
            dt = getattr(ht, name)
            assert torch.equal(a.astype(dt).astype(ht.float32).larray.cpu()[a.larray.cpu() >= 0],
                               h.astype(dt).astype(ht.float32).larray[h.larray >= 0]), name
        assert str(a).replace("gpu:0", "cpu:0") == str(h)
        assert ht.allclose(a, h.numpy()) and bool(ht.all(a == a))


# ----------------------------------------------------------------------
# the NumPy ops on the card (exponential, rounding, trigonometrics,
# complex_math, arithmetics, statistics, linalg basics)
# ----------------------------------------------------------------------
_EXACT_OPS = [
    ("abs", ht.abs), ("floor", ht.floor), ("ceil", ht.ceil), ("trunc", ht.trunc), ("rint", ht.rint),
    ("round(x, 2)", lambda t: ht.round(t, 2)), ("round(x, -1)", lambda t: ht.round(t, -1)),
    ("clip", lambda t: ht.clip(t, -1, 1)), ("mod", lambda t: t % 0.5), ("floordiv", lambda t: t // 0.5),
    ("fmod", lambda t: ht.fmod(t, 0.7)), ("neg", lambda t: -t), ("diff0", lambda t: ht.diff(t, axis=0)),
    ("diff1", lambda t: ht.diff(t, n=2, axis=1)), ("tril", lambda t: ht.tril(t, 1)), ("triu", lambda t: ht.triu(t, -2)),
    ("maximum", lambda t: ht.maximum(t, 0.25)), ("sign", ht.sign), ("square", ht.square),
    ("transpose", lambda t: t.T), ("heaviside", lambda t: ht.heaviside(t, 0.5)), ("copysign", lambda t: ht.copysign(1.0, t)),
]


@pytest.mark.parametrize("name,op", _EXACT_OPS)
def test_exact_ops_on_the_card_are_the_cpus(card, name, op):
    rng = np.random.default_rng(len(name))
    base = (rng.standard_normal((1003, 7)) * 3).astype(np.float32)
    base[5, 2] = 2.675
    for split in (None, 0, 1):
        got, want = op(ht.array(base, split=split)), op(ht.array(base, split=split, device="cpu"))
        assert got.larray_padded.is_cuda and got.split == want.split and got.dtype is want.dtype
        assert torch.equal(got.larray.cpu(), want.larray), name


def test_integer_division_by_zero_on_the_card_is_the_references(card):
    for dt in (np.int8, np.int32, np.int64):
        a = ht.array(np.array([5, -5, 0, 7, -7], dt), split=0)
        assert (a // 0).numpy().tolist() == [-2, -2, -1, -2, -2]
        assert (a % 0).numpy().tolist() == [0] * 5
        assert ht.fmod(a, 0).numpy().tolist() == [0] * 5
        lo, m1 = ht.array(np.array([np.iinfo(dt).min], dt)), ht.array(np.array([-1], dt))
        assert (lo // m1).numpy().tolist() == [np.iinfo(dt).min] and (lo % m1).numpy().tolist() == [0]
        q, m = divmod(a, ht.array(np.array([0, 2, 0, -2, 3], dt), split=0))
        assert q.numpy().tolist() == [-2, -3, -1, -4, -3] and m.numpy().tolist() == [0, 1, 0, -1, 2]
    u = ht.array(np.array([5, 0, 7], np.uint8))
    assert (u // ht.array(np.zeros(3, np.uint8))).numpy().tolist() == [255, 255, 255]


def test_round_and_nan_arguments_on_the_card_are_the_references(card):
    assert ht.round(ht.array(np.float32([2.675])), 2).numpy()[0] == np.float32(2.6799998)
    v = ht.array(np.array([1.0, np.nan, 3.0, np.nan], np.float32), split=0)
    assert int(ht.argmax(v)) == 1 and int(ht.argmin(v)) == 1
    m = ht.array(np.array([[1.0, 5.0], [np.nan, 2.0], [3.0, np.nan]], np.float32), split=0)
    assert ht.argmax(m, 0).numpy().tolist() == [1, 2] and ht.argmin(m, 1).numpy().tolist() == [0, 0, 1]


def test_transcendentals_on_the_card_are_within_the_references_bound(card):
    rng = np.random.default_rng(3)
    base = (rng.standard_normal((4099, 5)) * 3).astype(np.float32)
    x64 = torch.from_numpy(base.astype(np.float64))
    for op, op64 in ((ht.exp, torch.exp), (ht.sin, torch.sin), (ht.tanh, torch.tanh), (ht.arctan, torch.atan),
                     (lambda t: ht.log(ht.abs(t) + 1), lambda t: torch.log(t.abs() + 1)),
                     (lambda t: ht.sqrt(ht.abs(t)), lambda t: torch.sqrt(t.abs())),
                     (lambda t: ht.arctan2(t, 2.0), lambda t: torch.atan2(t, torch.tensor(2.0, dtype=t.dtype)))):
        got = op(ht.array(base, split=0)).larray.cpu().double()
        np.testing.assert_allclose(got.numpy(), op64(x64).numpy(), rtol=3e-5, atol=1e-6)


def test_scans_and_reductions_on_the_card_repeat_bitwise(card):
    rng = np.random.default_rng(4)
    big = torch.from_numpy(rng.standard_normal((1 << 20, 4)).astype(np.float32)).to(card)
    vec = torch.from_numpy(rng.standard_normal(3 << 20).astype(np.float32)).to(card)
    a, v = ht.array(big, split=0), ht.array(vec, split=0)
    labels = ht.array(torch.from_numpy(rng.integers(0, 9, 1 << 20)).to(card), split=0)
    weights = ht.array(torch.from_numpy(rng.standard_normal(1 << 20).astype(np.float32)).to(card), split=0)
    calls = [lambda: ht.cumsum(a, 0), lambda: ht.cumsum(a, 1), lambda: ht.cumsum(v, 0), lambda: ht.cumprod(a, 1),
             lambda: ht.sum(a, 0), lambda: ht.sum(a), lambda: ht.prod(a, 1), lambda: ht.var(a, 0), lambda: ht.std(a),
             lambda: ht.cov(a, rowvar=False), lambda: ht.vector_norm(a), lambda: ht.matrix_norm(a),
             lambda: ht.dot(v, v), lambda: ht.bincount(labels, weights=weights),
             lambda: ht.histogram(a, bins=17, weights=ht.abs(a))[0], lambda: ht.nansum(a, 0), lambda: ht.mean(a, 0)]
    for i, call in enumerate(calls):
        first = call().larray
        for _ in range(3):
            assert torch.equal(call().larray, first), i
    # and within the float64 bound of the blocked scan
    want = torch.cumsum(vec.double(), 0)
    got = ht.cumsum(v, 0).larray.double()
    assert float(((got - want).abs() / torch.cumsum(vec.double().abs(), 0)).max()) < 1e-5


def test_statistics_on_the_card_match_cpu(card):
    rng = np.random.default_rng(5)
    base = (rng.standard_normal((2001, 6)) * 2).astype(np.float32)
    base[7, 3] = np.nan
    labels = rng.integers(0, 12, 2001)
    for split in (None, 0, 1):
        a, h = ht.array(base, split=split), ht.array(base, split=split, device="cpu")
        for name, op in (("argmax", lambda t: ht.argmax(t, 0)), ("argmin", lambda t: ht.argmin(t)),
                         ("argmax1", lambda t: ht.argmax(t, 1)), ("nanargmax", lambda t: ht.argmax(ht.nan_to_num(t)))):
            assert torch.equal(op(a).larray.cpu(), op(h).larray), name
        clean = ht.nan_to_num(a), ht.nan_to_num(h)
        for op in (lambda t: ht.histogram(t, bins=9)[0], lambda t: ht.var(t, 1), lambda t: ht.cov(t),
                   lambda t: ht.histc(t, bins=5)):
            np.testing.assert_allclose(op(clean[0]).larray.cpu().numpy(), op(clean[1]).larray.numpy(), rtol=1e-5,
                                       atol=1e-5)
    lab, labh = ht.array(labels, split=0), ht.array(labels, split=0, device="cpu")
    assert torch.equal(ht.bincount(lab).larray.cpu(), ht.bincount(labh).larray)
    assert torch.equal(ht.bincount(lab).larray.cpu(), torch.bincount(torch.from_numpy(labels)))


def test_linalg_on_the_card_matches_cpu(card):
    rng = np.random.default_rng(6)
    a = rng.standard_normal((97, 33)).astype(np.float32)
    b = rng.standard_normal((33, 21)).astype(np.float32)
    for sa in (None, 0, 1):
        for sb in (None, 0, 1):
            got = ht.matmul(ht.array(a, split=sa), ht.array(b, split=sb))
            want = ht.matmul(ht.array(a, split=sa, device="cpu"), ht.array(b, split=sb, device="cpu"))
            assert got.split == want.split
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
    ia = rng.integers(-5, 5, (9, 7)).astype(np.int32)
    ib = rng.integers(-5, 5, (7, 4)).astype(np.int32)
    assert np.array_equal(ht.matmul(ht.array(ia), ht.array(ib)).numpy(), ia @ ib)
    assert ht.trace(ht.array(a, split=0)) == pytest.approx(float(np.trace(a)), rel=1e-5)
    np.testing.assert_array_equal(ht.outer(ht.array(a[:, 0], split=0), ht.array(b[0])).numpy(), np.outer(a[:, 0], b[0]))
    assert float(ht.norm(ht.array(a, split=1))) == pytest.approx(float(np.linalg.norm(a)), rel=1e-6)


def test_integer_matmul_beyond_one_temporary_on_the_card(card):
    """An int32 product of 3072 x 3072 matrices: its products all at once
    would take 116 GB, more than the card holds, so it runs in blocks.
    Exact (the sums stay below 2^53, so float64 gives them exactly) and
    wrapping where the sums leave int32."""
    g = torch.Generator(device=card).manual_seed(11)
    a = torch.randint(-8, 8, (3072, 3072), device=card, generator=g, dtype=torch.int32)
    b = torch.randint(-8, 8, (3072, 3072), device=card, generator=g, dtype=torch.int32)
    got = ht.matmul(ht.array(a, split=0), ht.array(b))
    assert got.dtype is ht.int32 and got.split == 0
    assert torch.equal(got.larray, (a.double() @ b.double()).to(torch.int32))
    big = torch.randint(1 << 16, 1 << 20, (4, 3072), device=card, generator=g, dtype=torch.int32)
    wrapped = ht.matmul(ht.array(big), ht.array(big.T.contiguous())).larray
    assert torch.equal(wrapped.cpu(), (big.cpu().long() @ big.T.cpu().long()).to(torch.int32))


def _distance_points(seed):
    rng = np.random.default_rng(seed)
    centres = rng.standard_normal((4, 6)) * 5.0
    lab = rng.integers(0, 4, 1003)
    x = (centres[lab] + rng.standard_normal((1003, 6))).astype(np.float32)
    q = (centres[rng.integers(0, 4, 301)] + 1.5 * rng.standard_normal((301, 6))).astype(np.float32)
    return x, lab, q


def test_distances_on_the_card_match_cpu(card, monkeypatch):
    """cdist (both forms, Y and no Y), manhattan and rbf on the card against
    the CPU's: the broadcast forms within 1e-5, the expanded ones within the
    CPU tests' 1e-4 (two float32 evaluations of |x|^2 + |y|^2 - 2 x.y differ
    by up to 2e-5 of 1 + d on these points); blocks as small as the budget
    allows change nothing."""
    x, _, q = _distance_points(0)
    for split in (None, 0):
        X, Xh = ht.array(q, split=split), ht.array(q, split=split, device="cpu")
        Y, Yh = ht.array(x), ht.array(x, device="cpu")
        for name, call, tol in (("direct", lambda a, b: ht.spatial.cdist(a, b), 1e-5),
                                ("expanded", lambda a, b: ht.spatial.cdist(a, b, quadratic_expansion=True), 1e-4),
                                ("manhattan", lambda a, b: ht.spatial.manhattan(a, b), 1e-5),
                                ("rbf", lambda a, b: ht.spatial.rbf(a, b, sigma=3.0), 1e-4)):
            got, want = call(X, Y), call(Xh, Yh)
            assert got.larray.is_cuda and got.split == want.split
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=tol, atol=tol, err_msg=name)
        mine = ht.spatial.cdist(X).numpy()
        np.testing.assert_allclose(mine, ht.spatial.cdist(Xh).numpy(), rtol=1e-5, atol=1e-5)
    monkeypatch.setattr(ht.spatial.distance, "_BLOCK_ELEMENTS", 6 * 64)
    small = ht.spatial.manhattan(ht.array(q, split=0), ht.array(x)).numpy()
    np.testing.assert_allclose(small, ht.spatial.manhattan(ht.array(q, split=0, device="cpu"),
                                                           ht.array(x, device="cpu")).numpy(), rtol=1e-5, atol=1e-5)


def test_topk_and_knn_on_the_card_match_cpu(card):
    """cdist_topk's indices on the card equal the CPU's but at near-ties of
    the distances (within 1e-5), its values within 1e-5; KNN votes equal
    (the blobs keep every query's k-th neighbour clear of the next)."""
    x, lab, q = _distance_points(1)
    y = x.copy()
    y[[10, 500, 900]] = y[3]  # exact ties: the lower row on both
    vals, idx = ht.spatial.cdist_topk(ht.array(q, split=0), ht.array(y), 7)
    hv, hi = ht.spatial.cdist_topk(ht.array(q, split=0, device="cpu"), ht.array(y, device="cpu"), 7)
    np.testing.assert_allclose(vals.numpy(), hv.numpy(), rtol=1e-5, atol=1e-5)
    got, want = idx.numpy(), hi.numpy()
    d = np.sqrt(((q[:, None, :].astype(np.float64) - y[None].astype(np.float64)) ** 2).sum(-1))
    for r, c in zip(*np.nonzero(got != want)):
        assert abs(d[r, got[r, c]] - d[r, want[r, c]]) <= 1e-5 * (1 + d[r, want[r, c]])
    knn = ht.classification.KNeighborsClassifier(5).fit(ht.array(x, split=0), ht.array(lab, split=0))
    knn_h = ht.classification.KNeighborsClassifier(5).fit(ht.array(x, split=0, device="cpu"),
                                                          ht.array(lab, split=0, device="cpu"))
    assert torch.equal(knn.predict(ht.array(q, split=0)).larray.cpu(), knn_h.predict(ht.array(q, split=0, device="cpu")).larray)


@pytest.mark.parametrize("name", ["KMedians", "KMedoids"])
def test_kmedians_and_kmedoids_on_the_card_match_cpu(card, name):
    x, _, _ = _distance_points(2)
    init = "kmedians++" if name == "KMedians" else "kmedoids++"
    got = getattr(ht.cluster, name)(n_clusters=4, init=init, random_state=3).fit(ht.array(x, split=0))
    want = getattr(ht.cluster, name)(n_clusters=4, init=init, random_state=3).fit(ht.array(x, split=0, device="cpu"))
    assert got.n_iter_ == want.n_iter_
    assert torch.equal(got.labels_.larray.cpu(), want.labels_.larray)
    assert torch.equal(got.cluster_centers_.larray.cpu(), want.cluster_centers_.larray)
    assert got.inertia_ == pytest.approx(want.inertia_, rel=1e-5)


def test_laplacian_and_spherical_data_on_the_card_match_cpu(card):
    """The spherical points bitwise the CPU's; the Laplacians within rtol
    1e-4 (their rbf's expanded form rounds on the card otherwise, about
    5e-6 of a degree sum)."""
    pts = ht.utils.data.spherical.create_spherical_dataset(100, random_state=5)
    host = ht.utils.data.spherical.create_spherical_dataset(100, random_state=5, device="cpu")
    assert pts.larray.is_cuda and torch.equal(pts.larray.cpu(), host.larray)
    for definition in ("simple", "norm_sym"):
        lap = ht.graph.Laplacian(lambda z: ht.spatial.rbf(z, sigma=1.0), definition=definition)
        np.testing.assert_allclose(lap.construct(pts).numpy(), lap.construct(host).numpy(), rtol=1e-4, atol=1e-6)


def test_kmeans_at_widths_the_kernel_refuses_takes_the_plain_route(card):
    """F15: f = 200 float32 and f = 100 float64 exceed K1's register tile;
    lloyd_route answers "plain" and the fit runs the plain version on the
    card (no K1 launch), as the CPU does."""
    from heat_tpu_torch.core import kernels as k

    rng = np.random.default_rng(11)
    for f, dtype in ((200, np.float32), (100, np.float64)):
        centres = (rng.standard_normal((4, f)) * 6.0).astype(dtype)
        x = (centres[rng.integers(0, 4, 3001)] + rng.standard_normal((3001, f))).astype(dtype)
        assert k.lloyd_route(f, 4, dtype=torch.float32 if dtype == np.float32 else torch.float64) == "plain"
        before, plain_before = k.LLOYD_LAUNCHES, k.LLOYD_PLAIN_STEPS
        got = ht.cluster.KMeans(n_clusters=4, init=ht.array(centres), max_iter=20).fit(ht.array(x, split=0))
        assert k.LLOYD_LAUNCHES == before and k.LLOYD_PLAIN_STEPS - plain_before == got.n_iter_ + 1
        assert got.labels_.larray.is_cuda
        want = ht.cluster.KMeans(n_clusters=4, init=ht.array(centres, device="cpu"), max_iter=20).fit(
            ht.array(x, split=0, device="cpu"))
        assert got.n_iter_ == want.n_iter_
        np.testing.assert_array_equal(got.labels_.numpy(), want.labels_.numpy())
        np.testing.assert_allclose(got.cluster_centers_.numpy(), want.cluster_centers_.numpy(), atol=1e-4)
        np.testing.assert_array_equal(got.predict(ht.array(x[:500], split=0)).numpy(), want.labels_.numpy()[:500])
    with pytest.raises(ValueError, match="features"):  # the wrapper itself still refuses
        k.lloyd_partials(torch.randn(64, 200, device=card), torch.randn(4, 200, device=card), 64)


def test_flash_attention_at_refused_shapes_takes_the_einsum_route(card):
    """F15: d = 512 is past K7's gate: the gate sends the local attention
    to the einsum path (counted), without a K7 launch; float64 is cast to
    float32 for K7, which launches.  Both against the port on the CPU."""
    from heat_tpu_torch.nn import attention as att

    rng = np.random.default_rng(8)
    cases = [((96, 4, 512), np.float32, 0), ((96, 4, 64), np.float64, 1)]
    for shape, dtype, k7 in cases:
        qkv = [rng.standard_normal(shape).astype(dtype) for _ in range(3)]
        for split in (None, 0):
            before, einsum_before = _flash.FLASH_LAUNCHES, att.EINSUM_ROUTES
            got = ht.nn.scaled_dot_product_attention(*(ht.array(x, split=split) for x in qkv), causal=True,
                                                     method="flash")
            assert _flash.FLASH_LAUNCHES - before == k7 and att.EINSUM_ROUTES - einsum_before == 1 - k7
            assert got.dtype.__name__ == np.dtype(dtype).name and got.larray_padded.is_cuda
            want = ht.nn.scaled_dot_product_attention(*(ht.array(x, split=split, device="cpu") for x in qkv),
                                                      causal=True, method="flash")
            np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=0)


def test_linalg_on_the_card_matches_cpu(card):
    """qr, svd, the extras, the solvers and the full PCA on the card (cuSOLVER
    and cuBLAS through torch.linalg) against the port on the CPU: float64
    within the reference tests' 1e-8, float32 within 1e-4."""
    rng = np.random.default_rng(12)
    tall = rng.standard_normal((300, 12))
    sq = rng.standard_normal((40, 40))
    spd = sq @ sq.T + 40 * np.eye(40)
    b = rng.standard_normal((40, 3))

    def both(fn, *arrays, split=0):
        return (fn(*(ht.array(a, split=split) for a in arrays)), fn(*(ht.array(a, split=split, device="cpu")
                                                                      for a in arrays)))

    for split in (None, 0, 1):
        (gq, gr), (cq, cr) = both(ht.linalg.qr, tall, split=split)
        assert gq.larray_padded.is_cuda and (gq.split, gr.split) == (cq.split, cr.split)
        s = np.sign(np.diag(gr.numpy())) * np.sign(np.diag(cr.numpy()))
        np.testing.assert_allclose(gr.numpy() * s[:, None], cr.numpy(), rtol=1e-8, atol=1e-10)
        np.testing.assert_allclose(gq.numpy() * s, cq.numpy(), rtol=1e-8, atol=1e-10)
        gs, cs = both(lambda a: ht.linalg.svd(a, compute_uv=False), tall, split=split)
        np.testing.assert_allclose(gs.numpy(), cs.numpy(), rtol=1e-10)
    for name in ("cholesky", "inv", "det"):
        g, c = both(getattr(ht.linalg, name), spd)
        np.testing.assert_allclose(g.numpy(), c.numpy(), rtol=1e-8, atol=1e-10)
    g, c = both(ht.linalg.solve, spd, b)
    np.testing.assert_allclose(g.numpy(), c.numpy(), rtol=1e-8, atol=1e-10)
    for name in ("slogdet", "eigh"):
        for gg, cc in zip(*both(getattr(ht.linalg, name), spd, split=None)):
            got, want = gg.numpy(), cc.numpy()
            if got.ndim == 2:
                got = got * np.sign(np.sum(got * want, axis=0))
            np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-10)
    gw, cw = both(ht.linalg.eigvals, sq, split=None)
    np.testing.assert_allclose(np.sort_complex(gw.numpy()), np.sort_complex(cw.numpy()), rtol=1e-8)
    assert gw.larray.is_cuda  # on the operand's device, not the host's
    for gg, cc in zip(*both(ht.linalg.lstsq, tall, tall[:, 0])):
        np.testing.assert_allclose(gg.numpy(), cc.numpy(), rtol=1e-8, atol=1e-10)
    g, c = both(ht.linalg.pinv, tall)
    np.testing.assert_allclose(g.numpy(), c.numpy(), rtol=1e-8, atol=1e-10)
    g, c = both(lambda a, v: ht.linalg.cg(a, v, ht.zeros(40, dtype=ht.float64, device=a.device)), spd, b[:, 0])
    np.testing.assert_allclose(g.numpy(), c.numpy(), rtol=1e-8, atol=1e-10)
    g, c = both(ht.linalg.solve_triangular, np.triu(sq) + 8 * np.eye(40), b)
    np.testing.assert_allclose(g.numpy(), c.numpy(), rtol=1e-8, atol=1e-10)
    s32 = spd.astype(np.float32)
    ht.random.seed(3)
    gv, gt = ht.linalg.lanczos(ht.array(s32, split=0), 10)
    ht.random.seed(3)
    cv, ct = ht.linalg.lanczos(ht.array(s32, split=0, device="cpu"), 10)
    assert gv.larray.is_cuda
    np.testing.assert_allclose(gt.numpy(), ct.numpy(), rtol=1e-4, atol=1e-4)
    x32 = (tall @ rng.standard_normal((12, 12))).astype(np.float32)
    gp = ht.decomposition.PCA(n_components=4, svd_solver="full").fit(ht.array(x32, split=0))
    cp = ht.decomposition.PCA(n_components=4, svd_solver="full").fit(ht.array(x32, split=0, device="cpu"))
    gc, cc = gp.components_.numpy(), cp.components_.numpy()
    np.testing.assert_allclose(gc * np.sign(np.sum(gc * cc, axis=1))[:, None], cc, atol=1e-4)
    np.testing.assert_allclose(gp.explained_variance_.numpy(), cp.explained_variance_.numpy(), rtol=1e-4)


# ----------------------------------------------------------------------
# manipulations, the sort and its statistics, io and the scalers on the card
# ----------------------------------------------------------------------
def _pair(a, split=0):
    """``a`` on the card and on the host, split alike."""
    return ht.array(a, split=split, device="gpu"), ht.array(a, split=split, device="cpu")


def _bitwise(got, want):
    g, w = got.numpy(), want.numpy()
    assert got.split == want.split and got.dtype == want.dtype and g.shape == w.shape
    np.testing.assert_array_equal(g.view(np.uint8), w.view(np.uint8))


SORT_DTYPES = ["float32", "float64", "int32", "int64"]


@pytest.mark.parametrize("dtype", SORT_DTYPES)
def test_sort_on_the_card_is_the_hosts(card, dtype):
    rng = np.random.default_rng(60)
    x = (rng.integers(-40, 40, (4099, 5)) * 0.5).astype(dtype)
    if dtype.startswith("float"):
        x[::13, 0], x[3::17, 1], x[5::19, 2], x[7::23, 3] = np.nan, -0.0, 0.0, -np.nan
    for axis in (0, 1):
        for desc in (False, True):
            g, c = _pair(x)
            got, want = ht.sort(g, axis=axis, descending=desc), ht.sort(c, axis=axis, descending=desc)
            _bitwise(got[1], want[1])
            _bitwise(got[0], want[0])


@pytest.mark.parametrize("method", ["linear", "lower", "higher", "midpoint", "nearest"])
def test_percentile_on_the_card_is_the_hosts(card, method):
    rng = np.random.default_rng(61)
    x = rng.standard_normal((5003, 4)).astype(np.float32)
    for axis in (None, 0, 1):
        g, c = _pair(x)
        got = ht.percentile(g, [0, 12.5, 50, 99], axis=axis, interpolation=method)
        want = ht.percentile(c, [0, 12.5, 50, 99], axis=axis, interpolation=method)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=3e-5, atol=1e-6)
    g, c = _pair(x)
    np.testing.assert_array_equal(ht.median(g, axis=0).numpy(), ht.median(c, axis=0).numpy())


def test_topk_and_unique_on_the_card_are_the_hosts(card):
    rng = np.random.default_rng(62)
    x = rng.integers(0, 50, 10007).astype(np.float32)
    x[::101] = np.nan
    g, c = _pair(x)
    for largest in (True, False):
        got, want = ht.topk(g, 64, largest=largest), ht.topk(c, 64, largest=largest)
        _bitwise(got[1], want[1])
        _bitwise(got[0], want[0])
    _bitwise(ht.unique(g), ht.unique(c))
    gi, ci = _pair(rng.integers(0, 9, (300, 3)).astype(np.int64))
    _bitwise(ht.unique(gi), ht.unique(ci))
    got, want = ht.unique(gi, return_inverse=True), ht.unique(ci, return_inverse=True)
    _bitwise(got[1], want[1])


def test_row_moves_on_the_card_are_the_hosts(card):
    rng = np.random.default_rng(63)
    x = rng.standard_normal((1001, 6)).astype(np.float32)
    calls = (lambda m, a: m.reshape(a, (3003, 2)), lambda m, a: m.flatten(a),
             lambda m, a: m.concatenate([a, a], 0), lambda m, a: m.pad(a, ((2, 3), (1, 0)), mode="reflect"),
             lambda m, a: m.pad(a, 4, constant_values=1.5), lambda m, a: m.roll(a, 17, 0),
             lambda m, a: m.flip(a, 0), lambda m, a: m.unfold(a, 0, 5, 2), lambda m, a: m.tile(a, (2, 2)),
             lambda m, a: m.repeat(a, 3, 0), lambda m, a: m.diagonal(a, 1), lambda m, a: m.stack([a, a], 1))
    for call in calls:
        g, c = _pair(x)
        got, want = call(ht, g), call(ht, c)
        assert got.larray_padded.is_cuda
        _bitwise(got, want)


@pytest.mark.parametrize("ext", [".h5", ".npy", ".csv"])
def test_io_round_trips_through_the_card(card, tmp_path, ext):
    if ext == ".h5" and not ht.supports_hdf5():
        pytest.skip("needs h5py")
    x = np.random.default_rng(64).standard_normal((777, 4)).astype(np.float32)
    path = str(tmp_path / f"x{ext}")
    args = ("x",) if ext == ".h5" else ()
    g, c = _pair(x)
    ht.save(g, path, *args)
    back = ht.load(path, *args, split=0, device="gpu")
    assert back.larray_padded.is_cuda
    _bitwise(back, c)
    ht.save(c, str(tmp_path / f"y{ext}"), *args)
    assert (tmp_path / f"x{ext}").read_bytes() == (tmp_path / f"y{ext}").read_bytes() or ext == ".h5"


def test_scalers_on_the_card_match_the_hosts(card):
    x = np.random.default_rng(65).standard_normal((2049, 5)).astype(np.float32)
    for name in ("StandardScaler", "MinMaxScaler", "Normalizer", "MaxAbsScaler", "RobustScaler"):
        g, c = _pair(x)
        got = getattr(ht.preprocessing, name)().fit_transform(g)
        want = getattr(ht.preprocessing, name)().fit_transform(c)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-6)


# ---- the rest of the ML layer, napi and signal -------------------------------

from torch_napi_cases import ONE  # noqa: E402


def _close(got, want, rtol=3e-5, atol=1e-6):
    """One result on the card against the host's: split, type and shape,
    integers, bools and indices bitwise, floats within (rtol, atol)."""
    if isinstance(want, (tuple, list)):
        for g, w in zip(got, want):
            _close(g, w, rtol, atol)
        return
    if not isinstance(want, ht.DNDarray):
        np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol)
        return
    assert got.split == want.split and got.dtype == want.dtype and got.shape == want.shape
    assert got.larray_padded.is_cuda
    g, w = got.numpy(), want.numpy()
    if g.dtype.kind in "biu":
        np.testing.assert_array_equal(g, w)
    else:
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)


@pytest.mark.parametrize("dtype", ["float32", "float64", "int32"])
def test_napi_on_the_card_is_the_hosts(card, dtype):
    rng = np.random.default_rng(70)
    a = (rng.standard_normal((7, 5)) * 2 if dtype != "int32" else rng.integers(-9, 10, (7, 5))).astype(dtype)
    a[3] = a[1]
    if dtype != "int32":
        a[0, 1] = np.nan
        a[2, 2], a[5, 2] = 0.0, -0.0
    for name, call in ONE.items():
        if not name.startswith("nan") and dtype != "int32":
            a_use = np.nan_to_num(a)
        else:
            a_use = a
        g, c = _pair(a_use)
        try:
            want = call(ht, c)
        except Exception as e:
            with pytest.raises(type(e)):
                call(ht, g)
            continue
        _close(call(ht, g), want)


def test_convolve_on_the_card_is_ieee_float32(card):
    """Within 1e-5 (relative to the largest value) of float64, the bound
    a TF32 product (10 mantissa bits) would miss."""
    rng = np.random.default_rng(71)
    sig = rng.standard_normal(1 << 16).astype(np.float32)
    ker = rng.standard_normal(1025).astype(np.float32)
    for mode in ("full", "same", "valid"):
        got = ht.convolve(ht.array(sig, split=0, device="gpu"), ht.array(ker, device="gpu"), mode=mode)
        assert got.larray_padded.is_cuda and got.dtype == ht.float32
        want = np.convolve(sig.astype(np.float64), ker.astype(np.float64), mode=mode)
        assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    ints = rng.integers(-9, 10, 999).astype(np.int32)
    g, c = _pair(ints)
    _bitwise(ht.convolve(g, ht.array([1, -2, 3], device="gpu"), mode="same"),
             ht.convolve(c, ht.array([1, -2, 3], device="cpu"), mode="same"))


@pytest.mark.parametrize("cls", ["BatchParallelKMeans", "BatchParallelKMedians"])
def test_batch_parallel_on_the_card_is_the_hosts(card, cls):
    rng = np.random.default_rng(72)
    centres = rng.standard_normal((5, 6)) * 8.0
    x = (centres[rng.integers(0, 5, 20011)] + rng.standard_normal((20011, 6))).astype(np.float32)
    g, c = _pair(x)
    got = getattr(ht.cluster, cls)(n_clusters=5, random_state=3).fit(g)
    want = getattr(ht.cluster, cls)(n_clusters=5, random_state=3).fit(c)
    np.testing.assert_allclose(got.cluster_centers_.numpy(), want.cluster_centers_.numpy(), atol=5e-5)
    assert got.labels_.larray_padded.is_cuda
    _near_tie_mismatches(torch.from_numpy(x), want.cluster_centers_.larray, got.labels_.larray.cpu().long(),
                         want.labels_.larray.long())


def test_gaussian_nb_and_lasso_on_the_card_are_the_hosts(card):
    rng = np.random.default_rng(73)
    y = rng.integers(0, 4, 30001)
    x = (rng.standard_normal((30001, 8)) * (1 + y[:, None]) + y[:, None]).astype(np.float32)
    gx, cx = _pair(x)
    gy, cy = _pair(y.astype(np.int32))
    got, want = ht.naive_bayes.GaussianNB().fit(gx, gy), ht.naive_bayes.GaussianNB().fit(cx, cy)
    for attr in ("theta_", "var_"):
        np.testing.assert_allclose(getattr(got, attr).numpy(), getattr(want, attr).numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got.class_count_.numpy(), want.class_count_.numpy())
    np.testing.assert_array_equal(got.predict(gx).numpy(), want.predict(cx).numpy())
    np.testing.assert_allclose(got.predict_proba(gx).numpy(), want.predict_proba(cx).numpy(), atol=1e-5)
    w = rng.standard_normal(8).astype(np.float32)
    w[[2, 5]] = 0.0
    ly = (x @ w + 0.5 + 0.01 * rng.standard_normal(30001)).astype(np.float32)
    gl, cl = _pair(ly)
    got = ht.regression.Lasso(lam=0.01, max_iter=30).fit(gx, gl)
    want = ht.regression.Lasso(lam=0.01, max_iter=30).fit(cx, cl)
    np.testing.assert_allclose(got.theta.numpy(), want.theta.numpy(), atol=1e-5)
    assert got.n_iter == want.n_iter
    np.testing.assert_allclose(got.predict(gx).numpy(), want.predict(cx).numpy(), rtol=1e-5, atol=1e-5)


def test_spectral_on_the_card_is_the_hosts(card):
    from heat_tpu_torch.core import random as rnd

    rng = np.random.default_rng(74)
    blobs = np.concatenate([rng.normal(-4, 0.6, (300, 2)), rng.normal(0, 0.6, (300, 2)),
                            rng.normal(4, 0.6, (300, 2))]).astype(np.float32)
    x = rng.permutation(blobs)
    g, c = _pair(x)
    ht.random.seed(1)
    kernels.LLOYD_LAUNCHES = rnd.THREEFRY_LAUNCHES = 0
    got = ht.cluster.Spectral(n_clusters=3, gamma=0.5, n_lanczos=40)
    labels = got.fit_predict(g)
    assert kernels.LLOYD_LAUNCHES == got._cluster.n_iter_ + 1 and rnd.THREEFRY_LAUNCHES >= 1
    ht.random.seed(1)
    want = ht.cluster.Spectral(n_clusters=3, gamma=0.5, n_lanczos=40).fit_predict(c)
    assert labels.larray_padded.is_cuda
    np.testing.assert_array_equal(labels.numpy(), want.numpy())


def _sparse_ops(device, fmt, split, dtype):
    """Every sparse op of one matrix pair on ``device``: name -> the
    result's host arrays (a sparse result's global planes, a dense one's
    values)."""
    import scipy.sparse as sp

    rng = np.random.default_rng(90)
    mats = []
    for seed in (1, 2):
        m = sp.random(57, 41, density=0.15, random_state=seed, format="csr")
        m.data = (m.data + 0.5).astype(dtype) if dtype != "int32" else rng.integers(1, 9, m.nnz).astype(dtype)
        mats.append(m)
    make = ht.sparse.sparse_csr_matrix if fmt == "csr" else ht.sparse.sparse_csc_matrix
    a, b = (make(m if fmt == "csr" else m.tocsc(), split=split, device=device) for m in mats)
    x = rng.integers(-3, 4, (41, 5)).astype(dtype)
    e = rng.integers(-3, 4, (4, 57)).astype(dtype)
    s = ht.sparse.sparse_csr_matrix(sp.random(41, 33, density=0.2, random_state=3, format="csr", dtype=dtype),
                                    split=0, device=device)
    ops = {"add": a + b, "mul": a * b, "scalar": a * 3 + 1, "T": a.T, "astype": a.astype(ht.float64),
           "to_csc": ht.sparse.to_sparse_csc(a), "to_csr": ht.sparse.to_sparse_csr(a),
           "spmm": a @ ht.array(x, split=0, device=device), "spmv": a @ ht.array(x[:, 0].copy(), device=device),
           "dense_sp": ht.array(e, split=1, device=device) @ a, "todense": a.todense(), "spgemm": a @ s,
           "sum": a.sum(), "sum0": a.sum(axis=0), "sum1": a.sum(axis=1)}
    out = {}
    for name, r in ops.items():
        if hasattr(r, "_comp"):
            assert r._val.device.type == ("cuda" if device == "gpu" else "cpu"), name
            out[name] = [r.indptr.cpu().numpy(), r.indices.cpu().numpy(), r.data.cpu().numpy()]
        else:
            assert r.larray_padded.device.type == ("cuda" if device == "gpu" else "cpu"), name
            out[name] = [r.numpy()]
    return out


@pytest.mark.parametrize("fmt,split", [("csr", None), ("csr", 0), ("csc", None), ("csc", 1)])
@pytest.mark.parametrize("dtype", ["float32", "float64", "int32"])
def test_sparse_ops_on_the_card_are_the_hosts(card, fmt, split, dtype):
    """Every sparse op on the card against the port on the CPU: patterns
    bitwise, the element-wise ops, conversions and integer products
    bitwise, the float products and sums within 1e-6 (float32) and 1e-12
    (float64) of the result's largest magnitude (X and E hold integers of
    both signs: sums cancel, and the card adds in fused multiply-adds);
    each op run twice on the card bitwise equal."""
    got = _sparse_ops("gpu", fmt, split, dtype)
    again = _sparse_ops("gpu", fmt, split, dtype)
    want = _sparse_ops("cpu", fmt, split, dtype)
    for name in want:
        for g, a, w in zip(got[name], again[name], want[name]):
            assert g.tobytes() == a.tobytes(), name
            assert g.dtype == w.dtype and g.shape == w.shape, name
            if dtype == "int32" or name in ("add", "mul", "scalar", "T", "astype", "to_csc", "to_csr", "todense"):
                assert g.tobytes() == w.tobytes(), name
            else:
                tol = 1e-6 if dtype == "float32" else 1e-12
                np.testing.assert_allclose(g, w, rtol=tol, atol=tol * float(np.abs(w).max()), err_msg=name)


@pytest.mark.parametrize("width,dtype", [(1, torch.float32), (3, torch.float32), (32, torch.float32),
                                         (33, torch.float64), (65, torch.float32), (1, torch.int64),
                                         (7, torch.int32), (32, torch.float16), (1, torch.float16),
                                         (33, torch.bfloat16), (32, torch.complex64), (1, torch.complex128),
                                         (32, torch.int8), (1, torch.uint8), (7, torch.int16), (32, torch.bool),
                                         (1, torch.bool)])
def test_csr_spmm_kernel_matches_plain(card, width, dtype):
    """The CSR SpMM kernel against its plain version on ragged rows (empty
    ones, ones past a warp), into a new output and accumulating into one:
    float32 within 1e-6 and float64 within 1e-14 of the plain sum's max;
    float16, bfloat16 and complex each element within (2 len + 8) u S of
    the plain one, S its row's sum of |w||x| (and |out|) and u the type's
    unit roundoff: each is within (len + 4) u S of the exact sum, the bound
    of a recursive sum of len products (the plain version adds in the type
    itself); integers and bool
    exactly; a second launch bitwise equal, one launch counted each."""
    from heat_tpu_torch.sparse import _planes

    g = torch.Generator(device=card).manual_seed(width)
    lengths = torch.randint(0, 100, (701,), device=card, generator=g)
    lengths[::5] = 0
    ptr = torch.cat([torch.zeros(1, dtype=torch.int64, device=card), torch.cumsum(lengths, 0)])
    col = torch.randint(0, 97, (int(ptr[-1]),), device=card, generator=g, dtype=torch.int32)

    def draw(*shape):
        if dtype.is_floating_point or dtype.is_complex:
            return torch.randn(*shape, device=card, generator=g, dtype=dtype)
        if dtype == torch.bool:
            return torch.randint(0, 2, shape, device=card, generator=g).bool()
        return torch.randint(-9 if dtype.is_signed else 0, 10, shape, device=card, generator=g).to(dtype)

    w = draw(col.numel())
    x = draw(97, width + 3)[:, :width]
    for base in (None, draw(701, width)):
        before = _planes.CSR_SPMM_LAUNCHES
        got = _planes.csr_spmm(ptr, col, w, x, None if base is None else base.clone())
        again = _planes.csr_spmm(ptr, col, w, x, None if base is None else base.clone())
        assert _planes.CSR_SPMM_LAUNCHES == before + 2
        want = _planes._csr_spmm_plain(ptr, col, w, x, torch.zeros_like(got) if base is None else base.clone())
        assert torch.equal(got, again)
        if dtype in (torch.float32, torch.float64):
            tol = 1e-6 if dtype == torch.float32 else 1e-14
            assert float((got - want).abs().max()) <= tol * float(want.abs().max())
        elif dtype.is_floating_point or dtype.is_complex:
            wide = torch.complex128 if dtype.is_complex else torch.float64
            s = _planes._csr_spmm_plain(ptr, col, w.abs().double(), x.abs().double(),
                                        torch.zeros(got.shape, dtype=torch.float64, device=card))
            if base is not None:
                s += base.abs().double()
            u = torch.finfo(got.real.dtype if dtype.is_complex else dtype).eps / 2
            bound = (2 * lengths.double()[:, None] + 8) * u * s
            assert bool(((got.to(wide) - want.to(wide)).abs() <= bound).all())
        else:
            assert torch.equal(got, want)


def test_csr_spmm_kernel_refuses_what_it_cannot_take(card):
    from heat_tpu_torch.sparse import _planes

    ptr = torch.tensor([0, 2, 3], device=card)
    col = torch.tensor([0, 1, 1], dtype=torch.int32, device=card)
    w = torch.ones(3, device=card)
    with pytest.raises(TypeError):
        _planes.csr_spmm(ptr, col, w.half(), torch.ones(2, 2, device=card))  # values of another type than x
    with pytest.raises(TypeError):
        _planes.csr_spmm(ptr, col.long(), w, torch.ones(2, 2, device=card))
    with pytest.raises(ValueError, match="stride"):
        _planes.csr_spmm(ptr, col, w, torch.ones(2, 4, device=card)[:, ::2])


def test_sparse_factories_pack_card_tensors_on_the_card(card):
    """A dense or sparse torch tensor on the card is packed there: planes
    on the card, the same matrix as from the host copy."""
    import scipy.sparse as sp

    m = sp.random(57, 41, density=0.15, random_state=5, format="csr", dtype=np.float32)
    dense = torch.tensor(m.toarray(), device=card)
    for source in (dense, dense.to_sparse_coo(), dense.to_sparse_csr()):
        for make in (ht.sparse.sparse_csr_matrix, ht.sparse.sparse_csc_matrix):
            got = make(source)
            assert got._val.is_cuda and got._comp.is_cuda
            want = make(m)
            for g, w in ((got.indptr, want.indptr), (got.indices, want.indices), (got.data, want.data)):
                assert torch.equal(g.cpu(), w.cpu())


# ----------------------------------------------------------------------
# the unsigned types' arithmetic and the data tooling on the card
# ----------------------------------------------------------------------
def _unsigned(dtype, n, seed):
    rng = np.random.default_rng(seed)
    bits = np.iinfo(dtype).bits
    v = (rng.integers(0, 2**63, n, dtype=np.uint64) << np.uint64(1) | np.uint64(seed & 1)) >> np.uint64(64 - bits)
    v = v.astype(dtype)
    v[:5] = [0, 1, np.iinfo(dtype).max, np.iinfo(dtype).max // 2 + 1, np.iinfo(dtype).max // 2]
    return v


UNSIGNED_CALLS = [
    ("add", lambda m, a, b: a + b), ("sub", lambda m, a, b: a - b), ("mul", lambda m, a, b: a * b),
    ("floordiv", lambda m, a, b: a // b), ("mod", lambda m, a, b: a % b), ("shift", lambda m, a, b: a >> m.array(b.numpy() % 5, split=0, device=a.device)),
    ("lt", lambda m, a, b: a < b), ("ge", lambda m, a, b: a >= b), ("maximum", lambda m, a, b: m.maximum(a, b)),
    ("sum", lambda m, a, b: m.sum(a)), ("prod", lambda m, a, b: m.prod(a)), ("cumsum", lambda m, a, b: m.cumsum(a, 0)),
    ("max", lambda m, a, b: m.max(a)), ("argmax", lambda m, a, b: m.argmax(a)), ("argmin", lambda m, a, b: m.argmin(a)),
    ("sort", lambda m, a, b: m.sort(a)[0]), ("unique", lambda m, a, b: m.unique(a)),
    ("float32", lambda m, a, b: a.astype(m.float32)), ("float64", lambda m, a, b: a.astype(m.float64)),
    ("sin", lambda m, a, b: m.sin(a)), ("neg", lambda m, a, b: -a), ("gcd", lambda m, a, b: m.gcd(a, b)),
    ("clip", lambda m, a, b: m.clip(a, 3, 2**15)), ("var", lambda m, a, b: m.var(a)),
]


@pytest.mark.parametrize("dtype", ["uint16", "uint32", "uint64"])
@pytest.mark.parametrize("name,fn", UNSIGNED_CALLS, ids=[c[0] for c in UNSIGNED_CALLS])
def test_unsigned_ops_on_the_card_are_the_hosts(card, dtype, name, fn):
    a, b = _unsigned(dtype, 4099, 1), _unsigned(dtype, 4099, 2)
    b[b == 0] = 7
    got = fn(ht, ht.array(a, split=0, device="gpu"), ht.array(b, split=0, device="gpu"))
    want = fn(ht, ht.array(a, split=0, device="cpu"), ht.array(b, split=0, device="cpu"))
    assert got.dtype == want.dtype and got.larray.is_cuda
    if want.numpy().dtype.kind in "biu":
        assert got.numpy().tobytes() == want.numpy().tobytes()
    else:
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=3e-5 if name != "float64" else 0, atol=0)


def test_prefetch_stages_on_a_side_stream(card):
    from heat_tpu_torch.utils.data import prefetch

    prefetch.prefetch_stats(reset=True)
    host = [torch.randn(1 << 16, 8, generator=torch.Generator().manual_seed(i)) for i in range(6)]
    batches = [(h, ht.array(h, split=0, device="cpu")) for h in host]
    seen = []
    for i, (t, d) in enumerate(ht.utils.data.prefetch_to_device(iter(batches), size=2)):
        assert t.is_cuda and d.larray.is_cuda
        seen.append((t * 2).sum())  # a read on the default stream, after its wait
        assert torch.equal(t.cpu(), host[i]) and torch.equal(d.larray.cpu(), host[i])
    assert prefetch.prefetch_stats() == {"prefetch_hits": 6, "prefetch_misses": 0}
    torch.cuda.synchronize()


def test_ishuffle_on_the_card_is_the_hosts(card):
    x = np.random.default_rng(3).standard_normal((1000, 4)).astype(np.float32)
    out = []
    for dev in ("gpu", "cpu"):
        ht.random.seed(11)
        ds = ht.utils.data.Dataset(ht.array(x, split=0, device=dev))
        ht.utils.data.dataset_ishuffle(ds)
        ht.utils.data.dataset_irecv(ds)
        out.append(ds.arrays[0].numpy())
    assert out[0].tobytes() == out[1].tobytes()


def test_daso_step_on_the_card_is_the_hosts(card):
    import copy

    model = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.ReLU(), torch.nn.Linear(16, 2))
    host = copy.deepcopy(model)
    model = model.to(card)
    X = torch.randn(48, 8, generator=torch.Generator().manual_seed(0))
    y = (X[:, 0] > 0).long()
    runs = []
    for m, dev in ((model, card), (host, torch.device("cpu"))):
        daso = ht.optim.DASO(ht.optim.SGD(m.parameters(), lr=0.1), total_epochs=1,
                             comm=ht.parallel.HierarchicalCommunication(), warmup_epochs=0, cooldown_epochs=0)
        daso.global_skip, daso.batches_to_wait = 2, 1
        dp = ht.nn.DataParallelMultiGPU(m, daso=daso)
        runs.append([dp.step(torch.nn.functional.cross_entropy, X.to(dev), y.to(dev)) for _ in range(5)])
        daso.last_batch()
    np.testing.assert_allclose(runs[0], runs[1], rtol=1e-5)
    for p, q in zip(model.parameters(), host.parameters()):
        np.testing.assert_allclose(p.detach().cpu().numpy(), q.detach().numpy(), atol=1e-5)


# ----------------------------------------------------------------------
# faults F19, F21 and F22: the card's answers are the CPU's
# ----------------------------------------------------------------------
def _leaves(r):
    return [x for part in r for x in _leaves(part)] if isinstance(r, (tuple, list)) else [r]


@pytest.mark.parametrize("split", [None, 0])
@pytest.mark.parametrize("name", __import__("torch_fault_cases").CARD_CASES)
def test_fault_cases_on_the_card_are_the_hosts(card, name, split):
    """Bitwise, but for complex ``logaddexp2``, whose exp and log1p on the
    card round otherwise than on the CPU (within the reference's float32
    bound, 3e-5 relative and 1e-6 absolute)."""
    from torch_fault_cases import CASES

    fn, inputs = CASES[name]
    arrays = inputs()
    runs = []
    for dev in ("gpu", "cpu"):
        ops = [ht.array(a, split=split if i == 0 else None, device=dev) for i, a in enumerate(arrays)]
        runs.append(_leaves(fn(ht, *ops)))
    for got, want in zip(*runs):
        assert got.dtype == want.dtype and got.larray.is_cuda
        g, w = got.numpy(), want.numpy()
        if name == "f21_logaddexp2_complex64":
            np.testing.assert_allclose(g, w, rtol=3e-5, atol=1e-6)
        else:
            assert g.tobytes() == w.tobytes(), name


def test_array_of_ml_dtypes_bfloat16_on_the_card(card):
    ml_dtypes = pytest.importorskip("ml_dtypes")
    a = np.random.default_rng(1).standard_normal((1000, 3)).astype(ml_dtypes.bfloat16)
    for split in (None, 0, 1):
        got = ht.array(a, split=split, device="gpu")
        assert got.dtype is ht.bfloat16 and got.larray.is_cuda
        assert got.numpy().tobytes() == ht.array(a, split=split, device="cpu").numpy().tobytes()


@pytest.mark.parametrize("index", ["int64", "bool", "dndarray", "float32"])
def test_delete_with_a_card_index_is_the_hosts(card, index):
    """napi's delete takes a torch index on the card (its type read from its
    dtype, its values never copied to the host to decide), and refuses a
    float one as on the CPU."""
    x = np.arange(24.0, dtype=np.float32).reshape(6, 4)
    picks = {"int64": np.array([0, 3, -1]), "bool": np.array([True, False, False, True, False, True]),
             "float32": np.array([1.0], np.float32)}
    for device, dev in (("gpu", card), ("cpu", torch.device("cpu"))):
        a = ht.array(x, device=device)
        obj = ht.array(picks["int64"], device=device) if index == "dndarray" else \
            torch.as_tensor(picks[index], device=dev)
        if index == "float32":
            with pytest.raises(ValueError):
                ht.napi.delete(a, obj, axis=0)
            continue
        got = ht.napi.delete(a, obj, axis=0)
        if device == "gpu":
            assert got.larray.is_cuda
            on_card = got.numpy()
        else:
            np.testing.assert_array_equal(got.numpy(), on_card)
