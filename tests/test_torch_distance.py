"""The port's distances (heat_tpu_torch/spatial/distance.py) against
heat_tpu's on the same seeded numpy inputs.

The port runs on one CPU rank (every rank computes its own rows of X against
Y), the reference on the suite's 8 devices, where X split 0 takes its
ppermute ring.  Values are held to the reference tests' bounds (the direct
form rtol 1e-5, atol 1e-9, as tests/test_ml.py:210-229; the rest 1e-4):
the two packages add a row's squared differences in other orders.  The
ring's round schedule is held, rank by rank, against the reference's ring
on 2 to 5 devices; the blocks that bound the broadcast forms' memory, and
the top-k merge's tie order, are checked here too.  The world of 3 ranks is
in tests/test_torch_gloo.py."""

import jax
import numpy as np
import pytest
import torch

import heat_tpu as hj
import heat_tpu_torch as ht
from heat_tpu_torch.spatial import distance


@pytest.fixture(autouse=True)
def _port_on_cpu():
    ht.use_device("cpu")


def _points(n, f, seed, dtype="float32"):
    rng = np.random.default_rng(seed)
    if dtype == "int32":
        return rng.integers(-9, 10, (n, f)).astype(np.int32)
    return rng.standard_normal((n, f)).astype(dtype)


def _call(pkg, name, X, Y):
    if name == "cdist_expanded":
        return pkg.spatial.cdist(X, Y, quadratic_expansion=True)
    if name == "rbf":
        return pkg.spatial.rbf(X, Y, sigma=1.5)
    return getattr(pkg.spatial, name)(X, Y)


def _tolerance(name):
    return (1e-5, 1e-9) if name == "cdist" else (1e-4, 1e-4)


@pytest.mark.parametrize("dtype", ["float32", "int32"])
@pytest.mark.parametrize("ysplit", [None, 0, "no Y"])
@pytest.mark.parametrize("xsplit", [None, 0])
@pytest.mark.parametrize("name", ["cdist", "cdist_expanded", "manhattan", "rbf"])
def test_distances_match_the_reference(name, xsplit, ysplit, dtype):
    x, y = _points(23, 5, 1, dtype), _points(17, 5, 2, dtype)  # uneven over 8 devices
    if ysplit == "no Y":
        got, want = _call(ht, name, ht.array(x, split=xsplit), None), _call(hj, name, hj.array(x, split=xsplit), None)
    else:
        got = _call(ht, name, ht.array(x, split=xsplit), ht.array(y, split=ysplit))
        want = _call(hj, name, hj.array(x, split=xsplit), hj.array(y, split=ysplit))
    assert got.shape == want.shape and got.split == want.split
    assert got.dtype.__name__ == want.dtype.__name__ == "float32"
    rtol, atol = _tolerance(name)
    g, w = got.numpy().copy(), np.array(want.numpy())
    if name == "cdist_expanded" and ysplit == "no Y":
        # a point's distance to itself by the expanded form is the rounding
        # left of |x|^2 + |x|^2 - 2 x.x, which the two packages round
        # otherwise: its square is held to 8 ulp of |x|^2
        diag = np.arange(len(x))
        scale = 8 * np.finfo(np.float32).eps * (x.astype(np.float64) ** 2).sum(1)
        assert (np.abs(g[diag, diag].astype(np.float64) ** 2 - w[diag, diag].astype(np.float64) ** 2) <= scale).all()
        g[diag, diag] = w[diag, diag] = 0.0
    np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)


def test_mixed_types_promote_as_the_reference():
    x, y = _points(9, 3, 3, "float64"), _points(7, 3, 4, "float32")
    for X, Y, RX, RY in ((ht.array(x), ht.array(y), hj.array(x), hj.array(y)),
                         (ht.array(y), ht.array(x.astype(np.int32)), hj.array(y), hj.array(x.astype(np.int32)))):
        got, want = ht.spatial.cdist(X, Y), hj.spatial.cdist(RX, RY)
        assert got.dtype.__name__ == want.dtype.__name__
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-9)


def test_direct_form_is_exact_for_near_duplicates():
    """tests/test_ml.py's case: the direct form against scipy in float64 at
    rtol 1e-5, atol 1e-9, and never worse than the expanded form."""
    from scipy.spatial.distance import cdist as sp_cdist

    base = np.random.default_rng(3).standard_normal((9, 5)) * 100.0
    x, y = base, base + 1e-7
    direct = ht.spatial.cdist(ht.array(x, split=0), ht.array(y)).numpy()
    np.testing.assert_allclose(direct, sp_cdist(x, y), rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(direct, hj.spatial.cdist(hj.array(x, split=0), hj.array(y)).numpy(), rtol=1e-5, atol=1e-9)
    expanded = ht.spatial.cdist(ht.array(x, split=0), ht.array(y), quadratic_expansion=True).numpy()
    assert np.abs(direct - sp_cdist(x, y)).max() <= np.abs(expanded - sp_cdist(x, y)).max()


def test_exports():
    assert ht.spatial.cdist_small is ht.spatial.cdist
    assert ht.spatial.distance.cdist is ht.spatial.cdist
    for name in ("cdist", "cdist_small", "cdist_topk", "manhattan", "rbf"):
        assert name in ht.spatial.distance.__all__ and callable(getattr(ht.spatial, name))


def _refusal(pkg, call):
    x = pkg.array(_points(6, 3, 5))
    cases = {
        "not an array": lambda: call(pkg, _points(6, 3, 5), x),
        "3-D X": lambda: call(pkg, pkg.array(np.zeros((2, 3, 3), np.float32)), x),
        "X split 1": lambda: call(pkg, pkg.array(_points(6, 3, 5), split=1), x),
        "1-D Y": lambda: call(pkg, x, pkg.array(np.zeros(3, np.float32))),
        "features": lambda: call(pkg, x, pkg.array(_points(6, 4, 5))),
    }
    return cases


@pytest.mark.parametrize("case", ["not an array", "3-D X", "X split 1", "1-D Y", "features"])
@pytest.mark.parametrize("name", ["cdist", "manhattan", "rbf", "cdist_topk"])
def test_refusals_are_the_references(name, case):
    def call(pkg, X, Y):
        fn = getattr(pkg.spatial, name)
        return fn(X, Y, 2) if name == "cdist_topk" else fn(X, Y)

    want = _refusal(hj, call)[case]
    with pytest.raises(Exception) as caught:
        want()
    # the reference's ring test reads X.split before its checks run, so a
    # non-array X raises AttributeError there; its checks' own TypeError here
    expected = TypeError if case == "not an array" else caught.type
    with pytest.raises(expected):
        _refusal(ht, call)[case]()


def test_topk_beyond_y_and_low_precision_raise(monkeypatch):
    x = ht.array(_points(6, 3, 5), split=0)
    with pytest.raises(ValueError, match="exceeds"):
        ht.spatial.cdist_topk(x, x, 7)
    with pytest.raises(ValueError, match="exceeds"):
        hj.spatial.cdist_topk(hj.array(_points(6, 3, 5), split=0), hj.array(_points(6, 3, 5)), 7)
    monkeypatch.setenv("HEAT_TPU_PREDICT_DTYPE", "bfloat16")
    for call in (lambda: ht.spatial.cdist(x), lambda: ht.spatial.cdist_topk(x, x, 2)):
        with pytest.raises(NotImplementedError, match="item 18"):
            call()


@pytest.mark.parametrize("ysplit", [None, 0])
@pytest.mark.parametrize("xsplit", [None, 0])
def test_topk_matches_the_reference(xsplit, ysplit):
    x, y = _points(29, 6, 6), _points(41, 6, 7)
    vals, idx = ht.spatial.cdist_topk(ht.array(x, split=xsplit), ht.array(y, split=ysplit), 5)
    want_vals, want_idx = hj.spatial.cdist_topk(hj.array(x, split=xsplit), hj.array(y, split=ysplit), 5)
    assert vals.split == want_vals.split and idx.split == want_idx.split
    assert idx.dtype is ht.int32 and vals.dtype is ht.float32
    np.testing.assert_allclose(vals.numpy(), want_vals.numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(idx.numpy(), want_idx.numpy())


def test_topk_ties_keep_the_lower_row():
    """Duplicated Y rows: the indices in ``jax.lax.top_k``'s order (the
    reference's dense top_k: Y not split), across the merge's blocks."""
    x, y = _points(13, 4, 8), _points(30, 4, 9)
    y[[7, 19, 28]] = y[2]
    y[[11, 25]] = y[4]
    want_vals, want_idx = hj.spatial.cdist_topk(hj.array(x, split=0), hj.array(y), 6)
    for block in (1 << 28, 3 * 13):  # one block, and blocks of 3 columns (13 rows a block)
        distance._BLOCK_ELEMENTS, saved = block, distance._BLOCK_ELEMENTS
        try:
            vals, idx = ht.spatial.cdist_topk(ht.array(x, split=0), ht.array(y), 6)
        finally:
            distance._BLOCK_ELEMENTS = saved
        np.testing.assert_array_equal(idx.numpy(), want_idx.numpy())
        np.testing.assert_allclose(vals.numpy(), want_vals.numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_smallest_is_stable(dtype):
    """The k smallest of each row in ``top_k``'s order: ascending, ties to
    the lower column (float32 by the packed key, float64 by a stable
    sort), against numpy's lexsort."""
    rng = np.random.default_rng(10)
    cand = np.round(rng.random((50, 40)) * 6).astype(np.float64) / 4
    cand[:, ::7] = np.inf
    got = distance._smallest(torch.tensor(cand, dtype=dtype), 9).numpy()
    cols = np.arange(40)
    want = np.stack([np.lexsort((cols, row))[:9] for row in cand])
    np.testing.assert_array_equal(got, want)


def _assemble_ring(x, y, p, metric):
    """Every rank's rounds of the ring in one process, as
    ``_ring_schedule`` orders them, with the ppermutes done by hand: the
    (n, m) matrix the p ranks' row bands make."""
    symmetric = y is None
    y = x if symmetric else y
    n, m = x.shape[0], y.shape[0]
    bn, bm = -(-n // p), -(-m // p)
    xb = [torch.zeros(bn, x.shape[1]) for _ in range(p)]
    yb = [torch.zeros(bm, y.shape[1]) for _ in range(p)]
    for r in range(p):
        xb[r][: len(x[r * bn:(r + 1) * bn])] = torch.tensor(x[r * bn:(r + 1) * bn])
        yb[r][: len(y[r * bm:(r + 1) * bm])] = torch.tensor(y[r * bm:(r + 1) * bm])
    if symmetric:
        yb = [b.clone() for b in xb]
    out = [torch.full((bn, p * bm), float("nan")) for _ in range(p)]
    schedules = [distance._ring_schedule(r, p, symmetric) for r in range(p)]
    assert len({len(s) for s in schedules}) == 1
    held = list(range(p))  # whose Y block each rank holds
    for it in range(len(schedules[0])):
        tiles = []
        for r in range(p):
            owner, mirror = schedules[r][it]
            assert owner == held[r] == (r + it) % p
            tile = distance._pairwise(metric, xb[r], yb[held[r]])
            out[r][:, owner * bm:(owner + 1) * bm] = tile
            tiles.append((tile, mirror))
        for r in range(p):
            mirror = tiles[r][1]
            if mirror is not None:
                perm, src = mirror
                assert all(m_[1] is not None and m_[1][0] == perm for m_ in tiles)  # one perm on every rank
                sender = [s for s, d in perm if d == r]
                assert sender == [src]
                out[r][:, src * bm:(src + 1) * bm] = tiles[src][0].T
        held = [held[(r + 1) % p] for r in range(p)]  # every block moves one rank down
    full = torch.cat(out)[:n, :m]
    assert not torch.isnan(full).any()  # every tile written
    return full.numpy()


@pytest.mark.parametrize("symmetric", [False, True])
@pytest.mark.parametrize("p", [2, 3, 4, 5])
def test_ring_schedule_builds_the_references_matrix(p, symmetric):
    """The rounds of all p ranks, assembled in one process, give the
    matrix of the reference's ring on p devices (for an even p, round p/2
    has no mirror)."""
    x, y = _points(4 * p + 3, 5, 11 + p), _points(3 * p - 1, 5, 12 + p)
    comm = hj.Communication(jax.devices()[:p])
    rx = hj.array(x, split=0, comm=comm)
    ry = None if symmetric else hj.array(y, split=0, comm=comm)
    for metric, call in (("euclidean_direct", hj.spatial.cdist), ("manhattan", hj.spatial.manhattan)):
        got = _assemble_ring(x, None if symmetric else y, p, metric)
        want = call(rx, ry).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    rounds = len(distance._ring_schedule(0, p, symmetric))
    assert rounds == (p // 2 + 1 if symmetric else p)


@pytest.mark.parametrize("metric,tile", [("euclidean_direct", "_direct_tile"), ("manhattan", "_cityblock_tile")])
def test_broadcast_forms_stay_within_the_block_budget(monkeypatch, metric, tile):
    """No block's (f, rows, cols) intermediate passes the budget, for a
    call whose whole intermediate would be 30 times it; the blocks tile the
    result, which equals the unblocked one."""
    x, y = _points(61, 7, 13), _points(45, 7, 14)
    whole = distance._pairwise(metric, torch.tensor(x), torch.tensor(y))
    shapes = []
    inner = getattr(distance, tile)

    def recording(a, b):
        shapes.append((a.shape[0], b.shape[0], a.shape[1]))
        return inner(a, b)

    budget = 61 * 45 * 7 // 30
    monkeypatch.setattr(distance, "_BLOCK_ELEMENTS", budget)
    monkeypatch.setitem(distance._METRICS, metric, recording)
    name = "cdist" if metric == "euclidean_direct" else "manhattan"
    got = getattr(ht.spatial, name)(ht.array(x, split=0), ht.array(y)).larray
    assert len(shapes) >= 30
    assert all(r * c * f <= budget for r, c, f in shapes)
    assert sum(r * c for r, c, _ in shapes) == 61 * 45
    np.testing.assert_array_equal(got.numpy(), whole.numpy())


def test_a_wide_y_is_cut_into_column_blocks(monkeypatch):
    x, y = _points(5, 8, 15), _points(40, 8, 16)
    shapes = []
    inner = distance._cityblock_tile
    monkeypatch.setattr(distance, "_BLOCK_ELEMENTS", 8 * 6)  # less than one row of x against all of y
    monkeypatch.setitem(distance._METRICS, "manhattan",
                        lambda a, b: shapes.append((a.shape[0], b.shape[0])) or inner(a, b))
    got = ht.spatial.manhattan(ht.array(x), ht.array(y)).numpy()
    assert max(r * c for r, c in shapes) <= 6 and len(shapes) == 5 * 7
    np.testing.assert_allclose(got, hj.spatial.manhattan(hj.array(x), hj.array(y)).numpy(), rtol=1e-5, atol=1e-6)


def test_topk_candidates_stay_within_the_block_budget(monkeypatch):
    x, y = _points(20, 3, 17), _points(90, 3, 18)
    sizes = []
    inner = distance._smallest
    monkeypatch.setattr(distance, "_BLOCK_ELEMENTS", 20 * 14)
    monkeypatch.setattr(distance, "_smallest", lambda cand, k: sizes.append(cand.numel()) or inner(cand, k))
    vals, idx = ht.spatial.cdist_topk(ht.array(x, split=0), ht.array(y), 4)
    assert len(sizes) == 9 and max(sizes) <= 20 * 14  # 10 new columns a block
    want_vals, want_idx = hj.spatial.cdist_topk(hj.array(x, split=0), hj.array(y), 4)
    np.testing.assert_array_equal(idx.numpy(), want_idx.numpy())
    np.testing.assert_allclose(vals.numpy(), want_vals.numpy(), rtol=1e-4, atol=1e-4)
