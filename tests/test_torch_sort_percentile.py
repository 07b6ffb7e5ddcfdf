"""The port's sort, sample sort, percentile and median against heat_tpu's on
a world of one: percentile and median over the types, splits, axes,
interpolations and keepdims (floats within the reference's bounds,
integer inputs in float32 as the reference's dense route has them), the
sketched draw, and the sample sort's own order (-0.0 below +0.0, every NaN
last, ties by index) and its rank selection bitwise against the
reference's, run here on one rank.  The gloo world of three
(tests/test_torch_gloo_sort_io.py) runs the sample sort across ranks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import heat_tpu as hj
import heat_tpu_torch as ht
from heat_tpu.core import sample_sort as ref_sort
from heat_tpu_torch.core import sample_sort, statistics
from torch_parity import DTYPES, SPLITS, data, same, same_outcome


@pytest.fixture(autouse=True)
def world_of_one():
    ht.use_device("cpu")
    saved = hj.get_comm()
    hj.use_comm(hj.Communication(jax.devices()[:1]))
    try:
        yield
    finally:
        hj.use_comm(saved)


METHODS = ["linear", "lower", "higher", "midpoint", "nearest"]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("method", METHODS)
def test_percentile_matches_reference(dtype, method):
    a = data(dtype, shape=(7, 6), seed=12)
    for split in SPLITS:
        for axis, q, keepdims in ((None, 50, False), (0, [10, 25, 50, 99.5], False), (1, 30.0, True),
                                  ((0, 1), [0, 100], False), (0, 75, True), (None, [33.3], True)):
            same_outcome(lambda m, x: m.percentile(x, q, axis=axis, interpolation=method, keepdims=keepdims),
                         [ht.array(a, split=split)], [hj.array(a, split=split)])


@pytest.mark.parametrize("dtype", DTYPES)
def test_median_matches_reference(dtype):
    a = data(dtype, shape=(6, 5), seed=13)
    for split in SPLITS:
        for axis, keepdims in ((None, False), (0, False), (1, True), (0, True)):
            same_outcome(lambda m, x: m.median(x, axis=axis, keepdims=keepdims), [ht.array(a, split=split)],
                         [hj.array(a, split=split)])
        same_outcome(lambda m, x: x.median(0), [ht.array(a, split=split)], [hj.array(a, split=split)])


def test_percentile_and_median_wait_for_the_sort():
    """percentile and median ride the sort now: a 1-D array, its NaNs
    propagated, and the reference's tie rule of "nearest" on its dense
    route (``jnp.percentile`` rounds half down where numpy rounds half to
    even)."""
    p, r = ht.array(np.arange(10.0), split=0), hj.array(np.arange(10.0), split=0)
    same(ht.percentile(p, 50), hj.percentile(r, 50))
    same(ht.median(p), hj.median(r))
    same(p.median(), r.median())
    four = np.array([0.0, 1.0, 2.0, 3.0])
    got = float(ht.percentile(ht.array(four), 50, interpolation="nearest"))
    assert got == float(hj.percentile(hj.array(four), 50, interpolation="nearest")) == 1.0
    nan = np.array([1.0, np.nan, 3.0, 4.0], np.float32)
    for split in (None, 0):
        same(ht.percentile(ht.array(nan, split=split), [10, 90]), hj.percentile(hj.array(nan, split=split), [10, 90]))
    with_nan = np.array([[1.0, np.nan], [2.0, 5.0], [3.0, 6.0]], np.float32)
    for split in SPLITS:
        same(ht.median(ht.array(with_nan, split=split), axis=0), hj.median(hj.array(with_nan, split=split), axis=0))


def test_percentile_refusals_and_out_match_reference():
    a = data("float32", shape=(5, 4), seed=14)
    for split in SPLITS:
        p, r = ht.array(a, split=split), hj.array(a, split=split)
        for q in (-1, 101, [50, np.nan]):
            same_outcome(lambda m, x: m.percentile(x, q), [p], [r])
        same_outcome(lambda m, x: m.percentile(x, 50, interpolation="cubic"), [p], [r])
        po, ro = ht.zeros((4,), dtype=ht.float64), hj.zeros((4,), dtype=hj.float64)
        assert ht.percentile(p, 40, axis=0, out=po) is po
        hj.percentile(r, 40, axis=0, out=ro)
        same(po, ro)


@pytest.mark.parametrize("axis", [None, 0, 1])
def test_sketched_percentile_draws_the_references_sample(axis):
    a = data("float32", shape=(40, 3000), seed=15) if axis == 1 else data("float32", shape=(3000, 3), seed=15)
    a = a if axis is not None else data("float32", shape=(1500, 2), seed=15)
    for split in SPLITS:
        ht.random.seed(21)
        hj.random.seed(21)
        got = ht.percentile(ht.array(a, split=split), [20, 80], axis=axis, sketched=True, sketch_size=1100)
        want = hj.percentile(hj.array(a, split=split), [20, 80], axis=axis, sketched=True, sketch_size=1100)
        same(got, want)


def _keys_order(x: np.ndarray, descending: bool) -> np.ndarray:
    """The reference's sample-sort order as a stable argsort of numpy keys:
    -0.0 below +0.0, every NaN last."""
    if x.dtype.kind == "f":
        bits = x.view(np.int32 if x.dtype == np.float32 else np.int64)
        key = bits ^ ((bits >> (bits.itemsize * 8 - 1)) & np.iinfo(bits.dtype).max)
        key = np.where(np.isnan(x), np.iinfo(bits.dtype).max, key)
    else:
        key = x.astype(np.int64)
    return np.argsort(~key if descending else key, axis=0, kind="stable")


@pytest.mark.parametrize("dtype", ["float32", "float64", "int32", "int64"])
@pytest.mark.parametrize("descending", [False, True])
def test_sample_sort_order_is_the_references(dtype, descending):
    rng = np.random.default_rng(16)
    x = (rng.integers(-3, 4, (41, 3)) * 0.5).astype(dtype)
    if dtype.startswith("float"):
        x[::5, 0], x[1::7, 1], x[2::9, 2] = np.nan, -0.0, 0.0
    v, i = sample_sort.sample_sort_1d(ht.array(x, split=0), descending)
    rv, ri = ref_sort.sample_sort_1d(hj.array(x, split=0), descending)
    want = _keys_order(x, descending)
    np.testing.assert_array_equal(i.numpy(), want)
    np.testing.assert_array_equal(i.numpy(), ri.numpy())
    np.testing.assert_array_equal(v.numpy().view(np.uint8), np.asarray(rv.numpy()).view(np.uint8))
    assert v.split == i.split == 0 and i.dtype == ht.int64
    vt, it = sample_sort.sample_sort_along(ht.array(x.T.copy(), split=1), 1, descending)
    np.testing.assert_array_equal(it.numpy(), want.T)
    assert vt.split == 1


def test_select_global_ranks_and_the_split_axis_quantile():
    x = data("float64", shape=(23,), seed=17)
    v, _ = sample_sort.sample_sort_1d(ht.array(x, split=0))
    pos = [0, 5, 22, 11]
    np.testing.assert_array_equal(sample_sort.select_global_ranks(v, pos).numpy(), np.sort(x)[pos])
    a = data("float32", shape=(9, 4), seed=18)
    a[3, 1] = np.nan
    q = torch.tensor([0.1, 0.5, 0.77], dtype=torch.float64)
    for method in METHODS:
        got = statistics._quantile_split_axis(ht.array(a, split=0), q, 0, method)
        want = jnp.percentile(jnp.asarray(a), jnp.asarray(q.numpy() * 100), axis=0, method=method)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-5, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "int32", "float64"])
def test_sort_and_percentile_of_large_extents_match_reference(dtype):
    """An extent past the sample sort's threshold on a world of one: the
    dense route in both packages, the indices bitwise."""
    x = data(dtype, shape=(1 << 17,), seed=19)
    for split in (None, 0):
        p, r = ht.array(x, split=split), hj.array(x, split=split)
        got, want = ht.sort(p), hj.sort(r)
        np.testing.assert_array_equal(got[1].numpy(), want[1].numpy())
        same(got[0], want[0])
        same(ht.percentile(p, [1, 50, 99.9]), hj.percentile(r, [1, 50, 99.9]))
