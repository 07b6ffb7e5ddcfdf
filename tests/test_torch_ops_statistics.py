"""The port's statistics.py against heat_tpu's: argmax and argmin (ties,
NaN, keepdims, ``out=``), min, max, mean, maximum, minimum, average, var,
std, skew, kurtosis, cov, bincount, histogram, histc, digitize and
bucketize, over the splits None/0/1 and the types each takes; integer
results bitwise, float results within the reference's own bounds.
percentile and median (the sort's route) in test_torch_sort_percentile.py."""

import numpy as np
import pytest

import heat_tpu as hj
import heat_tpu_torch as ht
from torch_parity import SPLITS, both, data, same, same_outcome


@pytest.fixture(autouse=True)
def _port_on_cpu():
    ht.use_device("cpu")


ARG_TYPES = ["bool", "int8", "int32", "int64", "float32", "float64"]


@pytest.mark.parametrize("name", ["argmax", "argmin"])
@pytest.mark.parametrize("dtype", ARG_TYPES)
def test_arg_reductions_match_reference(name, dtype):
    a = data(dtype, shape=(7, 5), seed=1)
    if dtype.startswith("int"):
        a = (a % 3).astype(dtype)  # many ties
    for split in SPLITS:
        p, r = both(a, split)
        for axis, keepdims in ((None, False), (0, split == 0), (1, split != 0), (None, True)):
            same(getattr(ht, name)(p, axis=axis, keepdims=keepdims),
                 getattr(hj, name)(r, axis=axis, keepdims=keepdims))
        same(getattr(p, name)(0), getattr(r, name)(0))


def test_arg_reductions_with_nan_are_the_references():
    a = np.array([[1.0, np.nan, 3.0, np.nan], [5.0, 2.0, np.nan, -1.0], [7.0, 7.0, 0.5, -1.0]], np.float32)
    for split in SPLITS:
        p, r = both(a, split)
        for name in ("argmax", "argmin"):
            for axis in (None, 0, 1):
                same(getattr(ht, name)(p, axis=axis), getattr(hj, name)(r, axis=axis))
    p, r = both(np.array([1.0, np.nan, 3.0, np.nan]), 0)
    assert int(ht.argmax(p)) == int(hj.argmax(r)) == 1
    assert int(ht.argmin(p)) == int(hj.argmin(r)) == 1


def test_arg_reduction_out_matches_reference():
    a = data("float32", shape=(7, 5), seed=2)
    for split in SPLITS:
        p, r = both(a, split)
        po, ro = both(np.zeros(5, np.int64), None)
        assert ht.argmax(p, 0, out=po) is po
        hj.argmax(r, 0, out=ro)
        same(po, ro)


@pytest.mark.parametrize("dtype", ARG_TYPES)
def test_min_max_mean_match_reference(dtype):
    a = data(dtype, shape=(7, 5), seed=3)
    for split in SPLITS:
        p, r = both(a, split)
        for axis, keepdims in ((None, False), (0, split == 0), (1, split == 1), ((0, 1), False)):
            for name in ("min", "max", "mean"):
                same_outcome(lambda m, x: getattr(m, name)(x, axis=axis, keepdims=keepdims), (p,), (r,))
        po, ro = both(np.zeros(5, a.dtype), None)
        ht.max(p, 0, out=po)
        hj.max(r, 0, out=ro)
        same(po, ro)


@pytest.mark.parametrize("dtype", ARG_TYPES)
def test_maximum_minimum_match_reference(dtype):
    a, b = data(dtype, seed=4), data(dtype, seed=5)
    if dtype.startswith("float"):
        a[0, 0] = np.nan
    for split in SPLITS:
        pa, ra = both(a, split)
        pb, rb = both(b, split)
        same(ht.maximum(pa, pb), hj.maximum(ra, rb))
        same(ht.minimum(pa, pb), hj.minimum(ra, rb))
        po, ro = both(np.zeros(a.shape, np.float64), split)
        ht.minimum(pa, pb, out=po)
        hj.minimum(ra, rb, out=ro)
        same(po, ro)


@pytest.mark.parametrize("dtype", ["int32", "float32", "float64", "complex64"])
def test_var_std_match_reference(dtype):
    a = data(dtype, shape=(9, 6), seed=6) + (3 if not dtype.startswith("int") else 0)
    a = a.astype(dtype)
    for split in SPLITS:
        p, r = both(a, split)
        for axis, ddof, keepdims in ((None, 0, False), (0, 1, split == 0), (1, 0, split == 1), ((0, 1), 1, False)):
            for name in ("var", "std"):
                same(getattr(ht, name)(p, axis, ddof=ddof, keepdims=keepdims),
                     getattr(hj, name)(r, axis, ddof=ddof, keepdims=keepdims))
        same(p.var(0, ddof=1), r.var(0, ddof=1))
        same(p.std(), r.std())
    p, _ = both(a, 0)
    for bad, exc in (({"ddof": -1}, ValueError), ({"ddof": 1.5}, ValueError), ({"bias": True}, TypeError)):
        with pytest.raises(exc):
            ht.var(p, **bad)


def test_average_matches_reference():
    a = data("float64", shape=(6, 5), seed=7)
    w_full = np.abs(data("float64", shape=(6, 5), seed=8)) + 0.1
    w_row = np.abs(data("float64", shape=(5,), seed=9)) + 0.1
    for split in SPLITS:
        p, r = both(a, split)
        same(ht.average(p), hj.average(r))
        same(ht.average(p, axis=0), hj.average(r, axis=0))
        same(ht.average(p, axis=1, returned=True), hj.average(r, axis=1, returned=True))
        same(ht.average(p, weights=ht.array(w_full, split=split)), hj.average(r, weights=hj.array(w_full, split=split)))
        same(ht.average(p, axis=1, weights=w_row, returned=True), hj.average(r, axis=1, weights=w_row, returned=True))
        same(ht.average(p, axis=0, weights=ht.array(w_full), returned=True),
             hj.average(r, axis=0, weights=hj.array(w_full), returned=True))
        with pytest.raises(TypeError):
            ht.average(p, weights=w_row)


@pytest.mark.parametrize("name", ["skew", "kurtosis"])
def test_skew_kurtosis_match_reference(name):
    a = data("float64", shape=(9, 6), seed=10) ** 2
    for split in SPLITS:
        p, r = both(a, split)
        for axis in (None, 0, 1):
            for unbiased in (True, False):
                same(getattr(ht, name)(p, axis, unbiased), getattr(hj, name)(r, axis, unbiased))
        if name == "kurtosis":
            same(ht.kurtosis(p, 0, Fisher=False), hj.kurtosis(r, 0, Fisher=False))


@pytest.mark.parametrize("dtype", ["int32", "float32", "float64", "complex64"])
def test_cov_matches_reference(dtype):
    m = data(dtype, shape=(4, 9), seed=11)
    y = data(dtype, shape=(2, 9), seed=12)
    for split in SPLITS:
        p, r = both(m, split)
        same(ht.cov(p), hj.cov(r))
        same(ht.cov(p, rowvar=False), hj.cov(r, rowvar=False))
        same(ht.cov(p, bias=True), hj.cov(r, bias=True))
        same(ht.cov(p, ddof=3), hj.cov(r, ddof=3))
        py, ry = both(y, split)
        same(ht.cov(p, py), hj.cov(r, ry))
    for split in (None, 0):
        p, r = both(m[0], split)
        same(ht.cov(p), hj.cov(r))
    with pytest.raises(ValueError):
        ht.cov(ht.zeros((2, 2, 2)))


def test_bincount_matches_reference():
    x = np.random.default_rng(13).integers(0, 11, 203).astype(np.int64)
    w32 = data("float32", shape=(203,), seed=14)
    for split in (None, 0):
        p, r = both(x, split)
        same(ht.bincount(p), hj.bincount(r))
        same(ht.bincount(p, minlength=20), hj.bincount(r, minlength=20))
        for w in (w32, w32.astype(np.float64), (x % 4).astype(np.int32)):
            pw, rw = both(w, split)
            same(ht.bincount(p, weights=pw), hj.bincount(r, weights=rw))
    neg = np.array([0, 2, -1, 2, -5], np.int32)
    same(ht.bincount(ht.array(neg, split=0)), hj.bincount(hj.array(neg, split=0)))
    with pytest.raises(ValueError):
        ht.bincount(ht.array(np.zeros((2, 2), np.int32)))


@pytest.mark.parametrize("dtype", ["int32", "float32", "float64"])
def test_histogram_matches_reference(dtype):
    a = data(dtype, shape=(13, 4), seed=15)
    w = np.abs(data("float32", shape=(13, 4), seed=16))
    for split in SPLITS:
        p, r = both(a, split)
        for bins in (1, 6, 7, 64):
            # the edges within the type's bounds (XLA fuses a few of its
            # linspace's samples otherwise than the port emulates, one
            # rounding apart), the counts exactly the reference's over the
            # port's edges
            hist, edges = ht.histogram(p, bins=bins)
            same(edges, hj.histogram(r, bins=bins)[1])
            same(hist, hj.histogram(r, bins=edges.numpy())[0])
        same(ht.histogram(p, bins=5, range=(-1.0, 2.0)), hj.histogram(r, bins=5, range=(-1.0, 2.0)))
        same(ht.histogram(p, bins=np.array([-3.0, -1.0, 0.0, 0.5, 4.0])),
             hj.histogram(r, bins=np.array([-3.0, -1.0, 0.0, 0.5, 4.0])))
        edges = ht.histogram(p, bins=6)[1].numpy()
        same(ht.histogram(p, bins=edges, density=True), hj.histogram(r, bins=edges, density=True))
        pw, rw = both(w, split)
        same(ht.histogram(p, bins=edges, weights=pw), hj.histogram(r, bins=edges, weights=rw))
    constant = np.full((5, 3), 2.0, dtype)
    p, r = both(constant, 0)
    same(ht.histogram(p, bins=4), hj.histogram(r, bins=4))


@pytest.mark.parametrize("dtype", ["int32", "float32", "float64"])
def test_histc_matches_reference(dtype):
    a = data(dtype, shape=(13, 4), seed=17)
    for split in SPLITS:
        p, r = both(a, split)
        same(ht.histc(p, bins=10), hj.histc(r, bins=10))
        same(ht.histc(p, bins=7, min=-1.0, max=2.0), hj.histc(r, bins=7, min=-1.0, max=2.0))


def test_digitize_bucketize_match_reference():
    a = data("float32", shape=(7, 5), seed=18)
    inc = np.array([-1.0, -0.25, 0.0, 0.5, 2.0])
    for split in SPLITS:
        p, r = both(a, split)
        for bins in (inc, inc[::-1], np.array([], np.float64)):
            for right in (False, True):
                same(ht.digitize(p, bins, right=right), hj.digitize(r, bins, right=right))
        for right in (False, True):
            for out_int32 in (False, True):
                same(ht.bucketize(p, inc, out_int32=out_int32, right=right),
                     hj.bucketize(r, inc, out_int32=out_int32, right=right))
        same(ht.digitize(p, ht.array(inc)), hj.digitize(r, hj.array(inc)))


def test_percentile_and_median_wait_for_the_sort():
    """percentile and median ride the sort now: the reference's values."""
    p, r = ht.array(np.arange(10.0), split=0), hj.array(np.arange(10.0), split=0)
    same(ht.percentile(p, 50), hj.percentile(r, 50))
    same(ht.median(p), hj.median(r))
    same(p.median(), r.median())
