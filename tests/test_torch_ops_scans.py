"""The port's scans, differences and reductions of arithmetics.py against
heat_tpu's: cumsum, cumprod (and cumproduct), nancumsum, nancumprod, sum,
prod, nansum, nanprod, diff, ediff1d, gradient, trapz (and trapezoid),
interp and trigonometrics.unwrap, over the splits None/0/1, the axes
(the split one included) and the types each takes, with ``out=``,
``dtype=`` and ``keepdims``."""

import numpy as np
import pytest

import heat_tpu as hj
import heat_tpu_torch as ht
from torch_parity import SPLITS, both, data, same, same_outcome


@pytest.fixture(autouse=True)
def _port_on_cpu():
    ht.use_device("cpu")


SCAN_TYPES = ["bool", "int8", "int32", "int64", "float32", "float64", "complex64"]


@pytest.mark.parametrize("name", ["cumsum", "cumprod", "cumproduct", "nancumsum", "nancumprod"])
@pytest.mark.parametrize("dtype", SCAN_TYPES)
def test_scans_match_reference(name, dtype):
    a = data(dtype, shape=(7, 5), seed=3)
    if "prod" in name and dtype.startswith("float"):
        a = (np.sign(a) * (np.abs(a) % 1.5 + 0.5)).astype(dtype)
    if name.startswith("nan") and dtype.startswith("float"):
        a = a.copy()
        a[1, 2] = a[4, 0] = np.nan
    for split in SPLITS:
        for axis in (0, 1) if split is not None else (-1,):
            p, r = both(a, split)
            same_outcome(lambda m, x: getattr(m, name)(x, axis), (p,), (r,))


def test_scan_dtype_and_out_match_reference():
    a = data("int8", shape=(9, 4), seed=4) * 13  # int8 sums wrap
    for split in SPLITS:
        p, r = both(a.astype("int8"), split)
        for axis in (0, 1):
            same(ht.cumsum(p, axis), hj.cumsum(r, axis))
            same(ht.cumsum(p, axis, dtype=ht.int64), hj.cumsum(r, axis, dtype=hj.int64))
            same(p.cumsum(axis), r.cumsum(axis))
            same(p.cumprod(axis, dtype=ht.float64), r.cumprod(axis, dtype=hj.float64))
            po, ro = both(np.zeros(a.shape, np.float32), split)
            assert ht.cumsum(p, axis, out=po) is po
            hj.cumsum(r, axis, out=ro)
            same(po, ro)


def test_scan_of_a_vector_matches_reference():
    for dtype in ("float32", "float64", "int32"):
        a = data(dtype, shape=(1003,), seed=5)
        for split in (None, 0):
            p, r = both(a, split)
            same(ht.cumsum(p, 0), hj.cumsum(r, 0), rtol=1e-5 if dtype == "float32" else None, atol=1e-4
                 if dtype == "float32" else None)


@pytest.mark.parametrize("name", ["sum", "prod", "nansum", "nanprod"])
@pytest.mark.parametrize("dtype", SCAN_TYPES + ["uint8"])
def test_reductions_match_reference(name, dtype):
    a = data(dtype, shape=(6, 5), seed=6)
    if "prod" in name and dtype.startswith("float"):
        a = (np.sign(a) * (np.abs(a) % 1.5 + 0.5)).astype(dtype)
    if name.startswith("nan") and dtype.startswith("float"):
        a = a.copy()
        a[2, 3] = np.nan
    for split in SPLITS:
        p, r = both(a, split)
        for axis, keepdims in ((None, False), (0, False), (1, True), ((0, 1), split == 0)):
            same_outcome(lambda m, x: getattr(m, name)(x, axis=axis, keepdims=keepdims), (p,), (r,))
    p, r = both(a, 0)
    if dtype == "float32":
        po, ro = both(np.zeros(5, np.float32), None)
        getattr(ht, name)(p, axis=0, out=po)
        getattr(hj, name)(r, axis=0, out=ro)
        same(po, ro)
        same(getattr(p, name)(0) if name in ("sum", "prod") else po, getattr(r, name)(0) if name in ("sum", "prod")
             else ro)


@pytest.mark.parametrize("dtype", ["bool", "int8", "int32", "uint8", "float32", "float64", "complex64"])
def test_diff_matches_reference(dtype):
    a = data(dtype, shape=(9, 6), seed=7)
    for split in SPLITS:
        for axis in (0, 1):
            for n in (0, 1, 3) if split == axis else (1, 2):
                p, r = both(a, split)
                same_outcome(lambda m, x: m.diff(x, n=n, axis=axis), (p,), (r,))


def test_diff_edges_match_reference():
    a = data("float32", shape=(9, 6), seed=8)
    for split in SPLITS:
        for axis in (0, 1):
            p, r = both(a, split)
            row = np.ones((1, 6) if axis == 0 else (9, 1), np.float32)
            same(ht.diff(p, axis=axis, prepend=2.5), hj.diff(r, axis=axis, prepend=2.5))
            same(ht.diff(p, axis=axis, append=row, prepend=row), hj.diff(r, axis=axis, append=row, prepend=row))
            same(ht.diff(p, n=2, axis=axis, append=ht.array(row)), hj.diff(r, n=2, axis=axis, append=hj.array(row)))


def test_ediff1d_matches_reference():
    for shape in ((11,), (5, 3)):
        a = data("float64", shape=shape, seed=9)
        for split in [None, 0] + ([1] if len(shape) == 2 else []):
            p, r = both(a, split)
            same(ht.ediff1d(p), hj.ediff1d(r))
            end = np.array([7.0, 8.0])
            same(ht.ediff1d(p, to_end=end, to_begin=-1.0), hj.ediff1d(r, to_end=end, to_begin=-1.0))
    p, r = both(data("int32", shape=(10,), seed=10), 0)
    same(ht.ediff1d(p, to_begin=np.array([5])), hj.ediff1d(r, to_begin=np.array([5])))


@pytest.mark.parametrize("dtype", ["int32", "float32", "float64"])
def test_gradient_matches_reference(dtype):
    a = data(dtype, shape=(7, 5), seed=11)
    for split in SPLITS:
        p, r = both(a, split)
        same(ht.gradient(p), hj.gradient(r))
        same(ht.gradient(p, axis=0), hj.gradient(r, axis=0))
        same(ht.gradient(p, 2.0, axis=1), hj.gradient(r, 2.0, axis=1))
        same(ht.gradient(p, 0.5, 3.0), hj.gradient(r, 0.5, 3.0))


@pytest.mark.parametrize("name", ["trapz", "trapezoid"])
def test_trapz_matches_reference(name):
    for dtype in ("int32", "float32", "float64"):
        a = data(dtype, shape=(7, 5), seed=12)
        for split in SPLITS:
            for axis in (0, 1, -1):
                p, r = both(a, split)
                same(getattr(ht, name)(p, axis=axis), getattr(hj, name)(r, axis=axis))
                same(getattr(ht, name)(p, dx=0.25, axis=axis), getattr(hj, name)(r, dx=0.25, axis=axis))
                pts = np.cumsum(np.arange(1, a.shape[axis] + 1)).astype(np.float64)
                same(getattr(ht, name)(p, x=pts, axis=axis), getattr(hj, name)(r, x=pts, axis=axis))


def test_interp_matches_reference():
    xp = np.array([0.0, 1.0, 2.5, 4.0, 4.0, 7.0])
    fp = np.array([1.0, -2.0, 3.0, 0.5, 9.0, 2.0])
    q = np.linspace(-1.5, 8.5, 35).reshape(7, 5)
    for dtype in ("float32", "float64"):
        for split in SPLITS:
            p, r = both(q.astype(dtype), split)
            same(ht.interp(p, xp, fp), hj.interp(r, xp, fp))
            same(ht.interp(p, xp, fp, left=-7.0, right=11.0), hj.interp(r, xp, fp, left=-7.0, right=11.0))
            same(ht.interp(p, xp[:4], fp[:4], period=3.0), hj.interp(r, xp[:4], fp[:4], period=3.0))


def test_unwrap_matches_reference():
    rng = np.random.default_rng(13)
    phase = np.cumsum(rng.uniform(-2.0, 2.5, (23, 4)), axis=0)
    wrapped = np.angle(np.exp(1j * phase))
    for dtype in ("float32", "float64", "int32"):
        a = (wrapped * 10).astype(dtype) if dtype == "int32" else wrapped.astype(dtype)
        for split in SPLITS:
            for axis in (0, 1):
                p, r = both(a, split)
                same(ht.unwrap(p, axis=axis), hj.unwrap(r, axis=axis))
                same(ht.unwrap(p, axis=axis, period=4.0), hj.unwrap(r, axis=axis, period=4.0))
                same(ht.unwrap(p, discont=4.0, axis=axis), hj.unwrap(r, discont=4.0, axis=axis))
