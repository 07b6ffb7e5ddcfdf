"""The DNDarray's ``__getitem__`` and ``__setitem__`` against heat_tpu's, on
the key grid of tests/test_indexing_matrix.py and the value grid of
tests/test_setitem_crosssplit.py, for splits None, 0, 1 (and 2 for 3-D).

The port runs on one CPU rank; the reference on a one-device
Communication, so that the layouts (``lshape_map``, ``counts_displs``) are
of the same world.  Values are held bitwise, the output split and type
exactly.  The world of three (uneven remainders) is in
tests/test_torch_gloo.py."""

import jax
import numpy as np
import pytest

import heat_tpu as hj
import heat_tpu_torch as ht

RNG = np.random.default_rng(42)
BASE_3D = RNG.standard_normal((5, 7, 6)).astype(np.float32)
BASE_2D = RNG.standard_normal((9, 11)).astype(np.float32)
BASE_1D = RNG.standard_normal(13).astype(np.float32)

I0 = np.array([0, 2, 4, 1])
I1 = np.array([6, 0, 3, 3])
IN = np.array([-1, -3, 0, 2])
I2D = np.array([[0, 1], [3, 2]])
B5 = np.array([True, False, True, True, False])
B7 = np.array([False, True] * 3 + [True])
B9 = np.arange(9) % 3 == 0
B57 = RNG.random((5, 7)) > 0.5

KEYS_1D = [
    0, 5, -1, -13, slice(None), slice(2, 9), slice(None, None, 2), slice(None, None, -1), slice(10, 2, -3),
    Ellipsis, None, (None, slice(3, 7)), np.array([0, 5, 12, 5]), np.array([-1, -13, 3]), np.arange(13) % 4 == 0,
    [1, 2, 1], (Ellipsis, None),
]
KEYS_2D = [
    0, -2, (3, 4), (-1, -1), (slice(1, 7), slice(2, 10, 3)), (slice(None), 4), (2, slice(None)),
    (slice(None, None, -2), slice(None)), Ellipsis, (Ellipsis, 1), (1, Ellipsis), (None, slice(None), 2),
    (slice(None), None, slice(None)), I0[:3], (I0[:3], I1[:3]), (I0[:3], slice(2, 8)), (slice(1, 6), I1[:3]),
    (I2D, slice(None, 4)), B9, (B9, slice(None)), (slice(None), np.arange(11) % 2 == 1), (np.array(2), slice(None)),
    ([0, 3], [1, 2]), (IN[:2], IN[:2]),
]
KEYS_3D = [
    0, (1, 2, 3), (-1, -2, -3), (slice(1, 4), slice(None), slice(0, 5, 2)), (slice(None), 3, slice(None)),
    (2, slice(None), slice(None, None, -1)), Ellipsis, (Ellipsis, 2), (0, Ellipsis, 1), (slice(None), Ellipsis),
    (None, Ellipsis, None), I0, (I0, I1), (I0, I1, np.array([0, 5, 2, 2])), (I0, slice(2, 5), I1 % 6),
    (slice(None), I1, slice(1, 4)), (slice(1, 4), slice(None), I1 % 6), B5, (B5, slice(2, 6)), (slice(None), B7),
    (slice(None), slice(None), np.arange(6) % 2 == 0), B57, (I2D, I2D % 7, I2D % 6), (None, I0, slice(None), 2),
    (0, slice(None), I1 % 6), (I0, 1, slice(None)),
]
GRID = (
    [("1d", k, s) for k in KEYS_1D for s in (None, 0)]
    + [("2d", k, s) for k in KEYS_2D for s in (None, 0, 1)]
    + [("3d", k, s) for k in KEYS_3D for s in (None, 0, 1, 2)]
)
BASES = {"1d": BASE_1D, "2d": BASE_2D, "3d": BASE_3D}


@pytest.fixture(autouse=True)
def _port_on_cpu():
    ht.use_device("cpu")


@pytest.fixture(scope="module")
def one():
    """The reference's Communication of one device."""
    return hj.Communication(jax.devices()[:1])


def _same(got, want):
    """One result: type, shape, split, layout and bits."""
    assert isinstance(got, ht.DNDarray)
    assert got.dtype.__name__ == want.dtype.__name__
    assert got.shape == want.shape and got.split == want.split, (got.shape, got.split, want.shape, want.split)
    np.testing.assert_array_equal(got.lshape_map, want.lshape_map)
    if want.split is not None:
        assert got.counts_displs() == want.counts_displs()
    g, w = got.numpy(), want.numpy()
    assert g.dtype == w.dtype
    np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("case", GRID, ids=lambda c: f"{c[0]}-{repr(c[1])[:40]}-split{c[2]}")
def test_getitem_matches_reference(case, one):
    name, key, split = case
    base = BASES[name]
    want = hj.array(base, split=split, comm=one)[key]
    got = ht.array(base, split=split)[key]
    _same(got, want)


SET_KEYS_2D = [
    (0, slice(None)), (slice(2, 7), slice(1, 4)), (-1, -1), (slice(None), 3), I0[:3], (I0[:3], I1[:3] % 11), B9,
    (B9, slice(2, 6)), (slice(None), np.arange(11) % 3 == 0), (IN[:3], slice(None, 5)), ([7, 0, 2], 4),
    (slice(None, None, -2), slice(None)), (slice(8, 1, -3), slice(None, None, -4)), (0, slice(None), None),
]


@pytest.mark.parametrize("split", [None, 0, 1])
@pytest.mark.parametrize("key", SET_KEYS_2D, ids=[repr(k)[:40] for k in SET_KEYS_2D])
def test_setitem_matches_reference(key, split, one):
    """A scalar and an array of the key's shape, written in place."""
    for value in (7.5, np.full(np.shape(BASE_2D[key]), -2.0, np.float32) + np.arange(np.size(BASE_2D[key])).reshape(
            np.shape(BASE_2D[key]))):
        a, r = ht.array(BASE_2D, split=split), hj.array(BASE_2D, split=split, comm=one)
        before = a.larray_padded
        a[key] = value
        r[key] = value
        assert a.larray_padded is before  # in place
        _same(a, r)


@pytest.mark.parametrize("split", [None, 0, 1, 2])
def test_setitem_3d_advanced_on_split(split, one):
    keys = [(I0 % 5, I1, np.array([0, 5, 2, 2])), (slice(None), B7), (np.array([-1, -4]), slice(1, 5), slice(None)),
            (0, slice(None), I1 % 6)]
    for key in keys:
        a, r = ht.array(BASE_3D, split=split), hj.array(BASE_3D, split=split, comm=one)
        a[key] = 3.25
        r[key] = 3.25
        _same(a, r)


SET_VALUE_KEYS = [
    ((slice(None), slice(None)), (9, 12)), ((slice(2, 7), slice(None)), (5, 12)), ((slice(None), slice(3, 10)), (9, 7)),
    ((slice(1, 8), slice(2, 11)), (7, 9)), ((slice(0, 9, 2), slice(1, 12, 3)), (5, 4)), ((4, slice(None)), (12,)),
]


@pytest.mark.parametrize("tsplit", [None, 0, 1])
@pytest.mark.parametrize("vsplit", [None, 0, 1])
def test_setitem_distributed_values(tsplit, vsplit, one):
    """tests/test_setitem_crosssplit.py's grid: the value split otherwise
    than the target, cast on write (float64 values into float32)."""
    rng = np.random.default_rng(0)
    base = np.arange(9 * 12, dtype=np.float32).reshape(9, 12)
    for key, vshape in SET_VALUE_KEYS:
        val = rng.standard_normal(vshape)
        vs = vsplit if vsplit is None or vsplit < len(vshape) else None
        a, r = ht.array(base, split=tsplit), hj.array(base, split=tsplit, comm=one)
        a[key] = ht.array(val, split=vs)
        r[key] = hj.array(val, split=vs, comm=one)
        _same(a, r)


@pytest.mark.parametrize("tsplit", [None, 0, 1])
def test_setitem_masks_and_index_arrays_as_dndarrays(tsplit, one):
    base = np.arange(9 * 12, dtype=np.float32).reshape(9, 12)
    mask = base[:, 0] > 40.0
    val = np.full((int(mask.sum()), 12), -1.0, np.float32)
    a, r = ht.array(base, split=tsplit), hj.array(base, split=tsplit, comm=one)
    a[ht.array(mask, split=0)] = ht.array(val, split=0)
    r[hj.array(mask, split=0, comm=one)] = hj.array(val, split=0, comm=one)
    _same(a, r)
    a, r = ht.array(base, split=tsplit), hj.array(base, split=tsplit, comm=one)
    _same(a[ht.array(mask, split=0)], r[hj.array(mask, split=0, comm=one)])
    _same(a[ht.array([0, 3, 8])], r[hj.array([0, 3, 8], comm=one)])


@pytest.mark.parametrize("dtype", ["int8", "uint8", "uint16", "uint32", "uint64", "float16", "bool", "complex64"])
@pytest.mark.parametrize("split", [None, 0, 1])
def test_indexing_keeps_the_type(dtype, split, one):
    """Keys and assignments on every holding: the values and the heat type."""
    base = (np.arange(9 * 11).reshape(9, 11) * 37 % 251).astype(dtype)
    a, r = ht.array(base, split=split), hj.array(base, split=split, comm=one)
    for key in ((slice(1, 8, 3), slice(None)), (I0[:3], slice(2, 8)), B9, (slice(None), -1)):
        _same(a[key], r[key])
    a[2:5, 1] = 1
    r[2:5, 1] = 1
    _same(a, r)


def test_len_iter_contains_tolist_copy(one):
    a, r = ht.array(BASE_2D, split=0), hj.array(BASE_2D, split=0, comm=one)
    assert len(a) == len(r) == 9
    for got, want in zip(a, r):
        _same(got, want)
    assert float(BASE_2D[3, 4]) in a and 123.0 not in a and "x" not in a
    assert a.tolist() == r.tolist()
    c = a.copy()
    c[0] = 0.0
    assert a.numpy()[0, 0] == BASE_2D[0, 0] and c.split == a.split
    with pytest.raises(TypeError):
        len(ht.array(1.0))
    assert complex(ht.array(2.5)) == complex(hj.array(2.5)) == 2.5 + 0j


def test_getitem_returns_a_copy():
    """A slice is a new array, never a view of the indexed one."""
    a = ht.array(BASE_2D, split=0)
    b = a[1:3]
    b[0] = 100.0
    assert a.numpy()[1, 0] == BASE_2D[1, 0]


def test_out_of_bounds_keys_raise():
    a = ht.array(BASE_2D, split=0)
    for key in (9, -10, (0, 11), np.array([0, 9]), (Ellipsis, Ellipsis), (0, 0, 0)):
        with pytest.raises(IndexError):
            a[key]
