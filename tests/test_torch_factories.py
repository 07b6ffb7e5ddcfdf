"""Every factory of the port against heat_tpu's, with ``dtype`` and
``split``, and ``array``'s keywords (``copy``, ``ndmin``, ``order``,
``is_split``).  The port runs on one CPU rank, the reference on a
one-device Communication: the type, shape, split, layout and values are
held equal (bitwise; ``logspace``/``geomspace`` within the reference's own
test tolerance, rtol 1e-6, as the power is torch's ``pow`` against XLA's).
``linspace`` follows the reference's compiled formula: bitwise in float32,
in float64 within one rounding of the larger bound (2^-52 max |bound|).  Each
factory builds only its rank's chunk: the gloo world of three checks the
chunks (tests/test_torch_gloo.py)."""

import jax
import numpy as np
import pytest

import heat_tpu as hj
import heat_tpu_torch as ht


@pytest.fixture(autouse=True)
def _port_on_cpu():
    ht.use_device("cpu")


@pytest.fixture(scope="module")
def one():
    return hj.Communication(jax.devices()[:1])


def _same(got, want, rtol=0.0):
    assert isinstance(got, ht.DNDarray)
    assert got.dtype.__name__ == want.dtype.__name__, (got.dtype, want.dtype)
    assert got.shape == want.shape and got.split == want.split
    np.testing.assert_array_equal(got.lshape_map, want.lshape_map)
    g, w = got.numpy(), np.asarray(want.numpy())
    if want.dtype.__name__ == "bfloat16":
        w = w.astype(np.float32)
    if rtol:
        np.testing.assert_allclose(g, w, rtol=rtol)
    else:
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


DTYPES = [None, "bool", "int8", "int32", "int64", "uint8", "uint16", "uint32", "uint64", "float16", "bfloat16",
          "float32", "float64", "complex64"]


def _dt(pkg, name):
    return None if name is None else getattr(pkg, name)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("split", [None, 0, 1])
def test_shape_factories(dtype, split, one):
    shape = (7, 5)
    for name in ("zeros", "ones"):
        _same(getattr(ht, name)(shape, dtype=_dt(ht, dtype), split=split),
              getattr(hj, name)(shape, dtype=_dt(hj, dtype), split=split, comm=one))
    for fill in (3, 2.5, True):
        if dtype is None or dtype == "bool" or not (isinstance(fill, float) and "int" in dtype):
            _same(ht.full(shape, fill, dtype=_dt(ht, dtype), split=split),
                  hj.full(shape, fill, dtype=_dt(hj, dtype), split=split, comm=one))
    e = ht.empty(shape, dtype=_dt(ht, dtype), split=split)
    r = hj.empty(shape, dtype=_dt(hj, dtype), split=split, comm=one)
    assert e.dtype.__name__ == r.dtype.__name__ and e.shape == r.shape and e.split == r.split
    base_p = ht.zeros(shape, dtype=ht.int16, split=split)
    base_r = hj.zeros(shape, dtype=hj.int16, split=split, comm=one)
    _same(ht.zeros_like(base_p, dtype=_dt(ht, dtype)), hj.zeros_like(base_r, dtype=_dt(hj, dtype)))
    _same(ht.ones_like(base_p, dtype=_dt(ht, dtype)), hj.ones_like(base_r, dtype=_dt(hj, dtype)))
    _same(ht.full_like(base_p, 4, dtype=_dt(ht, dtype)), hj.full_like(base_r, 4, dtype=_dt(hj, dtype)))
    like = ht.empty_like(base_p, dtype=_dt(ht, dtype))
    assert like.dtype.__name__ == (dtype or "int16") and like.split == split


def test_full_of_unsigned_extremes(one):
    for name, value in (("uint64", 2**64 - 1), ("uint64", 2**63), ("uint32", 2**32 - 1), ("uint16", 65535)):
        _same(ht.full((3,), value, dtype=getattr(ht, name), split=0),
              hj.full((3,), value, dtype=getattr(hj, name), split=0, comm=one))


@pytest.mark.parametrize("split", [None, 0, 1])
@pytest.mark.parametrize("dtype", [None, "int32", "float64", "bool", "uint16"])
def test_eye_identity(split, dtype, one):
    for shape in (5, (4, 7), (7, 4), (1,)):
        _same(ht.eye(shape, dtype=_dt(ht, dtype), split=split), hj.eye(shape, dtype=_dt(hj, dtype), split=split,
                                                                     comm=one))
    _same(ht.identity(6, dtype=_dt(ht, dtype), split=split), hj.identity(6, dtype=_dt(hj, dtype), split=split,
                                                                         comm=one))


@pytest.mark.parametrize("split", [None, 0])
@pytest.mark.parametrize("args", [(10,), (2, 11), (3, 20, 4), (10, 0, -3), (0.5, 4.0, 0.25), (-2.0, 3)])
def test_arange(split, args, one):
    _same(ht.arange(*args, split=split), hj.arange(*args, split=split, comm=one))
    for dtype in ("int64", "float64", "uint8"):
        if dtype == "uint8" and min(args) < 0:
            continue
        _same(ht.arange(*args, dtype=getattr(ht, dtype), split=split),
              hj.arange(*args, dtype=getattr(hj, dtype), split=split, comm=one))


@pytest.mark.parametrize("split", [None, 0])
@pytest.mark.parametrize("args", [(0.0, 1.0, 11), (-3.0, 7.5, 50), (2.0, -1.0, 7), (0.0, 1.0, 1), (1, 1000, 333),
                                  (0.1, 0.7, 4096)])
@pytest.mark.parametrize("endpoint", [True, False])
def test_linspace_follows_the_reference_formula(split, args, endpoint, one):
    start, stop, num = args
    _same(ht.linspace(start, stop, num, endpoint=endpoint, split=split),
          hj.linspace(start, stop, num, endpoint=endpoint, split=split, comm=one))
    # float64: within a rounding of the bounds where XLA fuses otherwise
    got = ht.linspace(start, stop, num, endpoint=endpoint, dtype=ht.float64, split=split)
    want = hj.linspace(start, stop, num, endpoint=endpoint, dtype=hj.float64, split=split, comm=one)
    assert got.dtype is ht.float64 and got.split == want.split
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=2**-52 * max(abs(start), abs(stop)))
    got, gstep = ht.linspace(start, stop, num, endpoint=endpoint, retstep=True, split=split)
    want, wstep = hj.linspace(start, stop, num, endpoint=endpoint, retstep=True, split=split, comm=one)
    np.testing.assert_equal(gstep, wstep)


@pytest.mark.parametrize("split", [None, 0])
def test_logspace_geomspace(split, one):
    for args, kw in (((0.0, 3.0, 7), {}), ((1.0, 2.0, 5), {"base": 2.0}), ((-1.0, 1.0, 9), {"endpoint": False})):
        _same(ht.logspace(*args, split=split, **kw), hj.logspace(*args, split=split, comm=one, **kw), rtol=1e-6)
    for start, stop in ((1.0, 1000.0), (-2.0, -64.0), (0.5, 8.0)):
        _same(ht.geomspace(start, stop, 6, split=split), hj.geomspace(start, stop, 6, split=split, comm=one),
              rtol=1e-6)
        _same(ht.geomspace(start, stop, 6, dtype=ht.float64, split=split),
              hj.geomspace(start, stop, 6, dtype=hj.float64, split=split, comm=one), rtol=1e-6)
    with pytest.raises(ValueError):
        ht.geomspace(0.0, 1.0, 3)
    with pytest.raises(ValueError):
        ht.geomspace(-1.0, 1.0, 3)


@pytest.mark.parametrize("indexing", ["xy", "ij"])
@pytest.mark.parametrize("splits", [(None, None), (0, None), (None, 0)])
def test_meshgrid(indexing, splits, one):
    x, y = np.arange(5, dtype=np.float32), np.arange(3, dtype=np.int32) * 2
    got = ht.meshgrid(ht.array(x, split=splits[0]), ht.array(y, split=splits[1]), indexing=indexing)
    want = hj.meshgrid(hj.array(x, split=splits[0], comm=one), hj.array(y, split=splits[1], comm=one),
                       indexing=indexing)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        _same(g, w)
    assert ht.meshgrid() == []


@pytest.mark.parametrize("split", [None, 0, 1])
def test_fromfunction(split, one):
    _same(ht.fromfunction(lambda i, j: i * 10 + j, (4, 6), split=split),
          hj.fromfunction(lambda i, j: i * 10 + j, (4, 6), split=split, comm=one))
    _same(ht.fromfunction(lambda i, j: i == j, (5, 5), split=split),
          hj.fromfunction(lambda i, j: i == j, (5, 5), split=split, comm=one))
    _same(ht.fromfunction(lambda i, j: i + j, (3, 4), dtype=ht.float32, split=split),
          hj.fromfunction(lambda i, j: i + j, (3, 4), dtype=hj.float32, split=split, comm=one))


@pytest.mark.parametrize("split", [None, 0])
def test_fromiter_frombuffer_fromstring(split, one):
    _same(ht.fromiter(iter(range(7)), ht.int64, split=split),
          hj.fromiter(iter(range(7)), hj.int64, split=split, comm=one))
    _same(ht.fromiter((x * 0.5 for x in range(5)), ht.float32, count=3, split=split),
          hj.fromiter((x * 0.5 for x in range(5)), hj.float32, count=3, split=split, comm=one))
    buf = np.arange(10, dtype=np.float32).tobytes()
    _same(ht.frombuffer(buf, ht.float32, count=6, offset=8, split=split),
          hj.frombuffer(buf, hj.float32, count=6, offset=8, split=split, comm=one))
    _same(ht.fromstring("1 2 3 4 5", ht.int32, sep=" ", split=split),
          hj.fromstring("1 2 3 4 5", hj.int32, sep=" ", split=split, comm=one))
    with pytest.raises(ValueError):
        ht.fromstring("1 2", sep="")


@pytest.mark.parametrize("split", [None, 0, 1])
def test_array_keywords(split, one):
    x = np.arange(12, dtype=np.float64).reshape(3, 4)
    _same(ht.array(x, split=split), hj.array(x, split=split, comm=one))
    _same(ht.array(x, dtype=ht.int16, split=split), hj.array(x, dtype=hj.int16, split=split, comm=one))
    _same(ht.array(x.tolist(), split=split), hj.array(x.tolist(), split=split, comm=one))
    _same(ht.array(x, ndmin=4, split=split), hj.array(x, ndmin=4, split=split, comm=one))
    _same(ht.array(x, order="F", split=split), hj.array(x, order="F", split=split, comm=one))
    with pytest.raises(ValueError):
        ht.array(x, order="K")
    with pytest.raises(ValueError):
        ht.array(x, split=0, is_split=0)
    a = ht.array(x, split=split)
    assert ht.array(a) is a and ht.array(a, copy=True) is not a
    t = a.larray_padded
    shared = ht.array(t)
    assert shared.larray_padded.data_ptr() == t.data_ptr()
    assert ht.array(t, copy=True).larray_padded.data_ptr() != t.data_ptr()
    if split is not None:
        _same(ht.array(x, is_split=split), hj.array(x, is_split=split, comm=one))
    got, want = ht.asarray(x), hj.asarray(x)  # the reference's asarray takes no comm
    assert got.dtype.__name__ == want.dtype.__name__ and got.split == want.split is None
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    for v in (np.arange(5, dtype=np.uint16), np.array([2**64 - 1, 5], dtype=np.uint64), 2.5, [True, False], 7):
        _same(ht.array(v), hj.array(v, comm=one))


def test_array_of_a_dndarray_resplits(one):
    x = np.arange(20, dtype=np.int32).reshape(4, 5)
    for a_split in (None, 0, 1):
        for b_split in (None, 0, 1):
            a = ht.array(x, split=a_split)
            want = hj.array(hj.array(x, split=a_split, comm=one), split=b_split)
            _same(ht.array(a, split=b_split), want)


def test_array_copies_host_data():
    """A write into the array never reaches the numpy array it came from."""
    x = np.zeros((4, 3), np.float32)
    for split in (None, 0):
        a = ht.array(x, split=split)
        a[0] = 5.0
        a.larray_padded.add_(1.0)
    assert not x.any()
