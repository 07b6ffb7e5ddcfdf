"""The rest of the NumPy surface against heat_tpu's: the arithmetic of
uint16, uint32 and uint64 (held in int32, int64 and int64's bits), ``gradient``
with coordinate arrays, ``trapz`` with N-D sample points and ``histogram``'s
edges.

The unsigned values cover both ends of each type and its top bit (2^15,
2^31, 2^63 and the maximum), zeros among the divisors; every exact result is
held bitwise, floats at the reference tests' float32 bound (rtol 3e-5, atol
1e-6) and float64's 1e-12."""

import numpy as np
import pytest

import heat_tpu as hj
import heat_tpu_torch as ht
from test_torch_ops_elementwise import BINARY, UNARY
from torch_parity import same, same_outcome


@pytest.fixture(autouse=True)
def _port_on_cpu():
    ht.use_device("cpu")


UNSIGNED = ["uint16", "uint32", "uint64"]


def udata(dtype: str, seed: int, shape=(6, 5)) -> np.ndarray:
    """Seeded values of an unsigned type: half of the rows small (zeros
    among them), half drawn over the whole range, and the first entries 0,
    1, the maximum and both sides of the top bit."""
    rng = np.random.default_rng(seed)
    bits = np.iinfo(dtype).bits
    wide = rng.integers(0, 2**63, shape, dtype=np.uint64) * np.uint64(2) + rng.integers(0, 2, shape, dtype=np.uint64)
    v = (wide >> np.uint64(64 - bits)).astype(dtype)
    v[::2] = rng.integers(0, 10, shape).astype(dtype)[::2]
    top = np.iinfo(dtype).max
    v.reshape(-1)[:5] = [0, 1, top, top // 2 + 1, top // 2]
    return v


def both(a, split):
    return ht.array(a, split=split), hj.array(a, split=split)


UNARY_NAMES = [name for name, _, _ in UNARY]


@pytest.mark.parametrize("dtype", UNSIGNED)
@pytest.mark.parametrize("name", UNARY_NAMES)
def test_unary_on_unsigned(name, dtype):
    a = udata(dtype, len(name))
    for split in (None, 0):  # split 1 runs the same element-wise code as split 0
        p, r = both(a, split)
        same_outcome(lambda m, x: getattr(m, name)(x), (p,), (r,))


def _operand(name, dtype, seed):
    b = udata(dtype, seed)
    if name in ("left_shift", "right_shift", "pow", "power"):
        b = (b % np.array(70, dtype)).astype(dtype)  # shifts past the width, exponents past six bits
    return b


BINARY_NAMES = [name for name, _ in BINARY]


@pytest.mark.parametrize("dtype", UNSIGNED)
@pytest.mark.parametrize("name", BINARY_NAMES)
def test_binary_on_unsigned(name, dtype):
    a, b = udata(dtype, 1), _operand(name, dtype, 2)
    for s1, s2 in ((None, None), (0, 0), (0, None)):
        pa, ra = both(a, s1)
        pb, rb = both(b, s2)
        same_outcome(lambda m, x, y: getattr(m, name)(x, y), (pa, pb), (ra, rb))
    pa, ra = both(a, 0)
    for s in (2, 3.0, True):
        same_outcome(lambda m, x: getattr(m, name)(x, s), (pa,), (ra,))
        same_outcome(lambda m, x: getattr(m, name)(s, x), (pa,), (ra,))


@pytest.mark.parametrize("dtype", UNSIGNED)
def test_operators_and_comparisons_on_unsigned(dtype):
    a, b = udata(dtype, 3), udata(dtype, 4)
    c = (b % np.array(70, dtype)).astype(dtype)
    ops = [
        lambda x, y: x + y, lambda x, y: x - y, lambda x, y: x * y, lambda x, y: x // y, lambda x, y: x % y,
        lambda x, y: x < y, lambda x, y: x <= y,
        lambda x, y: x > y, lambda x, y: x >= y, lambda x, y: x == y, lambda x, y: x != y, lambda x, y: -x,
        lambda x, y: abs(x), lambda x, y: ~x, lambda x, y: x & y, lambda x, y: x | y, lambda x, y: x ^ y,
    ]
    for split in (None, 0):
        pa, ra = both(a, split)
        pb, rb = both(b, split)
        for op in ops:
            same(op(pa, pb), op(ra, rb))
        pc, rc = both(c, split)
        same(pa >> pc, ra >> rc)
        same(pa << pc, ra << rc)


REDUCTIONS = ["sum", "prod", "min", "max", "argmin", "argmax", "mean", "var", "std", "median", "ptp", "nansum",
              "nanprod", "nanmax", "nanmin", "amax", "amin", "average", "count_nonzero", "any", "all"]


@pytest.mark.parametrize("dtype", UNSIGNED)
@pytest.mark.parametrize("name", REDUCTIONS)
def test_reductions_on_unsigned(name, dtype):
    a = udata(dtype, 5, shape=(9, 8))  # napi's split rule reads the world's size below 8
    for split in (None, 0):
        p, r = both(a, split)
        for axis in (None, 0, 1):
            same_outcome(lambda m, x: getattr(m, name)(x, axis=axis), (p,), (r,))


@pytest.mark.parametrize("dtype", UNSIGNED)
@pytest.mark.parametrize("name", ["cumsum", "cumprod", "nancumsum", "nancumprod"])
def test_scans_on_unsigned(name, dtype):
    a = udata(dtype, 6, shape=(9, 4))
    for split in (None, 0, 1):
        p, r = both(a, split)
        for axis in (0, 1):
            same_outcome(lambda m, x: getattr(m, name)(x, axis), (p,), (r,))


@pytest.mark.parametrize("dtype", UNSIGNED)
def test_sorts_and_conversions_on_unsigned(dtype):
    a = udata(dtype, 7, shape=(11, 3))
    for split in (None, 0, 1):
        p, r = both(a, split)
        for axis in (0, 1):
            same(ht.sort(p, axis=axis)[0], hj.sort(r, axis=axis)[0])
            same(ht.sort(p, axis=axis, descending=True)[0], hj.sort(r, axis=axis, descending=True)[0])
        same(ht.unique(p), hj.unique(r))
        for t in ("float16", "float32", "float64", "int64", "int8", "uint8", "bool", "complex64"):
            same(p.astype(t), r.astype(t), rtol=0, atol=0)
        same(ht.clip(p, 3, np.iinfo(dtype).max // 3), hj.clip(r, 3, np.iinfo(dtype).max // 3))
        same(ht.percentile(p, 50.0, axis=0), hj.percentile(r, 50.0, axis=0))
        same(ht.histogram(p, bins=7), hj.histogram(r, bins=7))
        same(ht.histc(p, bins=5), hj.histc(r, bins=5))
        same(ht.frexp(p), hj.frexp(r))
        same(ht.modf(p), hj.modf(r))
        same(ht.cov(p), hj.cov(r))
        same(ht.where(p > 5, p, ht.zeros_like(p)), hj.where(r > 5, r, hj.zeros_like(r)))
        same(ht.where(p > 5, p, 7), hj.where(r > 5, r, 7))


def test_unsigned_scalars_keep_their_shape():
    for dtype in UNSIGNED:
        v = udata(dtype, 8, shape=(7,))
        p, r = both(v, 0)
        for fn in (lambda m, x: m.sum(x), lambda m, x: m.max(x), lambda m, x: x[3]):
            got, want = fn(ht, p), fn(hj, r)
            assert got.numpy().shape == np.asarray(want.numpy()).shape == ()
            assert got.numpy().tobytes() == np.asarray(want.numpy()).tobytes()
        assert ht.array(np.uint64(2**63 + 5)).numpy().shape == ()


def test_unsigned_float_conversion_rounds_once():
    """Values whose conversion through float64 would round twice."""
    v = np.array([2**64 - 1, 2**63 + 2**39 + 1, 2**63 + 2**40, 2**63 - 2**39 - 1, 2**53 + 1, 2**24 + 1,
                  (2**24 + 1) * 2**39 + 1], np.uint64)
    p, r = both(v, 0)
    for t in ("float32", "float64"):
        got, want = p.astype(t).numpy(), r.astype(t).numpy()
        assert got.tobytes() == want.tobytes(), (got, want)
        assert got.tobytes() == v.astype(t).tobytes()


# ----------------------------------------------------------------------
# gradient with coordinate arrays, trapz with N-D sample points
# ----------------------------------------------------------------------
def _coords(n, seed):
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.random(n) + 0.1).astype(np.float32)


@pytest.mark.parametrize("split", [None, 0, 1])
@pytest.mark.parametrize("shape", [(9, 6), (17, 4), (3, 5)])
def test_gradient_with_coordinate_arrays(split, shape):
    f = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    x0, x1 = _coords(shape[0], 2), _coords(shape[1], 3)
    pf, rf = both(f, split)
    for axis, args in ((0, (x0,)), (1, (x1,)), (None, (x0, x1)), (None, (x0, 0.5)), (0, (ht.array(x0, split=0),))):
        rargs = tuple(hj.array(a.numpy(), split=a.split) if isinstance(a, ht.DNDarray) else a for a in args)
        same(ht.gradient(pf, *args, axis=axis), hj.gradient(rf, *rargs, axis=axis))
    # coordinates as long as the axis, or refused as the reference refuses them
    same_outcome(lambda m, a: m.gradient(a, x0[:-1], axis=0), (pf,), (rf,))


@pytest.mark.parametrize("split", [None, 0, 1])
@pytest.mark.parametrize("axis", [0, 1, -1])
def test_trapz_with_nd_sample_points(split, axis):
    rng = np.random.default_rng(4)
    y = rng.standard_normal((9, 7)).astype(np.float32)
    x = np.cumsum(rng.random((9, 7)) + 0.1, axis=axis).astype(np.float32)
    py, ry = both(y, split)
    for xs in (None, 0, 1):
        px, rx = both(x, xs)
        same(ht.trapz(py, px, axis=axis), hj.trapz(ry, rx, axis=axis))
    same(ht.trapz(py, x, axis=axis), hj.trapz(ry, x, axis=axis))
    col = x[:, :1] if axis % 2 == 0 else x[:1, :]  # broadcast along the other axis
    same(ht.trapz(py, col, axis=axis), hj.trapz(ry, col, axis=axis))
    vec = x[:, 0] if axis % 2 == 0 else x[0]
    same(ht.trapezoid(py, vec, axis=axis), hj.trapz(ry, vec, axis=axis))


# ----------------------------------------------------------------------
# histogram's edges
# ----------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_histogram_edges_are_the_references_but_edge_one(dtype):
    """The port evaluates JAX's ``linspace`` as XLA's scalar loop does
    (``lo (1 - i r) + i (hi r)``, the last sum fused).  On the reference's
    CPU build XLA evaluates edge 1 otherwise for 3 to 33 bins (sometimes
    up to two roundings apart); every other edge of 2 to 128 bins is bitwise the
    reference's (ROADMAP caveats: the measured pattern, and longer runs at
    255 and 1000 bins).  The counts over the same edges are the
    reference's."""
    rng = np.random.default_rng(0)
    for trial in range(6):
        lo, hi = sorted(rng.standard_normal(2) * 10.0 ** rng.integers(-3, 4))
        a = np.array([lo, hi], dtype)
        for bins in (2, 3, 5, 10, 17, 33, 34, 64, 100, 128):
            got = ht.histogram(ht.array(a), bins=bins)[1].numpy()
            want = np.asarray(hj.histogram(hj.array(a), bins=bins)[1].numpy())
            bad = np.nonzero(got != want)[0].tolist()
            assert bad in ([], [1]) and (not bad or 3 <= bins <= 33), (bins, bad)
            if bad:  # two roundings apart at most
                ints = np.int32 if dtype == "float32" else np.int64
                assert abs(int(got[1:2].view(ints)[0]) - int(want[1:2].view(ints)[0])) <= 2, (got[1], want[1])
            v = np.random.default_rng(trial).uniform(lo, hi, 50).astype(dtype)
            same(ht.histogram(ht.array(v, split=0), bins=want)[0], hj.histogram(hj.array(v, split=0), bins=want)[0])


# ----------------------------------------------------------------------
# napi's functions on the unsigned types
# ----------------------------------------------------------------------
@pytest.fixture
def world_of_one():
    import jax

    saved = hj.get_comm()
    hj.use_comm(hj.Communication(jax.devices()[:1]))
    try:
        yield
    finally:
        hj.use_comm(saved)


def _napi_cases():
    from torch_napi_cases import ONE

    return sorted(ONE)


@pytest.mark.parametrize("dtype", UNSIGNED)
@pytest.mark.parametrize("name", _napi_cases())
def test_napi_on_unsigned_is_the_references_or_refused(world_of_one, name, dtype):
    """napi computes on torch's own unsigned dtypes: where torch has a
    kernel for the type the answer is the reference's, bitwise for exact
    results; where it has none, torch's NotImplementedError (the port never
    answers in the holding type)."""
    from torch_napi_cases import ONE

    a = udata(dtype, 40, shape=(7, 5))
    a[3] = a[1]
    for split in (None, 0):
        p, r = ht.array(a, split=split), hj.array(a, split=split)
        try:
            want = ONE[name](hj, r)
        except Exception as e:  # the reference's refusal is the port's too
            with pytest.raises(type(e)):
                ONE[name](ht, p)
            continue
        try:
            got = ONE[name](ht, p)
        except NotImplementedError as e:
            assert "UInt" in str(e), e
            continue
        same(got, want, rtol=3e-5, atol=1e-6)


def test_f16_correlate_of_64_bit_integers_is_float64(world_of_one):
    """F16: ``correlate`` took int64 and uint64 to
    float32; jnp takes them to float64."""
    for dtype in ("int64", "uint64", "int32", "int16"):
        a = (np.arange(9) * 3 + 1).astype(dtype)
        v = np.array([2, 0, 1], dtype)
        for mode in ("valid", "full", "same"):
            same(ht.correlate(ht.array(a), ht.array(v), mode=mode), hj.correlate(hj.array(a), hj.array(v), mode=mode))
