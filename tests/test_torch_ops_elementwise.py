"""The port's element-wise operations against heat_tpu's: exponential.py,
rounding.py, trigonometrics.py, complex_math.py and the element-wise half
of arithmetics.py, over the splits None/0/1 and the types each takes, with
``out=``, ``where=``, the in-place forms and the DNDarray's operators and
methods.

The reference's exact cases are held exactly: integer ``//``, ``%``,
``fmod`` and ``divmod`` by zero (XLA's values: ``[5, -5, 0, 7, -7] // 0``
is ``[-2, -2, -1, -2, -2]``, ``% 0`` is 0), the minimum's ``// -1``,
``round(2.675, 2)`` in float32 (2.6799998: XLA multiplies by the
reciprocal of the scale), ``abs`` of an integer's minimum (it wraps)."""

import numpy as np
import pytest

import heat_tpu as hj
import heat_tpu_torch as ht
from torch_parity import DTYPES, SPLITS, both, data, same, same_outcome


@pytest.fixture(autouse=True)
def _port_on_cpu():
    ht.use_device("cpu")


REAL = ["bool", "int8", "int32", "int64", "float32", "float64"]
NUMERIC = ["int8", "int32", "int64", "float32", "float64"]
FLOATS = ["float32", "float64"]

# (name, types it is held on, positive inputs only)
UNARY = [
    ("exp", DTYPES, False), ("expm1", REAL, False), ("exp2", REAL, False), ("log", DTYPES, True),
    ("log2", REAL, True), ("log10", REAL, True), ("log1p", REAL, True), ("sqrt", DTYPES, True),
    ("square", DTYPES, False), ("cbrt", REAL, False), ("reciprocal", ["float32", "float64", "int32"], True),
    ("spacing", REAL, False),
    ("abs", DTYPES, False), ("absolute", NUMERIC, False), ("fabs", REAL, False), ("ceil", REAL, False),
    ("floor", REAL, False), ("trunc", REAL, False), ("fix", REAL, False), ("rint", REAL, False),
    ("sign", NUMERIC + ["complex64"], False), ("sgn", NUMERIC + ["complex64"], False),
    ("arccos", FLOATS, False), ("acos", ["int32"], False), ("arccosh", FLOATS, True), ("acosh", ["int8"], True),
    ("arcsin", FLOATS, False), ("asin", ["int32"], False), ("arcsinh", REAL, False), ("asinh", ["float32"], False),
    ("arctan", REAL, False), ("atan", ["float64"], False), ("arctanh", FLOATS, False), ("atanh", ["float32"], False),
    ("cos", DTYPES, False), ("cosh", REAL, False), ("deg2rad", REAL, False), ("radians", ["int32"], False),
    ("rad2deg", REAL, False), ("degrees", ["float64"], False), ("sin", DTYPES, False), ("sinh", REAL, False),
    ("tan", REAL, False), ("tanh", DTYPES, False), ("sinc", FLOATS, False), ("i0", FLOATS, False),
    ("angle", ["float32", "complex64", "int32"], False), ("conj", DTYPES, False), ("conjugate", ["float64"], False),
    ("real", DTYPES, False), ("imag", DTYPES, False), ("real_if_close", DTYPES, False),
    ("neg", NUMERIC + ["complex64"], False), ("negative", ["int8"], False), ("pos", DTYPES, False),
    ("positive", ["float32"], False), ("invert", ["bool", "int8", "int32", "int64"], False),
    ("bitwise_not", ["int32"], False), ("nan_to_num", DTYPES, False),
]
# every split for an op's first type, split 0 for the others (the
# element-wise path is the same code on every split)
UNARY_CASES = [(name, dt, pos, SPLITS if i == 0 else [0]) for name, dts, pos in UNARY for i, dt in enumerate(dts)]


@pytest.mark.parametrize("name,dtype,positive,splits", UNARY_CASES)
def test_unary_matches_reference(name, dtype, positive, splits):
    a = data(dtype, positive=positive, seed=len(name))
    if dtype.startswith("float") and name in ("arccos", "arcsin", "arctanh", "acos", "asin", "atanh"):
        a = np.clip(a / 3, -0.99, 0.99).astype(dtype)
    if name == "nan_to_num" and dtype.startswith("float"):
        a = a.copy()
        a.flat[:3] = [np.nan, np.inf, -np.inf]
    for split in splits:
        p, r = both(a, split)
        same_outcome(lambda m, x: getattr(m, name)(x), (p,), (r,))


@pytest.mark.parametrize("dtype", ["float32", "float64", "int32", "complex64"])
@pytest.mark.parametrize("decimals", [0, 1, 2, 3, -1])
def test_round_matches_reference(dtype, decimals):
    a = data(dtype, shape=(64, 3), seed=decimals + 5) * 37
    for split in SPLITS:
        p, r = both(a.astype(dtype), split)
        same(ht.round(p, decimals), hj.round(r, decimals), rtol=0, atol=0)
        same(p.round(decimals), r.round(decimals), rtol=0, atol=0)


def test_round_of_2675_is_the_references():
    p, r = both(np.float32([2.675, -2.675, 0.125, 1.005]), 0)
    got, want = ht.round(p, 2).numpy(), hj.round(r, 2).numpy()
    assert got.tobytes() == want.tobytes()
    assert got[0] == np.float32(2.6799998)


def test_abs_of_the_minimum_wraps():
    for dt in ("int8", "int32", "int64"):
        v = np.array([np.iinfo(dt).min, -1, 0, 5], dtype=dt)
        p, r = both(v, 0)
        same(ht.abs(p), hj.abs(r))
        same(abs(p), abs(r))
        assert ht.abs(p).numpy()[0] == np.iinfo(dt).min


def test_modf_and_frexp_give_two_arrays():
    a = np.array([[-2.5, 0.0, np.inf], [3.75, -np.inf, 1e-3]], np.float32)
    for split in SPLITS:
        p, r = both(a, split)
        same(ht.modf(p), hj.modf(r))
        same(ht.frexp(p), hj.frexp(r))


def test_clip_types_and_bounds():
    for dt in ("int32", "float32", "float64"):
        a = data(dt, seed=3)
        for split in SPLITS:
            p, r = both(a, split)
            for lo, hi in ((-1, 2), (0.5, 2.5), (None, 1), (-0.5, None), (3, -3)):
                same_outcome(lambda m, x: m.clip(x, lo, hi), (p,), (r,))
            same(p.clip(-1, 1), r.clip(-1, 1))


# (name, types, positive divisor, inexact promotion)
BINARY = [
    ("add", DTYPES), ("sub", NUMERIC + ["complex64"]), ("subtract", ["int32"]), ("mul", DTYPES),
    ("multiply", ["float32"]), ("div", DTYPES), ("divide", ["int8"]), ("true_divide", ["int64"]),
    ("floordiv", REAL), ("floor_divide", ["int32"]), ("mod", REAL), ("remainder", ["float64"]),
    ("fmod", REAL), ("pow", ["int32", "float32", "float64", "complex64"]), ("power", ["float32"]),
    ("copysign", REAL), ("hypot", FLOATS), ("arctan2", REAL), ("atan2", ["int32"]), ("logaddexp", REAL),
    ("logaddexp2", FLOATS), ("nextafter", FLOATS), ("gcd", ["int8", "int32", "int64", "bool"]),
    ("lcm", ["int8", "int32", "int64"]), ("heaviside", REAL), ("float_power", ["int32", "float32", "float64"]),
    ("maximum", DTYPES[:-1]), ("minimum", DTYPES[:-1]), ("bitwise_and", ["bool", "int8", "int64"]),
    ("bitwise_or", ["bool", "int32"]), ("bitwise_xor", ["int8", "int32"]), ("left_shift", ["int32"]),
    ("right_shift", ["int8", "int64"]),
]
BINARY_CASES = [(name, dt, i == 0) for name, dts in BINARY for i, dt in enumerate(dts)]


def _divisor(name, dtype, seed):
    b = data(dtype, seed=seed)
    if name in ("pow", "power") and dtype.startswith("int"):
        b = np.abs(b) % 4
    if name in ("left_shift", "right_shift"):
        b = np.abs(b) % 7
    if name in ("pow", "power", "float_power") and dtype.startswith("float"):
        b = np.round(b)
    return b.astype(dtype)


@pytest.mark.parametrize("name,dtype,every_layout", BINARY_CASES)
def test_binary_matches_reference(name, dtype, every_layout):
    a = data(dtype, seed=1)
    if name in ("float_power", "pow", "power") and dtype.startswith("float"):
        a = np.abs(a) + 0.5
    b = _divisor(name, dtype, 2)
    layouts = [(None, None), (0, 0), (1, 1), (0, None), (None, 1)] if every_layout else [(0, 0)]
    for s1, s2 in layouts:
        pa, ra = both(a, s1)
        pb, rb = both(b, s2)
        same_outcome(lambda m, x, y: getattr(m, name)(x, y), (pa, pb), (ra, rb))
    # a python scalar on either side, and a row broadcast
    pa, ra = both(a, 0)
    for s in (2, 3.0):
        same_outcome(lambda m, x: getattr(m, name)(x, s), (pa,), (ra,))
    row = _divisor(name, dtype, 3)[:1]
    pr, rr = both(row, None)
    same_outcome(lambda m, x, y: getattr(m, name)(x, y), (pa, pr), (ra, rr))


def test_ldexp_matches_reference():
    m = data("float32", seed=4)
    e = data("int32", seed=5)
    for split in SPLITS:
        pm, rm = both(m, split)
        pe, re_ = both(e, split)
        same(ht.ldexp(pm, pe), hj.ldexp(rm, re_))
        same(ht.ldexp(both(e, split)[0], pe), hj.ldexp(both(e, split)[1], re_))


@pytest.mark.parametrize("dtype", ["int8", "int32", "int64", "uint8", "bool"])
def test_integer_division_by_zero_is_the_references(dtype):
    a = np.array([5, -5, 0, 7, -7, 3], dtype=np.int64).astype(dtype)
    b = np.array([0, 0, 0, 2, -2, -1], dtype=np.int64).astype(dtype)
    for split in (None, 0):
        pa, ra = both(a, split)
        pb, rb = both(b, split)
        for name in ("floordiv", "mod", "fmod"):
            got = getattr(ht, name)(pa, pb)
            same(got, getattr(hj, name)(ra, rb))
        same(ht.divmod(pa, pb), hj.divmod(ra, rb))
        same(divmod(pa, pb), divmod(ra, rb))
        same(pa // 0, ra // 0) if dtype != "bool" else None
        same(pa % 0, ra % 0) if dtype != "bool" else None
    if dtype in ("int8", "int32", "int64"):
        z = np.array([5, -5, 0, 7, -7], dtype=dtype)
        assert ht.floordiv(ht.array(z), 0).numpy().tolist() == [-2, -2, -1, -2, -2]
        assert ht.mod(ht.array(z), 0).numpy().tolist() == [0] * 5
        lo = np.array([np.iinfo(dtype).min], dtype=dtype)
        same(ht.array(lo) // ht.array(np.array([-1], dtype)), hj.array(lo) // hj.array(np.array([-1], dtype)))
        same(ht.array(lo) % ht.array(np.array([-1], dtype)), hj.array(lo) % hj.array(np.array([-1], dtype)))


def test_float_division_by_zero_is_the_references():
    a = np.array([1.0, -1.0, 0.0, 2.5, -0.3, 0.3], np.float32)
    b = np.array([0.0, 0.0, 0.0, -0.0, 0.5, -0.5], np.float32)
    pa, ra = both(a, 0)
    pb, rb = both(b, 0)
    for name in ("floordiv", "mod", "fmod", "div"):
        same(getattr(ht, name)(pa, pb), getattr(hj, name)(ra, rb))


@pytest.mark.parametrize("name", ["add", "sub", "mul", "div", "floordiv", "mod", "pow", "maximum", "bitwise_and"])
def test_out_and_where_match_reference(name):
    dt = "int32" if name == "bitwise_and" else "float32"
    a, b = data(dt, seed=7), _divisor(name, dt, 8)
    if name == "pow":
        a = np.abs(a) + 1
    cond = data("bool", seed=9)
    fn_p, fn_r = getattr(ht, name), getattr(hj, name)
    for split in SPLITS:
        pa, ra = both(a, split)
        pb, rb = both(b, split)
        po, ro = both(np.full(a.shape, 7, dtype=dt), split)
        if name != "maximum":
            pc, rc = both(cond, split)
            same(fn_p(pa, pb, where=pc), fn_r(ra, rb, where=rc))
            res_p, res_r = fn_p(pa, pb, out=po, where=pc), fn_r(ra, rb, out=ro, where=rc)
            assert res_p is po
            same(po, ro)
        po, ro = both(np.zeros(a.shape, dtype="float64"), split)
        fn_p(pa, pb, out=po)
        fn_r(ra, rb, out=ro)
        same(po, ro, rtol=3e-5, atol=1e-6)  # float32 values in a float64 buffer


@pytest.mark.parametrize("name", ["exp", "sqrt", "floor", "sin", "abs", "neg", "invert"])
def test_unary_out_matches_reference(name):
    dt = "int32" if name == "invert" else "float32"
    a = data(dt, seed=11, positive=name == "sqrt")
    for split in SPLITS:
        pa, ra = both(a, split)
        po, ro = both(np.zeros(a.shape, dtype="float64" if dt == "float32" else dt), split)
        assert getattr(ht, name)(pa, out=po) is po
        getattr(hj, name)(ra, out=ro)
        same(po, ro, rtol=3e-5, atol=1e-6)  # float32 values in a float64 buffer


INPLACE = ["add_", "sub_", "mul_", "div_", "floordiv_", "mod_", "fmod_", "pow_", "copysign_", "hypot_",
           "bitwise_and_", "bitwise_or_", "bitwise_xor_", "left_shift_", "right_shift_", "gcd_", "lcm_",
           "divide_", "floor_divide_", "multiply_", "power_", "remainder_", "subtract_"]


@pytest.mark.parametrize("name", INPLACE)
def test_inplace_forms_match_reference(name):
    ints = name.startswith(("bitwise", "left", "right", "gcd", "lcm"))
    dt = "int32" if ints else "float32"
    a = data(dt, seed=12)
    b = _divisor(name.rstrip("_"), dt, 13)
    if name in ("pow_", "power_"):
        a = np.abs(a) + 1
    for split in (None, 0):
        pa, ra = both(a, split)
        pb, rb = both(b, split)
        res = same_outcome(lambda m, x, y: getattr(m, name)(x, y), (pa, pb), (ra, rb))
        if res is not None:
            assert res is pa
            same(pa, ra)
            same(getattr(pa, name)(pb), getattr(ra, name)(rb))


def test_unary_inplace_forms_match_reference():
    for name, dt in (("neg_", "float32"), ("negative_", "int32"), ("pos_", "float64"), ("positive_", "int8"),
                     ("invert_", "int32"), ("bitwise_not_", "bool"), ("nan_to_num_", "float32")):
        a = data(dt, seed=14)
        pa, ra = both(a, 0)
        assert getattr(ht, name)(pa) is pa
        getattr(hj, name)(ra)
        same(pa, ra)
    for name in ("cumsum_", "cumprod_", "cumproduct_"):
        pa, ra = both(data("float64", seed=15), 0)
        getattr(ht, name)(pa, 0)
        getattr(hj, name)(ra, 0)
        same(pa, ra)


OPERATORS = [
    ("__iadd__", "float32"), ("__isub__", "int32"), ("__imul__", "int64"), ("__itruediv__", "float64"),
    ("__ifloordiv__", "int32"), ("__imod__", "float32"), ("__ipow__", "float64"), ("__iand__", "int32"),
    ("__ior__", "bool"), ("__ixor__", "int8"), ("__ilshift__", "int32"), ("__irshift__", "int64"),
    ("__floordiv__", "float32"), ("__rfloordiv__", "int32"), ("__mod__", "int64"), ("__rmod__", "float64"),
    ("__divmod__", "int32"), ("__rdivmod__", "float32"),
]


@pytest.mark.parametrize("name,dtype", OPERATORS)
def test_operators_match_reference(name, dtype):
    a = data(dtype, seed=16)
    b = data(dtype, seed=17, positive=True)
    if "pow" in name:
        a = np.abs(a) + 0.5
    if "shift" in name:
        b = (b % 5).astype(dtype)
    for split in (None, 0, 1):
        pa, ra = both(a, split)
        pb, rb = both(b, split)
        res = same_outcome(lambda m, x, y: getattr(x, name)(y), (pa, pb), (ra, rb))
        if res is not None and name.startswith("__i"):
            assert res is pa
        for s in (3, 2.0):
            pa, ra = both(a, split)
            same_outcome(lambda m, x: getattr(x, name)(s), (pa,), (ra,))


def test_unary_operators_match_reference():
    for dt in ("int32", "float64", "int8"):
        a = data(dt, seed=18)
        for split in SPLITS:
            pa, ra = both(a, split)
            same(abs(pa), abs(ra))
            same(+pa, +ra)
            assert (+pa) is not pa


METHODS = ["abs", "ceil", "clip", "cos", "exp", "floor", "log", "round", "sin", "sqrt", "tan", "trunc", "real",
           "imag"]


@pytest.mark.parametrize("name", METHODS)
def test_methods_match_reference(name):
    a = data("float32", seed=19, positive=name in ("log", "sqrt"))
    for split in SPLITS:
        pa, ra = both(a, split)
        if name == "clip":
            same(pa.clip(-1, 1), ra.clip(-1, 1))
        elif name in ("real", "imag"):
            same(getattr(pa, name), getattr(ra, name))
        else:
            same(getattr(pa, name)(), getattr(ra, name)())


def test_widened_types_still_raise_by_name():
    """The ops that raised for uint16, uint32 and uint64 until their
    arithmetic was ported now give the reference's answers
    (tests/test_torch_numpy_rest.py sweeps every op)."""
    for dt in ("uint16", "uint32", "uint64"):
        v = np.arange(6).astype(dt).reshape(2, 3)
        pa, ra = both(v, 0)
        for fn in (lambda m, x: m.exp(x), lambda m, x: m.floor(x), lambda m, x: m.sin(x),
                   lambda m, x: m.floordiv(x, x), lambda m, x: m.mod(x, x), lambda m, x: m.cumsum(x, 0),
                   lambda m, x: m.prod(x), lambda m, x: m.var(x), lambda m, x: m.argmax(x)):
            same(fn(ht, pa), fn(hj, ra))


def test_real_if_close_decides_for_the_whole_array():
    c = (np.arange(12).reshape(4, 3) + 1e-9j).astype(np.complex64)
    far = c.copy()
    far[3, 2] += 1j
    for arr in (c, far):
        for split in SPLITS:
            p, r = both(arr, split)
            same(ht.real_if_close(p), hj.real_if_close(r))
