"""Printing, the logical functions and the bitwise operations against
heat_tpu's.

The port runs on one CPU rank, the reference on a one-device
Communication.  Strings are held equal character for character: below and
above the print threshold (where the port fetches only the edge blocks),
under ``printoptions`` and the profiles, local printing and
``set_string_function``.  The logical and bitwise results are held to the
reference's type, split and bits over the integer, bool and float types,
the unsigned ones included."""

import jax
import numpy as np
import pytest

import heat_tpu as hj
import heat_tpu_torch as ht
from heat_tpu_torch.core import printing


@pytest.fixture(autouse=True)
def _port_on_cpu():
    ht.use_device("cpu")


@pytest.fixture(scope="module")
def one():
    return hj.Communication(jax.devices()[:1])


RNG = np.random.default_rng(3)
ARRAYS = {
    "int_2d": np.arange(12).reshape(3, 4),
    "f32_40x40": RNG.standard_normal((40, 40)).astype(np.float32),
    "f64_2000": np.linspace(-1e5, 1e5, 2000),
    "f32_3d": RNG.standard_normal((13, 11, 9)).astype(np.float32) * 1e-3,
    "scalar": np.array(3.5),
    "complex": np.array([1 + 2j, 3j, -0.5]),
    "bool": np.array([True, False, True]),
    "uint64": np.arange(5, dtype=np.uint64) * np.uint64(2**62),
    "uint16_big": (np.arange(3000) % 65536).astype(np.uint16),
    "int8": np.arange(-4, 4, dtype=np.int8),
    "f16": np.array([0.1, 1.5, -2.25], dtype=np.float16),
    "empty": np.zeros((0, 3), np.float32),
}


@pytest.mark.parametrize("name", list(ARRAYS))
@pytest.mark.parametrize("split", [None, 0, 1])
def test_repr_matches_reference(name, split, one):
    x = ARRAYS[name]
    if split is not None and split >= x.ndim:
        return
    a, r = ht.array(x, split=split), hj.array(x, split=split, comm=one)
    assert str(a) == str(r)
    assert repr(a) == repr(r)


def test_summarised_print_fetches_only_the_edges():
    """Above the threshold only the edge blocks (and one elided index per
    axis) reach the host."""
    a = ht.array(ARRAYS["f32_3d"], split=0)
    str(a)
    assert printing.LAST_FETCH_BYTES == 7 * 7 * 7 * 4
    small = ht.array(ARRAYS["int_2d"], split=0)
    str(small)
    assert printing.LAST_FETCH_BYTES == small.numpy().nbytes


@pytest.mark.parametrize("opts", [dict(precision=2), dict(threshold=5), dict(edgeitems=1, threshold=10),
                                  dict(profile="short"), dict(profile="full"), dict(linewidth=40)])
def test_printoptions_match_reference(opts, one):
    x = ARRAYS["f32_40x40"]
    a, r = ht.array(x, split=0), hj.array(x, split=0, comm=one)
    with ht.printoptions(**opts) as po, hj.printoptions(**opts) as pr:
        assert str(a) == str(r)
        assert po == pr
    assert ht.get_printoptions() == hj.get_printoptions()
    assert str(a) == str(r)


def test_set_printoptions_and_local_printing(one, capsys):
    x = ARRAYS["int_2d"]
    a, r = ht.array(x, split=0), hj.array(x, split=0, comm=one)
    saved = np.get_printoptions()
    try:
        ht.set_printoptions(precision=3, edgeitems=2)
        hj.set_printoptions(precision=3, edgeitems=2)
        assert ht.get_printoptions() == hj.get_printoptions() and str(a) == str(r)
    finally:
        ht.set_printoptions(profile="default")
        hj.set_printoptions(profile="default")
        np.set_printoptions(**saved)
    ht.local_printing()
    try:
        assert str(a) == f"DNDarray(local={x}, device=cpu:0, split=0)"
    finally:
        ht.global_printing()
    ht.set_string_function(lambda t: "custom")
    try:
        assert repr(a) == str(a) == "custom"
    finally:
        ht.set_string_function(None)
    assert str(a) == str(r)
    ht.print0("rank zero")
    assert capsys.readouterr().out == "rank zero\n"


def test_constants():
    for name in ("e", "Euler", "inf", "Inf", "Infty", "Infinity", "pi"):
        assert getattr(ht, name) == getattr(hj, name)
    assert np.isnan(ht.nan) and np.isnan(ht.NaN)


def _same_outcome(fn, a, r):
    """fn on the port's operands gives the reference's result, or raises the
    same exception type where the reference raises."""
    try:
        want = fn(r)
    except Exception as e:  # the reference's refusal is the expected outcome
        with pytest.raises(type(e)):
            fn(a)
        return
    _same(fn(a), want)


def _same(got, want):
    assert got.dtype.__name__ == want.dtype.__name__, (got.dtype, want.dtype)
    assert got.shape == want.shape and got.split == want.split
    g, w = got.numpy(), np.asarray(want.numpy())
    assert g.dtype == w.dtype
    np.testing.assert_array_equal(g, w)


FLOATS = np.array([[0.0, -0.0, 1.5, -np.inf], [np.inf, np.nan, -2.0, 1e-30], [3.0, 3.0 + 1e-7, 5.0, -7.5]])
INTS = {
    "int8": np.array([[0, -1, 5, 127], [-128, 3, 4, 9], [1, 2, 3, 4]], np.int8),
    "int32": np.array([[0, -7, 1 << 20, 3], [5, 6, -1, 9], [11, 12, 13, 14]], np.int32),
    "int64": np.array([[0, -7, 1 << 40, 3], [5, 6, -1, 9], [11, 12, 13, 14]], np.int64),
    "uint8": np.array([[0, 255, 5, 128], [3, 4, 9, 1], [6, 7, 8, 2]], np.uint8),
    "uint16": np.array([[0, 65535, 5, 32768], [3, 4, 9, 1], [6, 7, 8, 2]], np.uint16),
    "uint32": np.array([[0, 2**32 - 1, 5, 2**31], [3, 4, 9, 1], [6, 7, 8, 2]], np.uint32),
    "uint64": np.array([[0, 2**64 - 1, 5, 2**63], [3, 4, 9, 1], [6, 7, 8, 2]], np.uint64),
    "bool": np.array([[True, False, True, False], [False, False, True, True], [True, True, True, False]]),
}


@pytest.mark.parametrize("split", [None, 0, 1])
def test_logical_reductions_and_tests(split, one):
    a, r = ht.array(FLOATS, split=split), hj.array(FLOATS, split=split, comm=one)
    for fn in ("isfinite", "isinf", "isnan", "isneginf", "isposinf", "signbit", "logical_not"):
        _same(getattr(ht, fn)(a), getattr(hj, fn)(r))
    for fn in ("all", "any"):
        for axis in (None, 0, 1, (0, 1)):
            for keepdims in (False, True):
                _same(getattr(ht, fn)(a, axis=axis, keepdims=keepdims), getattr(hj, fn)(r, axis=axis, keepdims=keepdims))
    b = FLOATS[::-1].copy()
    pb, rb = ht.array(b, split=split), hj.array(b, split=split, comm=one)
    for fn in ("logical_and", "logical_or", "logical_xor"):
        _same(getattr(ht, fn)(a, pb), getattr(hj, fn)(r, rb))
    _same(ht.isclose(a, pb), hj.isclose(r, rb))
    _same(ht.isclose(a, pb, equal_nan=True), hj.isclose(r, rb, equal_nan=True))
    _same(ht.isclose(a, 3.0, rtol=1e-6), hj.isclose(r, 3.0, rtol=1e-6))
    for other, kw in ((a, {"equal_nan": True}), (a, {}), (pb, {}), (FLOATS + 1e-9, {"equal_nan": True}), (3.0, {})):
        ro = r if other is a else rb if other is pb else other
        assert ht.allclose(a, other, **kw) == hj.allclose(r, ro, **kw)
    out = ht.zeros(FLOATS.shape, dtype=ht.bool, split=split)
    assert ht.isnan(a, out=out) is out
    _same(out, hj.isnan(r))
    assert a.all().item() == r.all().item() and a.any().item() == r.any().item()


@pytest.mark.parametrize("dtype", list(INTS))
@pytest.mark.parametrize("split", [None, 0, 1])
def test_logical_and_bitwise_over_the_types(dtype, split, one):
    x = INTS[dtype]
    y = x[::-1].copy()
    a, r = ht.array(x, split=split), hj.array(x, split=split, comm=one)
    b, rb = ht.array(y, split=split), hj.array(y, split=split, comm=one)
    for fn in ("logical_not", "isfinite", "isnan", "signbit"):
        _same(getattr(ht, fn)(a), getattr(hj, fn)(r))
    for fn in ("all", "any"):
        _same(getattr(ht, fn)(a, axis=0), getattr(hj, fn)(r, axis=0))
    for fn in ("logical_and", "logical_or", "logical_xor", "bitwise_and", "bitwise_or", "bitwise_xor"):
        _same(getattr(ht, fn)(a, b), getattr(hj, fn)(r, rb))
    _same(~a, ~r)
    _same(ht.invert(a), hj.invert(r))
    _same(ht.bitwise_not(a), hj.bitwise_not(r))
    _same(a & b, r & rb)
    _same(a | b, r | rb)
    _same(a ^ b, r ^ rb)
    for s in (True, 5):
        _same_outcome(lambda t: t & s, a, r)
        _same_outcome(lambda t: s | t, a, r)
        _same_outcome(lambda t: t ^ s, a, r)
    _same(a == b, r == rb)
    _same(a < b, r < rb)
    _same(a >= 5, r >= 5)
    if dtype != "bool":
        bits = np.iinfo(dtype).bits
        shift = (np.arange(12).reshape(3, 4) % bits).astype(dtype)
        sh, rsh = ht.array(shift, split=split), hj.array(shift, split=split, comm=one)
        _same(a << sh, r << rsh)
        _same(a >> sh, r >> rsh)
        _same_outcome(lambda t: (ht if t is a else hj).left_shift(t, 3), a, r)
        _same_outcome(lambda t: (ht if t is a else hj).right_shift(t, 1), a, r)


@pytest.mark.parametrize("dtype", ["int32", "uint16", "uint64", "bool"])
def test_inplace_bitwise(dtype, one):
    x, y = INTS[dtype], INTS[dtype][::-1].copy()
    for fn in ("bitwise_and_", "bitwise_or_", "bitwise_xor_"):
        a, r = ht.array(x, split=0), hj.array(x, split=0, comm=one)
        assert getattr(ht, fn)(a, ht.array(y, split=0)) is a
        getattr(hj, fn)(r, hj.array(y, split=0, comm=one))
        _same(a, r)
    a, r = ht.array(x, split=0), hj.array(x, split=0, comm=one)
    ht.invert_(a)
    hj.invert_(r)
    _same(a, r)
    if dtype != "bool":
        a, r = ht.array(x, split=0), hj.array(x, split=0, comm=one)
        sa, sr = ht.array(np.full(x.shape, 2, x.dtype), split=0), hj.array(np.full(x.shape, 2, x.dtype), split=0,
                                                                          comm=one)
        _same_outcome(lambda t: (ht if t is a else hj).left_shift_(t, sa if t is a else sr), a, r)
        _same_outcome(lambda t: (ht if t is a else hj).right_shift_(t, 1), a, r)


def test_bitwise_refuses_floats_and_unported_ops_raise_for_unsigned():
    a = ht.array(FLOATS)
    for fn in (ht.bitwise_and, ht.bitwise_or, ht.left_shift):
        with pytest.raises(TypeError):
            fn(a, a)
    with pytest.raises(TypeError):
        ~a
    # uint32's arithmetic, once refused by name, is the reference's now
    u, ur = ht.array(INTS["uint32"]), hj.array(INTS["uint32"])
    for op in (lambda t: t + t, lambda t: t * t, lambda t: -t, lambda t: t.sum(), lambda t: (ht if t is u else hj).max(t)):
        got, want = op(u), op(ur)
        assert got.dtype.__name__ == want.dtype.__name__
        np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("split", [None, 0, 1])
def test_nonzero_and_where(split, one):
    x = INTS["int32"]
    a, r = ht.array(x, split=split), hj.array(x, split=split, comm=one)
    _same(ht.nonzero(a), hj.nonzero(r))
    _same(ht.where(a), hj.where(r))
    cond = a > 4
    rcond = r > 4
    _same(ht.where(cond, a, -a), hj.where(rcond, r, -r))
    _same(ht.where(cond, a, 0.5), hj.where(rcond, r, 0.5))
    _same(ht.where(cond, 1, 0), hj.where(rcond, 1, 0))
    v = ht.array(np.arange(5, dtype=np.float32), split=0 if split is not None else None)
    rv = hj.array(np.arange(5, dtype=np.float32), split=0 if split is not None else None, comm=one)
    _same(ht.nonzero(v), hj.nonzero(rv))
    with pytest.raises(TypeError):
        ht.where(cond, a)
