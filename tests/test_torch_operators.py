"""The DNDarray's operators against heat_tpu's: the reflected ``/`` and
``**``, the comparisons (operators and ``ht.eq`` ... ``ht.ne``,
``ht.equal``), bool operands of the arithmetic, ``argmin`` of bool data,
``bool()``/``int()``/``float()``, ``np.asarray`` and ``ht.array`` of a
DNDarray.

Inputs are made with numpy and given to both packages; the port runs on
one CPU rank.  Results are held to the reference's exactly: the dtype, the
split and the values bitwise.  Where the reference raises, the port raises
the same exception type.  The dtypes and splits are those of
tests/test_torch_comm_dndarray.py::test_numpy_operands_match_reference."""

import numpy as np
import pytest

import heat_tpu as hj
import heat_tpu_torch as ht

DTYPES = [np.float32, np.int32]
SPLITS = [None, 0, 1]


@pytest.fixture(autouse=True)
def _port_on_cpu():
    ht.use_device("cpu")


def _data(dtype):
    return np.arange(1, 13, dtype=dtype).reshape(4, 3)


def _same(got, want):
    """got and want are the same result: DNDarrays of one dtype, split and
    bits, or numpy arrays of one dtype and bits."""
    if isinstance(want, hj.DNDarray):
        assert isinstance(got, ht.DNDarray), type(got)
        assert got.dtype.__name__ == want.dtype.__name__
        assert got.shape == want.shape and got.split == want.split
        got, want = got.numpy(), want.numpy()
    assert type(got) is type(want) and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def _same_outcome(fn, a, r):
    """fn on the port's operands and on the reference's gives the same
    result, or raises the same exception type in both."""
    try:
        want = fn(r)
    except Exception as e:  # the reference's refusal is the expected outcome
        with pytest.raises(type(e)):
            fn(a)
        return
    _same(fn(a), want)


# F6: the reflected / and ** with python and numpy scalars
_REFLECTED = [2, 2.0, 3, 2.5, -1.5, np.float32(2.0), np.float64(2.0), np.int64(3)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("op", ["truediv", "pow"])
@pytest.mark.parametrize("other", _REFLECTED, ids=lambda o: f"{type(o).__name__}({o})")
def test_reflected_operators_match_reference(dtype, split, op, other):
    """``other / x`` and ``other ** x``: a python scalar goes through the
    DNDarray's reflected method; a numpy scalar, as in the reference, takes
    the DNDarray as an array (``__array__``) and gives a numpy array."""
    x = _data(dtype)
    a, r = ht.array(x, split=split), hj.array(x, split=split)
    if op == "truediv":
        _same_outcome(lambda t: other / t, a, r)
    else:
        _same_outcome(lambda t: other**t, a, r)


# the comparisons: operators, functions and the reflected forms
_COMPARISONS = {"eq": "==", "ne": "!=", "lt": "<", "le": "<=", "gt": ">", "ge": ">="}
_OPERANDS = {
    "int": lambda x: 5,
    "float": lambda x: 5.5,
    "bool": lambda x: True,
    "np_float32": lambda x: np.float32(6.0),
    "np_int64": lambda x: np.int64(4),
    "np_row": lambda x: np.arange(3, 6, dtype=np.float64),
    "same_layout": lambda x: "same",
    "unsplit": lambda x: "unsplit",
    "row": lambda x: "row",
}


def _operand(kind, x, split, module):
    """The other operand of a comparison, for ``module`` (ht or hj)."""
    value = _OPERANDS[kind](x)
    if not isinstance(value, str):
        return value
    y = x[::-1].copy()  # equal to x in some places only
    return {"same": lambda: module.array(y, split=split), "unsplit": lambda: module.array(y),
            "row": lambda: module.array(y[:1])}[value]()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("name", list(_COMPARISONS))
@pytest.mark.parametrize("kind", list(_OPERANDS))
def test_comparisons_match_reference(dtype, split, name, kind):
    x = _data(dtype)
    a, r = ht.array(x, split=split), hj.array(x, split=split)
    oa, orr = _operand(kind, x, split, ht), _operand(kind, x, split, hj)
    op = _COMPARISONS[name]
    got, want = eval(f"a {op} oa"), eval(f"r {op} orr")
    assert got.dtype is ht.bool
    _same(got, want)
    _same(getattr(ht, name)(a, oa), getattr(hj, name)(r, orr))
    # the reflected form: oa op a (a python or numpy scalar on the left)
    _same(getattr(ht, name)(oa, a), getattr(hj, name)(orr, r))
    if not isinstance(oa, (np.ndarray, np.generic)):
        _same(eval(f"oa {op} a"), eval(f"orr {op} r"))


@pytest.mark.parametrize("alias,name", [("greater_equal", "ge"), ("greater", "gt"), ("less_equal", "le"),
                                        ("less", "lt"), ("not_equal", "ne")])
def test_relational_aliases(alias, name):
    assert getattr(ht, alias) is getattr(ht, name)
    x = _data(np.float32)
    _same(getattr(ht, alias)(ht.array(x, split=0), 6), getattr(hj, alias)(hj.array(x, split=0), 6))


_EQUAL_CASES = {
    "same": lambda m, x, s: (m.array(x, split=s), m.array(x.copy(), split=s)),
    "other_split": lambda m, x, s: (m.array(x, split=s), m.array(x)),
    "differs_once": lambda m, x, s: (m.array(x, split=s), m.array(np.where(x == 12, 0, x).astype(x.dtype))),
    "broadcast_row": lambda m, x, s: (m.array(np.tile(x[:1], (4, 1)), split=s), m.array(x[:1])),
    "no_broadcast": lambda m, x, s: (m.array(x, split=s), m.array(x[:, :2])),
    "numpy": lambda m, x, s: (m.array(x, split=s), x),
    "list": lambda m, x, s: (m.array(x, split=s), x.tolist()),
    "scalar": lambda m, x, s: (m.array(np.full((4, 3), 7, x.dtype), split=s), 7),
    "scalar_differs": lambda m, x, s: (m.array(x, split=s), 7),
    "python_only": lambda m, x, s: ([1, 2], [1, 2]),
    "python_no_broadcast": lambda m, x, s: ([1, 2], [1, 2, 3]),
}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("case", list(_EQUAL_CASES))
def test_equal_matches_reference(dtype, split, case):
    x = _data(dtype)
    got = ht.equal(*_EQUAL_CASES[case](ht, x, split))
    want = hj.equal(*_EQUAL_CASES[case](hj, x, split))
    assert type(got) is bool and got == want


# F7: bool operands (b = x > 0 in ROADMAP's table; here x > 5, mixed)
_BOOL_OPS = {
    "b+1": lambda m, b: b + 1,
    "pow(b,2)": lambda m, b: m.pow(b, 2),
    "div(b,3)": lambda m, b: m.div(b, 3),
    "b-1.5": lambda m, b: b - 1.5,
    "2-b": lambda m, b: 2 - b,
    "b-1": lambda m, b: b - 1,
    "b*2.5": lambda m, b: b * 2.5,
    "b+True": lambda m, b: b + True,
    "b/b": lambda m, b: b / b,
    "b**b": lambda m, b: b**b,
    "2**b": lambda m, b: 2**b,
    "True/b": lambda m, b: True / b,
    "b-b": lambda m, b: b - b,
    "True-b": lambda m, b: True - b,
    "-b": lambda m, b: -b,
    "b+x": lambda m, b: b + m.array(np.ones((4, 3), np.int32)),
    "x-b": lambda m, b: m.array(np.ones((4, 3), np.int32)) - b,
    "b-np_int64": lambda m, b: b - np.int64(1),
}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("name", list(_BOOL_OPS))
def test_bool_operands_match_reference(dtype, split, name):
    x = _data(dtype)
    b, rb = ht.array(x, split=split) > 5, hj.array(x, split=split) > 5
    fn = _BOOL_OPS[name]
    _same_outcome(lambda t: fn(ht if isinstance(t, ht.DNDarray) else hj, t), b, rb)


def _bool_pattern(split):
    """A (7, 5) bool array: random, one column all True (every index ties),
    one all False."""
    z = np.random.default_rng(2).standard_normal((7, 5)) > 0
    z[:, 1] = True
    z[:, 3] = False
    return ht.array(z, split=split), hj.array(z, split=split)


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("axis", [None, 0, 1])
@pytest.mark.parametrize("keepdims", [False, True])
def test_argmin_of_bool_matches_reference(split, axis, keepdims):
    """Ties (all True, all False) go to the first index; int64 indices."""
    b, rb = _bool_pattern(split)
    got, want = ht.argmin(b, axis=axis, keepdims=keepdims), hj.argmin(rb, axis=axis, keepdims=keepdims)
    assert got.dtype is ht.int64
    _same(got, want)


_SCALAR_CONVERSIONS = {
    "zero": np.array([0.0], np.float32),
    "fraction": np.array([2.7], np.float32),
    "negative": np.array([[-3.5]], np.float32),
    "int": np.array([[3]], np.int32),
    "true": np.array([True]),
    "false": np.array([[False]]),
}


@pytest.mark.parametrize("split", [None, 0])
@pytest.mark.parametrize("convert", [bool, int, float])
@pytest.mark.parametrize("case", list(_SCALAR_CONVERSIONS))
def test_scalar_conversions_match_reference(split, convert, case):
    data = _SCALAR_CONVERSIONS[case]
    got, want = convert(ht.array(data, split=split)), convert(hj.array(data, split=split))
    assert type(got) is type(want) and got == want


@pytest.mark.parametrize("convert", [bool, int, float])
@pytest.mark.parametrize("data", [np.array([1.0, 2.0], np.float32), np.zeros((0,), np.float32),
                                  np.ones((2, 2), np.int32)], ids=["two", "empty", "2x2"])
def test_scalar_conversions_of_larger_arrays_raise(convert, data):
    with pytest.raises(ValueError):
        convert(hj.array(data))
    with pytest.raises(ValueError):
        convert(ht.array(data, split=0))


def test_dndarray_is_unhashable():
    with pytest.raises(TypeError):
        hash(hj.array([1.0]))
    with pytest.raises(TypeError):
        hash(ht.array([1.0]))


@pytest.mark.parametrize("dtype", DTYPES + [np.float64, np.bool_])
@pytest.mark.parametrize("split", SPLITS)
def test_asarray_matches_reference(dtype, split):
    x = (_data(np.int32) % 3).astype(dtype)
    a, r = ht.array(x, split=split), hj.array(x, split=split)
    _same(np.asarray(a), np.asarray(r))
    _same(np.asarray(a, dtype=np.float64), np.asarray(r, dtype=np.float64))
    _same(np.array(a), np.array(r))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("split", SPLITS)
def test_array_of_a_dndarray_matches_reference(dtype, split):
    """``ht.array`` of a DNDarray: the same array back when nothing is to
    change, a cast copy with the split kept for another dtype; another
    split raises until resplit is ported (the reference resplits)."""
    x = _data(dtype)
    a, r = ht.array(x, split=split), hj.array(x, split=split)
    assert ht.array(a) is a and hj.array(r) is r
    assert ht.array(a, split=split) is a and hj.array(r, split=split) is r
    assert ht.array(a, dtype=dtype) is a and hj.array(r, dtype=dtype) is r
    for target in (ht.float64, ht.int64, ht.bool):
        _same(ht.array(a, dtype=target), hj.array(r, dtype=getattr(hj, target.__name__)))
    other = 1 if split != 1 else 0
    with pytest.raises(NotImplementedError, match="Queue 1 item 4"):
        ht.array(a, split=other)
    assert hj.array(r, split=other).split == other


@pytest.mark.parametrize("split", SPLITS)
def test_array_of_a_dndarray_on_its_device_and_comm(split):
    """The same array back when ``device`` and ``comm`` are its own; another
    communication raises until resplit is ported."""
    a = ht.array(_data(np.float32), split=split)
    assert ht.array(a, device="cpu") is a and ht.array(a, device=ht.devices.cpu, comm=a.comm) is a
    assert ht.array(a, device="cpu", dtype=ht.float64).larray_padded.device.type == "cpu"
    with pytest.raises(NotImplementedError, match="Queue 1 item 4"):
        ht.array(a, comm=ht.Communication(size=3, rank=0))
