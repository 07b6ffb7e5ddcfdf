"""The port's type system against heat_tpu's: every pair of the fifteen
concrete types through ``promote_types``, ``result_type`` and ``can_cast``
in all five modes, python scalars as weak operands, ``iinfo``/``finfo``
(bfloat16 too), ``issubdtype`` and the aliases, all exactly equal.  The
reference runs with x64 on (tests/conftest.py), as the port always does.
Casts between all the types, on the holding tensors, against the
reference's ``astype`` where the cast is exact."""

import numpy as np
import pytest

import heat_tpu as hj
import heat_tpu_torch as ht

NAMES = ["bool", "int8", "int16", "int32", "int64", "uint8", "uint16", "uint32", "uint64", "float16", "bfloat16",
         "float32", "float64", "complex64", "complex128"]
MODES = ["no", "safe", "same_kind", "unsafe", "intuitive"]
SCALARS = [True, 3, -2, 2.5, 1j]
ABSTRACT = ["datatype", "generic", "number", "integer", "signedinteger", "unsignedinteger", "floating",
            "complexfloating", "complex", "flexible"]


@pytest.fixture(autouse=True)
def _port_on_cpu():
    ht.use_device("cpu")


def _pair(name):
    return getattr(ht, name), getattr(hj, name)


@pytest.mark.parametrize("a", NAMES)
def test_promotion_and_casting_match_reference(a):
    pa, ra = _pair(a)
    for b in NAMES:
        pb, rb = _pair(b)
        assert ht.promote_types(pa, pb).__name__ == hj.promote_types(ra, rb).__name__, (a, b)
        assert ht.result_type(pa, pb).__name__ == hj.result_type(ra, rb).__name__, (a, b)
        for mode in MODES:
            assert ht.can_cast(pa, pb, mode) == hj.can_cast(ra, rb, mode), (a, b, mode)
    for s in SCALARS:
        assert ht.result_type(pa, s).__name__ == hj.result_type(ra, s).__name__, (a, s)
        for mode in MODES:
            assert ht.can_cast(s, pa, mode) == hj.can_cast(s, ra, mode), (a, s, mode)


def test_torch_disagrees_where_the_lattice_is_jax():
    """The pairs where torch's own promotion differs from the reference's."""
    assert ht.promote_types(ht.int64, ht.uint64) is ht.float64
    assert ht.promote_types(ht.uint32, ht.int32) is ht.int64
    assert ht.promote_types(ht.uint16, ht.int16) is ht.int32
    assert ht.promote_types(ht.int32, ht.float16) is ht.float16
    assert ht.promote_types(ht.bfloat16, ht.float16) is ht.float32


@pytest.mark.parametrize("args", [(1, 2), (1, 2.0), (True,), (1.0, 1j), (True, False), (2.5,)])
def test_result_type_of_scalars_alone(args):
    assert ht.result_type(*args).__name__ == hj.result_type(*args).__name__


def test_result_type_of_arrays_and_numpy():
    assert ht.result_type(ht.array([1, 2], dtype=ht.uint8), 300).__name__ == \
        hj.result_type(hj.array([1, 2], dtype=hj.uint8), 300).__name__
    assert ht.result_type(np.zeros(2, np.int16), ht.float16) is ht.float16
    assert ht.result_type(np.float32(1.0), 2) is ht.float32


@pytest.mark.parametrize("name", NAMES)
def test_iinfo_finfo_match_reference(name):
    p, r = _pair(name)
    if issubclass(r, hj.integer):
        a, b = ht.iinfo(p), hj.iinfo(r)
        assert (a.bits, a.min, a.max, a.dtype.__name__) == (b.bits, b.min, b.max, b.dtype.__name__)
        assert repr(a) == repr(b)
    elif issubclass(r, (hj.floating, hj.complexfloating)):
        a, b = ht.finfo(p), hj.finfo(r)
        assert (a.bits, a.eps, a.max, a.min, a.tiny, a.resolution) == (b.bits, b.eps, b.max, b.min, b.tiny,
                                                                         b.resolution)
        assert repr(a) == repr(b)
    else:
        with pytest.raises(ValueError):
            ht.iinfo(p)
        with pytest.raises(ValueError):
            ht.finfo(p)


@pytest.mark.parametrize("name", NAMES + ABSTRACT)
def test_issubdtype_and_predicates_match_reference(name):
    p, r = _pair(name)
    for other in NAMES + ABSTRACT:
        q, s = _pair(other)
        assert ht.issubdtype(p, q) == hj.issubdtype(r, s), (name, other)
    if name in NAMES:
        for pred in ("heat_type_is_exact", "heat_type_is_inexact", "heat_type_is_realfloating",
                     "heat_type_is_complexfloating"):
            assert getattr(ht, pred)(p) == getattr(hj, pred)(r), (name, pred)
        assert ht.canonical_heat_type(name) is p
        assert ht.heat_type_of(ht.zeros(2, dtype=p)) is p


def test_aliases_and_python_types():
    for alias in ("byte", "short", "ubyte", "half", "float_", "double", "cfloat", "csingle", "cdouble", "generic",
                  "bool_", "int", "long", "float"):
        assert getattr(ht, alias).__name__ == getattr(hj, alias).__name__, alias
    for obj in (True, 3, 2.5, 1j, [1, 2], [1.5]):
        assert ht.heat_type_of(obj).__name__ == hj.heat_type_of(obj).__name__
    for t in (bool, int, float, complex, "int", "float", np.uint16, np.dtype("uint32"), "uint64", "bfloat16"):
        assert ht.canonical_heat_type(t).__name__ == hj.canonical_heat_type(t).__name__
    with pytest.raises(TypeError):
        ht.canonical_heat_type(ht.floating)


def test_holding_dtypes_and_x64():
    """uint16 is held in int32, uint32 in int64, uint64 in int64's bits;
    64-bit types cannot be switched off."""
    assert ht.uint16.torch_type() is __import__("torch").int32
    assert ht.canonical_dtype(ht.uint64) is __import__("torch").int64
    ht.enable_x64(True)
    with pytest.raises(NotImplementedError):
        ht.enable_x64(False)


def test_calling_a_type_casts():
    a, r = ht.float32([1, 2]), hj.float32([1, 2])
    assert a.dtype is ht.float32 and a.numpy().tolist() == r.numpy().tolist()
    assert ht.uint64(2**64 - 1).item() == 2**64 - 1
    with pytest.raises(TypeError):
        ht.int32(1j)


def _values(name):
    """Values every type holds exactly, and its extremes."""
    if name == "bool":
        return np.array([True, False, True])
    if name.startswith(("int", "uint")):
        info = np.iinfo(name)
        return np.array([0, 1, 7, 100, info.max, info.min, info.max - 1], dtype=name)
    if name.startswith("complex"):
        return np.array([1 + 2j, -3.5, 0.25j], dtype=name)
    if name == "bfloat16":
        return np.array([1.0, -2.5, 0.375, 256.0], dtype=np.float32)
    return np.array([1.0, -2.5, 0.375, 256.0, 1e3], dtype=name)


@pytest.mark.parametrize("src", NAMES)
def test_astype_between_all_types_matches_reference(src):
    """Every cast the reference gives exactly (integer wrap-around, float
    truncation of values in range, uint64's top bit): the values and the
    type; where the reference's value is not exact in the target the cast
    is not compared."""
    v = _values(src)
    a = ht.array(v, dtype=getattr(ht, src), split=0)
    r = hj.array(v, dtype=getattr(hj, src), split=0)
    for dst in NAMES:
        got = a.astype(getattr(ht, dst))
        want = r.astype(getattr(hj, dst))
        assert got.dtype.__name__ == dst and got.split == 0
        w = np.asarray(want.numpy())
        if dst == "bfloat16":
            w = w.astype(np.float32)
        g = got.numpy()
        exact = np.ones(len(v), bool)
        if src.startswith(("float", "bfloat", "complex")) and dst.startswith(("int", "uint", "bool")):
            real = np.real(v).astype(np.float64)
            info = np.iinfo(dst) if dst != "bool" else None
            exact = (real >= info.min) & (real <= info.max) if info is not None else exact
        np.testing.assert_array_equal(g[exact], w[exact], err_msg=f"{src} -> {dst}")


def test_iscomplex_isreal_match_reference():
    x = np.array([1 + 0j, 2j, -3.5])
    for split in (None, 0):
        for data in (x, x.real):
            a, r = ht.array(data, split=split), hj.array(data, split=split)
            for fn in ("iscomplex", "isreal"):
                got, want = getattr(ht, fn)(a), getattr(hj, fn)(r)
                assert got.dtype is ht.bool and got.split == want.split
                np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_sanitation_matches_reference():
    from heat_tpu.core import sanitation as rs
    from heat_tpu_torch.core import sanitation as ps

    for dtype in (np.float32, np.float16, np.int32, np.uint8, np.int64):
        x = np.zeros(3, dtype)
        assert ps.sanitize_infinity(ht.array(x)) == rs.sanitize_infinity(hj.array(x))
    assert ps.sanitize_sequence((1, 2)) == rs.sanitize_sequence((1, 2)) == [1, 2]
    for bad in ({1}, "ab"):
        with pytest.raises(TypeError):
            ps.sanitize_sequence(bad)
    s = ps.scalar_to_1d(ht.array(2.5))
    assert s.shape == rs.scalar_to_1d(hj.array(2.5)).shape == (1,) and s.item() == 2.5
    a = ht.array(np.arange(6, dtype=np.float32).reshape(2, 3), split=0)
    ps.sanitize_lshape(a, a.larray)
    with pytest.raises(ValueError):
        ps.sanitize_lshape(a, a.larray[:1])
    with pytest.raises(TypeError):
        ps.sanitize_in(np.zeros(2))
    with pytest.raises(TypeError):
        ps.sanitize_in_nd_realfloating(ht.array([1, 2]), "x", (1,))
    with pytest.raises(ValueError):
        ps.sanitize_in_nd_realfloating(a, "x", (1,))
    ps.sanitize_in_tensor(a.larray)
    with pytest.raises(TypeError):
        ps.sanitize_in_tensor(np.zeros(2))
    out = ht.zeros((2, 3), dtype=ht.int32, split=1)
    assert ps.store_out(a, out) is out and out.split == 1 and out.dtype is ht.int32
    np.testing.assert_array_equal(out.numpy(), np.arange(6).reshape(2, 3))
    with pytest.raises(ValueError):
        ps.sanitize_out(ht.zeros((3, 3)), (2, 3), 0, None)
