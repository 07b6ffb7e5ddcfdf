"""Shared helpers of the port's parity tests (tests/test_torch_ops_*.py):
seeded numpy inputs of each type, and the comparison of a port result with
the reference's.

The port runs on one CPU rank; the reference on the suite's virtual mesh.
A result matches when its type, shape and split are the reference's and its
values are: bitwise for bool and integer results, within the reference's
own test bounds for floats (float32 rtol 3e-5, atol 1e-6, as
tests/test_arithmetics_grid.py:155; float64 rtol 1e-12, as
tests/test_statistics_width.py:53)."""

import numpy as np
import pytest

import heat_tpu as hj
import heat_tpu_torch as ht

DTYPES = ["bool", "int8", "int32", "int64", "float32", "float64", "complex64"]
SPLITS = [None, 0, 1]
SHAPE = (5, 4)  # uneven against the reference's 8 devices


def data(dtype: str, shape=SHAPE, seed: int = 0, positive: bool = False) -> np.ndarray:
    """Seeded values of ``dtype``: small integers (zeros among them), normal
    floats, complex of normal parts; ``positive`` keeps them above 0."""
    rng = np.random.default_rng(seed)
    if dtype == "bool":
        return rng.random(shape) > 0.5
    if dtype.startswith("int") or dtype.startswith("uint"):
        lo = 1 if positive else (0 if dtype.startswith("uint") else -9)
        return rng.integers(lo, 10, shape).astype(dtype)
    if dtype.startswith("complex"):
        v = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
        return v.astype(dtype)
    v = rng.standard_normal(shape) * 2
    return (np.abs(v) + 0.1 if positive else v).astype(dtype)


def bounds(dtype_name: str):
    """The float tolerance of a result type: (rtol, atol)."""
    if dtype_name in ("float64", "complex128"):
        return 1e-12, 1e-12
    return 3e-5, 1e-6


def same(got, want, rtol=None, atol=None, check_split=True):
    """``got`` (the port's) is ``want`` (the reference's): DNDarrays of one
    type, shape and split and the same values; tuples element by element;
    python scalars by value."""
    if isinstance(want, (tuple, list)):
        assert isinstance(got, (tuple, list)) and len(got) == len(want)
        for g, w in zip(got, want):
            same(g, w, rtol, atol, check_split)
        return
    if not isinstance(want, hj.DNDarray):
        assert not isinstance(got, ht.DNDarray), type(got)
        np.testing.assert_allclose(got, want, rtol=rtol or 1e-6, atol=atol or 0)
        return
    assert isinstance(got, ht.DNDarray), type(got)
    assert got.dtype.__name__ == want.dtype.__name__, (got.dtype.__name__, want.dtype.__name__)
    assert tuple(got.shape) == tuple(want.shape), (got.shape, want.shape)
    if check_split:
        assert got.split == want.split, (got.split, want.split)
    g, w = got.numpy(), np.asarray(want.numpy())
    assert g.dtype == w.dtype, (g.dtype, w.dtype)
    if g.dtype.kind in "biu":
        np.testing.assert_array_equal(g, w)
    else:
        r, a = bounds(got.dtype.__name__)
        np.testing.assert_allclose(g, w, rtol=rtol if rtol is not None else r, atol=atol if atol is not None else a)


def same_outcome(fn, port_args, ref_args, **kw):
    """``fn`` over the port's operands gives the reference's result, or
    raises where the reference raises (an exception of the same type)."""
    try:
        want = fn(hj, *ref_args)
    except Exception as e:  # the reference's refusal is the expected outcome
        with pytest.raises(type(e)):
            fn(ht, *port_args)
        return None
    got = fn(ht, *port_args)
    same(got, want, **kw)
    return got


def both(a: np.ndarray, split):
    """``a`` as a port array and as a reference array, split alike."""
    return ht.array(a, split=split), hj.array(a, split=split)
