"""The port's napi (heat_tpu_torch/core/napi.py) against heat_tpu's on a
world of one: every name of its ``__all__`` over seeded float32, float64
and int32 inputs (NaNs, ties and zeros among them) and the splits None, 0
and 1, each result's type, shape and split the reference's, its values
bitwise for integer, index, bool and order results and within the
reference's own bounds for floats (float32 rtol 3e-5, atol 1e-6; float64
1e-12, the products 1e-10 as tests/test_napi.py:121-127 holds them); calls
the reference refuses raise here too."""

import jax
import numpy as np
import pytest

import heat_tpu as hj
import heat_tpu_torch as ht
from torch_napi_cases import ONE
from torch_parity import SPLITS, data, same, same_outcome


@pytest.fixture(autouse=True)
def world_of_one():
    ht.use_device("cpu")
    saved = hj.get_comm()
    hj.use_comm(hj.Communication(jax.devices()[:1]))
    try:
        yield
    finally:
        hj.use_comm(saved)


def _values(dtype, seed=40, nans=False):
    """7 x 5 values with ties (and NaNs, zeros of both signs where asked)."""
    a = data(dtype, shape=(7, 5), seed=seed)
    a[3] = a[1]  # tied rows
    if dtype.startswith("float"):
        a[2, 2] = 0.0
        a[5, 2] = -0.0
        if nans:
            a[0, 1] = a[4, 3] = np.nan
            a[:, 4] = np.nan  # an all-NaN column
    return a


@pytest.mark.parametrize("name", sorted(ONE))
@pytest.mark.parametrize("dtype", ["float32", "float64", "int32"])
def test_napi_matches_reference(name, dtype):
    products = name.split("_")[0] in ("corrcoef", "inner", "tensordot", "einsum")
    kw = {"rtol": 1e-10, "atol": 1e-10} if products and dtype == "float64" else {}
    for nans in ((False, True) if name.startswith("nan") and dtype != "int32" else (False,)):
        a = _values(dtype, nans=nans)
        for split in SPLITS:
            same_outcome(ONE[name], [ht.array(a, split=split)], [hj.array(a, split=split)], **kw)


@pytest.mark.parametrize("split", SPLITS)
def test_bool_and_byte_calls(split):
    a = data("bool", shape=(6, 11), seed=41)
    b = data("int32", shape=(6, 11), seed=42)
    u8 = np.random.default_rng(43).integers(0, 256, (4, 3)).astype(np.uint8)
    calls = {
        "packbits": lambda m, x: m.packbits(x),
        "packbits_axis": lambda m, x: m.packbits(x, axis=1),
        "packbits_little": lambda m, x: m.packbits(x, axis=0, bitorder="little"),
        "count_nonzero": lambda m, x: m.count_nonzero(x, axis=1),
        "argwhere": lambda m, x: m.argwhere(x),
        "argsort": lambda m, x: m.argsort(x, axis=1),
        "ptp_int": lambda m, x: m.ptp(x * 1, axis=0),
    }
    for name, fn in calls.items():
        same_outcome(fn, [ht.array(a, split=split)], [hj.array(a, split=split)])
    for fn in (lambda m, x: m.packbits(x), lambda m, x: m.partition(x, 1, axis=0),
               lambda m, x: m.argpartition(x, 2), lambda m, x: m.histogram_bin_edges(x, 4)):
        same_outcome(fn, [ht.array(b, split=split)], [hj.array(b, split=split)])
    for fn in (lambda m, x: m.unpackbits(x), lambda m, x: m.unpackbits(x, axis=1),
               lambda m, x: m.unpackbits(x, axis=0, count=5, bitorder="little"),
               lambda m, x: m.unpackbits(x, axis=1, count=-3)):
        same_outcome(fn, [ht.array(u8, split=split)], [hj.array(u8, split=split)])


def test_sort_order_rules():
    """Stable sorts with -0.0 equal to +0.0 and NaN last whatever its sign;
    partition's values as lax.top_k picks them (the IEEE total order)."""
    v = np.array([1.0, -0.0, np.nan, 0.0, -np.nan, -1.0, 1.0, 0.0, np.inf, -np.inf], np.float32)
    for fn in (lambda m, x: m.argsort(x), lambda m, x: m.argsort(x, descending=True),
               lambda m, x: m.lexsort((x, x[::-1])), lambda m, x: m.sort_complex(x),
               lambda m, x: m.argpartition(x, 4)):
        same_outcome(fn, [ht.array(v)], [hj.array(v)])
    got, want = ht.partition(ht.array(v), 4).numpy(), np.asarray(hj.partition(hj.array(v), 4).numpy())
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    c = (data("float32", (9,), seed=44) + 1j * data("float32", (9,), seed=45)).astype(np.complex64)
    c[3] = c[5].real + 0j
    same_outcome(lambda m, x: m.sort_complex(x), [ht.array(c)], [hj.array(c)])
    srt = np.sort(data("float64", (20,), seed=46))
    q = np.concatenate([srt[[0, 5, 19]], [-9.0, 9.0, 0.1]])
    for side in ("left", "right"):
        same_outcome(lambda m, a, w: m.searchsorted(a, w, side=side), [ht.array(srt), ht.array(q)],
                     [hj.array(srt), hj.array(q)])
    perm = np.random.default_rng(47).permutation(20)
    same_outcome(lambda m, a, w: m.searchsorted(a, w, sorter=perm.argsort()), [ht.array(srt[perm]), ht.array(q)],
                 [hj.array(srt[perm]), hj.array(q)])


def test_factories_grids_and_copyto():
    for fn in (lambda m: m.tri(4, 5, 1), lambda m: m.tri(3, dtype=m.int32, k=-1), lambda m: m.tri(5, 2, split=0),
               lambda m: m.mgrid[0:3, 0:2], lambda m: m.ogrid[0:4], lambda m: m.ogrid[0:2, 1:4],
               lambda m: m.mgrid[0:1:5j]):
        same_outcome(fn, [], [])
    for split in SPLITS:
        a = data("float32", (6, 4), seed=48)
        p, r = ht.array(a.copy(), split=split), hj.array(a.copy(), split=split)
        ht.copyto(p, 0.0, where=p > 0)
        hj.copyto(r, 0.0, where=r > 0)
        same(p, r)
        ht.copyto(p, ht.array(a[0]))
        hj.copyto(r, hj.array(a[0]))
        same(p, r)


def test_predicates_strings_and_conversions():
    a = data("float64", (4, 3), seed=49)
    x, y = ht.array(a, split=0), hj.array(a, split=0)
    assert ht.isscalar(3.0) and not ht.isscalar(x) and ht.isscalar("s") == hj.isscalar("s")
    assert ht.iscomplexobj(ht.array([1 + 2j])) and not ht.iscomplexobj(x) and ht.isrealobj(x)
    assert ht.iscomplexobj(np.ones(2, np.complex64)) and not ht.isfortran(x)
    with pytest.raises(TypeError):
        ht.isnat(x)
    assert ht.base_repr(10, 3, 2) == hj.base_repr(10, 3, 2)
    assert ht.binary_repr(-3, 5) == hj.binary_repr(-3, 5)
    assert ht.format_float_positional(ht.array([1.5]), precision=2) == hj.format_float_positional(
        hj.array([1.5]), precision=2)
    assert ht.format_float_scientific(2.5e-7, precision=3) == hj.format_float_scientific(2.5e-7, precision=3)
    assert ht.array2string(x) == hj.array2string(y)
    assert ht.array_repr(x) == hj.array_repr(y) and ht.array_str(x) == hj.array_str(y)
    assert ht.einsum_path("ij,jk->ik", x, ht.array(a.T)) == hj.einsum_path("ij,jk->ik", y, hj.array(a.T))
    b_p, b_r = ht.broadcast(x, ht.array(a[0])), hj.broadcast(y, hj.array(a[0]))
    assert (b_p.shape, b_p.ndim, b_p.nd, b_p.size, b_p.numiter) == (b_r.shape, b_r.ndim, b_r.nd, b_r.size,
                                                                     b_r.numiter)
    for fn in (lambda m: m.asfarray(m.array([1, 2])), lambda m: m.ascontiguousarray([1, 2]),
               lambda m: m.asanyarray([1.5]), lambda m: m.asfortranarray([[1, 2]], dtype=m.float64),
               lambda m: m.require([3, 4], dtype=m.int64), lambda m: m.asmatrix([[1.0, 2.0]]),
               lambda m: m.mat(m.array([1, 2])), lambda m: m.asarray_chkfinite(m.array([1.0, np.inf])),
               lambda m: m.asarray_chkfinite([1.0, 2.0]), lambda m: m.bmat("1 2")):
        same_outcome(fn, [], [])
    with pytest.raises(ValueError):
        ht.asmatrix(ht.zeros((2, 2, 2)))
    t = np.arange(6, dtype=np.float32)
    got = ht.from_dlpack(__import__("torch").from_numpy(t))
    np.testing.assert_array_equal(got.numpy(), t)
    assert got.split is None and got.dtype == ht.float32


def test_quantiles_sort_in_blocks_as_a_whole(monkeypatch):
    """Slices sorted a block of rows at a time (the block budget patched to
    7 elements) give the reference's quantiles."""
    from heat_tpu_torch.core import napi

    monkeypatch.setattr(napi, "_QUANTILE_BLOCK", 7)
    a = _values("float64", nans=True).reshape(7, 5, 1) * np.ones((1, 1, 3))
    calls = (lambda m, x: m.nanquantile(x, [0.2, 0.7], axis=0), lambda m, x: m.quantile(x, 0.5, axis=(0, 2)),
             lambda m, x: m.nanmedian(x, axis=1, keepdims=True), lambda m, x: m.nanpercentile(x, 30.0))
    for call in calls:
        same_outcome(call, [ht.array(a, split=0)], [hj.array(a, split=0)])


def test_every_name_is_exported_as_the_reference_exports_it():
    from heat_tpu.core import napi as ref_napi

    assert ht.core.napi.__all__ == ref_napi.__all__
    for name in ref_napi.__all__:
        assert getattr(ht, name) is getattr(ht.core.napi, name), name
