"""heat_tpu_torch against heat_tpu: the canonical layout, DNDarray
construction and the element-wise / reducing operations of the KMeans path.

Inputs are made with numpy from a seed and given to both packages; the port
runs on the CPU."""

import jax
import numpy as np
import pytest
import torch

import heat_tpu as hj
import heat_tpu_torch as ht
from heat_tpu_torch.parallel.comm import Communication


@pytest.fixture(autouse=True)
def _port_on_cpu():
    ht.use_device("cpu")


def _points(n=1003, f=16, seed=0):
    return np.random.default_rng(seed).standard_normal((n, f)).astype(np.float32)


def test_arange_matches_reference():
    a = ht.arange(10, split=0)
    r = hj.arange(10, split=0)
    assert a.dtype.__name__ == r.dtype.__name__ == "int32"
    assert a.shape == r.shape and a.split == r.split == 0
    np.testing.assert_array_equal(a.numpy(), r.numpy())


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int64, np.int32])
@pytest.mark.parametrize("split", [None, 0])
def test_array_matches_reference(dtype, split):
    x = (_points(37, 5) * 10).astype(dtype)
    a = ht.array(x, split=split)
    r = hj.array(x, split=split)
    assert a.dtype.__name__ == r.dtype.__name__
    np.testing.assert_array_equal(a.numpy(), r.numpy())


def test_python_data_defaults_match_reference():
    for data in ([1.5, 2.5], [[1, 2], [3, 4]], [True, False]):
        assert ht.array(data).dtype.__name__ == hj.array(data).dtype.__name__


@pytest.mark.parametrize("size", [1, 3, 8])
@pytest.mark.parametrize("gshape", [(1003, 16), (10,), (7, 3)])
def test_layout_metadata_matches_reference(size, gshape):
    """lshape_map and counts_displs equal the JAX Communication's over the
    same number of participants, for every rank's view."""
    ref_comm = hj.Communication(jax.devices()[:size])
    data = np.arange(int(np.prod(gshape)), dtype=np.float32).reshape(gshape)
    ref = hj.array(data, split=0, comm=ref_comm)
    for rank in range(size):
        comm = Communication(size=size, rank=rank)
        np.testing.assert_array_equal(comm.lshape_map(gshape, 0), ref_comm.lshape_map(gshape, 0))
        arr = ht.array(data, split=0, comm=comm)
        np.testing.assert_array_equal(arr.lshape_map, ref.lshape_map)
        assert arr.counts_displs() == ref.counts_displs()
        off, lshape, _ = ref_comm.chunk(gshape, 0, rank=rank)
        assert arr.lshape == tuple(lshape)
        np.testing.assert_array_equal(arr.larray.numpy(), data[off : off + lshape[0]])
        per = ref_comm.padded_extent(gshape[0]) // size
        assert arr.larray_padded.shape[0] == per


def test_metadata_only_comm_refuses_collectives():
    comm = Communication(size=3, rank=1)
    with pytest.raises(RuntimeError, match="joined no process group"):
        comm.psum(torch.zeros(2))


def test_default_device_is_the_card():
    ht.use_device("gpu")
    try:
        assert ht.get_device() == "gpu"
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="use_device"):
                ht.arange(3)
    finally:
        ht.use_device("cpu")
    assert ht.arange(3, device="cpu").larray_padded.device.type == "cpu"


@pytest.mark.parametrize("split", [None, 0])
def test_binary_ops_match_reference(split):
    x, y = _points(53, 4, 1), _points(53, 4, 2)
    a, b = ht.array(x, split=split), ht.array(y, split=split)
    ra, rb = hj.array(x, split=split), hj.array(y, split=split)
    row = ht.array(y[0])
    rrow = hj.array(y[0])
    for got, want in [
        (a + b, ra + rb),
        (a - b, ra - rb),
        (a * b, ra * rb),
        (a / (b * b + 1), ra / (rb * rb + 1)),
        (a**2, ra**2),
        (2.0 - a, 2.0 - ra),
        (1 + a, 1 + ra),
        (2.0 * a, 2.0 * ra),
        (a * row, ra * rrow),
        (-a, -ra),
    ]:
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6)
        assert got.split == want.split


_NUMPY_OPERANDS = [
    np.float32(2.0),
    np.float64(2.0),
    np.int64(3),
    np.arange(1, 4, dtype=np.float64),
    np.arange(1, 4, dtype=np.int64),
    np.arange(1, 4, dtype=np.float32),
]


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("split", [None, 0, 1])
@pytest.mark.parametrize("op", ["add", "sub", "mul", "div", "pow"])
@pytest.mark.parametrize("first", [False, True])
def test_numpy_operands_match_reference(dtype, split, op, first):
    """Numpy scalars and arrays meet a DNDarray as the reference's
    ``_as_dndarray`` has them: of their own type, which promotes the
    result's exactly as the reference's does."""
    x = np.arange(1, 13, dtype=dtype).reshape(4, 3)
    for other in _NUMPY_OPERANDS:
        a, r = ht.array(x, split=split), hj.array(x, split=split)
        got = getattr(ht, op)(other, a) if first else getattr(ht, op)(a, other)
        want = getattr(hj, op)(other, r) if first else getattr(hj, op)(r, other)
        assert got.dtype.__name__ == want.dtype.__name__, (other, op)
        assert got.shape == want.shape and got.split == want.split
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6)
    # the operator forms, with the DNDarray on the left and through __r*__
    a, r = ht.array(x, split=split), hj.array(x, split=split)
    for other in _NUMPY_OPERANDS:
        assert (a * other).dtype.__name__ == (r * other).dtype.__name__
        assert a.__rmul__(other).dtype.__name__ == r.__rmul__(other).dtype.__name__


@pytest.mark.parametrize("split", [None, 0])
@pytest.mark.parametrize("axis", [None, 0, 1])
def test_reductions_match_reference(split, axis):
    x = _points(1003, 6, 3)
    a, r = ht.array(x, split=split), hj.array(x, split=split)
    np.testing.assert_allclose(ht.sum(a, axis=axis).numpy(), hj.sum(r, axis=axis).numpy(), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(ht.mean(a, axis=axis).numpy(), hj.mean(r, axis=axis).numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(ht.min(a, axis=axis).numpy(), hj.min(r, axis=axis).numpy())
    np.testing.assert_array_equal(ht.max(a, axis=axis).numpy(), hj.max(r, axis=axis).numpy())
    got, want = ht.argmin(a, axis=axis), hj.argmin(r, axis=axis)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert got.split == want.split


def test_integer_sum_and_padding_mask():
    """A sum over the split axis ignores the padding of a rank's chunk."""
    comm = Communication(size=3, rank=2)
    a = ht.arange(10, split=0, comm=comm)  # rank 2 holds 8, 9 and one pad entry
    assert a.larray_padded.shape[0] == 4 and a.lshape == (2,)
    a.larray_padded[-1] = 1000
    assert int(a._masked(0).sum()) == 17
    assert ht.sum(ht.arange(10, split=0)).item() == hj.sum(hj.arange(10, split=0)).item() == 45


@pytest.mark.parametrize("split", [None, 0])
def test_matmul_and_norm_match_reference(split):
    x, c = _points(101, 16, 4), _points(8, 16, 5)
    a, r = ht.array(x, split=split), hj.array(x, split=split)
    got = ht.matmul(a, ht.array(c.T.copy()))
    want = hj.matmul(r, hj.array(c.T.copy()))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
    assert got.split == want.split
    np.testing.assert_array_equal((a @ ht.array(c.T.copy())).numpy(), got.numpy())
    np.testing.assert_allclose(ht.norm(a).numpy(), hj.norm(r).numpy(), rtol=1e-6)
    np.testing.assert_allclose(ht.norm(a, axis=1).numpy(), hj.norm(r, axis=1).numpy(), rtol=1e-6)


@pytest.mark.parametrize("quadratic_expansion", [False, True])
@pytest.mark.parametrize("split", [None, 0])
def test_cdist_matches_reference(split, quadratic_expansion):
    x, y = _points(203, 16, 6), _points(9, 16, 7)
    got = ht.spatial.cdist(ht.array(x, split=split), ht.array(y), quadratic_expansion=quadratic_expansion)
    want = hj.spatial.cdist(hj.array(x, split=split), hj.array(y), quadratic_expansion=quadratic_expansion)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(ht.argmin(got, axis=1).numpy(), hj.argmin(want, axis=1).numpy())


def test_astype_and_types():
    a = ht.arange(5, split=0).astype(ht.float64)
    assert a.dtype is ht.float64 and a.larray_padded.dtype == torch.float64
    assert ht.types.heat_type_is_inexact(ht.float32) and ht.types.heat_type_is_exact(ht.int64)
    assert ht.types.promote_types(ht.int32, ht.float32) is ht.float32
    assert ht.types.canonical_heat_type("float64") is ht.float64
    assert ht.zeros((4, 3), split=0).numpy().sum() == 0
    assert ht.empty((4, 3)).shape == (4, 3)
