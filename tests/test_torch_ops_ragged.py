"""The ragged and partition layer of the port (redistribute_, balance_,
lshape_map, counts_displs, is_balanced, __partitioned__, from_partitioned,
from_partition_dict, balance, redistribute) and the layout rule of the
operations: the reference's tests/test_redistribute.py and
tests/test_ragged_propagation.py, each case's expectations restated for the
port.

The metadata cases run on every rank of a described world of three
(``Communication(size=3, rank=r)``: the layout without the collectives);
the cases that move rows run in the gloo world of three
(tests/test_torch_gloo.py), and the round trips through the partition
interface also on one rank here.  The reference's own cases run on its
virtual mesh of the suite's devices, the port's in worlds of three."""

import numpy as np
import pytest

import heat_tpu_torch as ht
from heat_tpu_torch import Communication

WORLD = 3


@pytest.fixture(autouse=True)
def _port_on_cpu():
    ht.use_device("cpu")


def _described(rank):
    return Communication(size=WORLD, rank=rank)


@pytest.mark.parametrize("rank", range(WORLD))
def test_redistribute_1d(rank):
    st = ht.zeros((50,), split=0, comm=_described(rank))
    target = np.zeros((WORLD, 1), np.int64)
    target[1], target[2] = 30, 20
    assert st.redistribute_(target_map=target) is st
    lmap = st.lshape_map
    assert lmap[:, 0].tolist() == [0, 30, 20]
    assert st.counts_displs() == ((0, 30, 20), (0, 0, 30))
    assert not st.is_balanced() and not st.balanced
    assert st.create_lshape_map().tolist() == lmap.tolist()
    # the compute layout is still the canonical one
    assert st.lshape == (17 if rank < 2 else 16,)
    np.testing.assert_array_equal(st.larray.numpy(), np.zeros(st.lshape))


@pytest.mark.parametrize("rank", range(WORLD))
def test_redistribute_2d_split1(rank):
    data = np.arange(50 * 50, dtype=np.float32).reshape(50, 50)
    st = ht.array(data, split=1, comm=_described(rank))
    target = np.zeros((WORLD, 2), np.int64)
    target[0, 1], target[2, 1] = 13, 37
    st.redistribute_(target_map=target)
    assert tuple(st.lshape_map[0]) == (50, 13)
    assert tuple(st.lshape_map[1]) == (50, 0)
    assert tuple(st.lshape_map[2]) == (50, 37)
    assert st.counts_displs() == ((13, 0, 37), (0, 13, 13))
    assert st.is_distributed()


@pytest.mark.parametrize("rank", range(WORLD))
def test_redistribute_3d_and_split_none(rank):
    st = ht.zeros((10, 11, 12), split=2, comm=_described(rank))
    target = np.zeros((WORLD, 3), np.int64)
    target[0, 2] = 12
    st.redistribute_(target_map=target)
    assert tuple(st.lshape_map[0]) == (10, 11, 12)
    assert st.lshape_map[1:, 2].sum() == 0
    sn = ht.zeros((8, 8, 8), split=None, comm=_described(rank))
    sn.redistribute_(target_map=np.zeros((WORLD, 3), np.int64))  # an unsplit array stays as it is
    assert sn.lshape_map[0, 0] == 8 and sn.is_balanced() and not sn.is_distributed()


def test_redistribute_errors():
    st = ht.zeros((50, 81, 67), split=0, comm=_described(0))
    with pytest.raises(ValueError):  # counts do not sum to the extent
        st.redistribute_(target_map=np.zeros((WORLD, 3), np.int64))
    with pytest.raises(TypeError):
        st.redistribute_(target_map="sdfibn")
    with pytest.raises(TypeError):
        st.redistribute_(lshape_map="sdfibn")
    with pytest.raises(ValueError):
        st.redistribute_(lshape_map=np.zeros(2, np.int64))
    with pytest.raises(ValueError):
        st.redistribute_(target_map=np.zeros((2, 4), np.int64))
    with pytest.raises(ValueError):  # negative counts
        bad = np.zeros((WORLD, 3), np.int64)
        bad[0, 0], bad[1, 0] = -1, 51
        st.redistribute_(target_map=bad)
    assert st.is_balanced()


@pytest.mark.parametrize("rank", range(WORLD))
def test_balance_and_canonical_targets(rank):
    comm = _described(rank)
    st = ht.array(np.arange(40, dtype=np.float32), split=0, comm=comm)
    target = np.zeros((WORLD, 1), np.int64)
    target[0] = 40
    st.redistribute_(target_map=target)
    assert not st.is_balanced()
    assert st.balance_() is st and st.is_balanced()
    assert st._ragged_layout is None
    st.redistribute_(target_map=target)
    st.redistribute_(target_map=comm.lshape_map((40,), 0))  # canonical: drops the ragged layout
    assert st.is_balanced()
    st.redistribute_(target_map=target)
    st.redistribute_()  # no target balances
    assert st.is_balanced()
    # a torch tensor or a DNDarray serves as a map too
    import torch

    st.redistribute_(target_map=torch.from_numpy(target))
    assert st.lshape_map[:, 0].tolist() == [40, 0, 0]
    st.redistribute_(target_map=ht.array(comm.lshape_map((40,), 0), comm=Communication()))
    assert st.is_balanced()


def _ragged_pair(rank):
    comm = _described(rank)
    data = np.arange(40 * 6, dtype=np.float32).reshape(40, 6)
    a = ht.array(data, split=0, comm=comm)
    b = ht.array(2.0 * data, split=0, comm=comm)
    tm = np.zeros((WORLD, 2), np.int64)
    tm[0, 0], tm[-1, 0] = 40 // 3, 40 - 40 // 3
    a.redistribute_(target_map=tm)
    return a, b, tm, data, comm


def _local(data, comm, split=0):
    return data[comm.chunk(data.shape, split)[2]]


@pytest.mark.parametrize("rank", range(WORLD))
def test_binary_adopts_lhs_layout(rank):
    a, b, tm, data, comm = _ragged_pair(rank)
    res = a + b
    assert not res.is_balanced()
    np.testing.assert_array_equal(res.lshape_map, a.lshape_map)
    assert res.counts_displs()[0] == tuple(int(c) for c in tm[:, 0])
    np.testing.assert_allclose(res.larray.numpy(), 3.0 * _local(data, comm))
    # the balanced lhs wins over a ragged rhs
    assert (b + a).is_balanced()


@pytest.mark.parametrize("rank", range(WORLD))
def test_scalar_unary_and_scan_keep_layout(rank):
    a, b, tm, data, comm = _ragged_pair(rank)
    for res in (a * 2, 2 * a, a + 1, 1 + a, a % 3, -a, abs(a), ht.exp(a * 0.01), ht.cumsum(a, axis=1),
                ht.round(a, 1), ht.clip(a, 0, 5), ht.sin(a), ht.sqrt(a), ht.add(a, b, where=a > 3)):
        assert not res.is_balanced(), res
        assert tuple(res.lshape_map[:, 0]) == tuple(tm[:, 0])
    np.testing.assert_allclose(ht.cumsum(a, axis=1).larray.numpy(), np.cumsum(_local(data, comm), axis=1))


@pytest.mark.parametrize("rank", range(WORLD))
def test_shape_changing_ops_come_back_balanced(rank):
    a, b, _, data, comm = _ragged_pair(rank)
    assert ht.sum(a, axis=1).is_balanced()
    assert ht.max(a, axis=1, keepdims=True).is_balanced()
    assert a.T.is_balanced()
    assert ht.diff(a, axis=1).is_balanced()
    assert a.copy().is_balanced()
    assert ht.balance(a, copy=True).is_balanced()
    assert ht.balance(a) is a and not a.is_balanced()


@pytest.mark.parametrize("rank", range(WORLD))
def test_inplace_and_out_keep_layout(rank):
    a, b, tm, data, comm = _ragged_pair(rank)
    a += b  # in-place: a is the lhs and the output, its layout survives
    assert not a.is_balanced()
    assert tuple(a.lshape_map[:, 0]) == tuple(tm[:, 0])
    np.testing.assert_allclose(a.larray.numpy(), 3.0 * _local(data, comm))
    out = ht.zeros_like(b)
    out.redistribute_(target_map=tm)
    assert ht.add(a, b, out=out) is out  # out keeps its own layout
    assert not out.is_balanced()
    np.testing.assert_allclose(out.larray.numpy(), 5.0 * _local(data, comm))
    plain = ht.zeros_like(b)
    ht.add(a, b, out=plain)
    assert plain.is_balanced()
    res = ht.redistribute(b, target_map=tm)
    assert not res.is_balanced() and b.is_balanced()


@pytest.mark.parametrize("rank", range(WORLD))
def test_balance_drops_adopted_layout(rank):
    a, b, _, data, comm = _ragged_pair(rank)
    res = a + b
    res.balance_()
    assert res.is_balanced()
    np.testing.assert_allclose(res.larray.numpy(), 3.0 * _local(data, comm))


def test_partition_interface_on_one_rank():
    data = np.arange(30 * 4, dtype=np.float64).reshape(30, 4)
    src = ht.array(data, split=0)
    parts = src.__partitioned__
    assert parts["shape"] == (30, 4) and parts["partition_tiling"] == (1, 1)
    key = (0, 0)
    assert parts["partitions"][key]["start"] == (0, 0) and parts["partitions"][key]["shape"] == (30, 4)
    assert parts["partitions"][key]["dtype"] == np.dtype(np.float64)
    np.testing.assert_array_equal(np.asarray(parts["get"](parts["partitions"][key]["data"])), data)
    rebuilt = ht.from_partitioned(src)
    np.testing.assert_array_equal(rebuilt.numpy(), data)
    # one rank's tiling cuts no axis: the rebuilt array is whole (the gloo
    # world of three rebuilds it split along 0)
    assert rebuilt.split is None and rebuilt.is_balanced()
    # a dict made by hand, every partition with its data, two along rows
    hand = {"shape": (30, 4), "partition_tiling": (2, 1), "get": lambda h: h,
            "partitions": {(0, 0): {"start": (0, 0), "shape": (10, 4), "data": data[:10]},
                           (1, 0): {"start": (10, 0), "shape": (20, 4), "data": data[10:]}},
            "locals": [(0, 0)]}
    again = ht.from_partition_dict(hand)
    assert again.split == 0
    np.testing.assert_array_equal(again.numpy(), data)
    whole = ht.array(data)
    same = ht.from_partitioned(whole)
    assert same.split is None
    np.testing.assert_array_equal(same.numpy(), data)


def test_redistribute_on_one_rank_is_canonical():
    a = ht.array(np.arange(12.0).reshape(4, 3), split=0)
    a.redistribute_(target_map=np.array([[4, 3]]))
    assert a.is_balanced() and not a.is_distributed()
    with pytest.raises(ValueError):
        a.redistribute_(target_map=np.array([[3, 3]]))
    b = ht.redistribute(a, target_map=np.array([[4, 3]]))
    assert b is not a and b.is_balanced()
    np.testing.assert_array_equal(b.numpy(), a.numpy())


def test_widened_reshard_waits_for_item_15():
    """Item 15b came: onto a (described) world of 3 the array is a resharded
    copy holding rank 0's canonical chunk."""
    a = ht.array(np.arange(6), split=0)
    three = Communication(size=3, rank=0)
    b = ht.array(a, comm=three)
    assert b.comm is three and a.comm is not three and b.lshape == (2,)
    np.testing.assert_array_equal(b.larray.numpy(), np.arange(2))
