"""The port's manipulations.py, the sorting calls and the rest (sort,
split, squeeze, stack, tile, topk, unfold, unique), against heat_tpu's on a
world of one: the types and splits, bounds and refusals of
test_torch_manipulations.py, and the tie orders of the sorts and top-k
(zeros of both signs, NaNs of both signs) bitwise."""

import jax
import numpy as np
import pytest

import heat_tpu as hj
import heat_tpu_torch as ht
from torch_parity import DTYPES, SPLITS, data, same, same_outcome


@pytest.fixture(autouse=True)
def world_of_one():
    ht.use_device("cpu")
    saved = hj.get_comm()
    hj.use_comm(hj.Communication(jax.devices()[:1]))
    try:
        yield
    finally:
        hj.use_comm(saved)


# each case: the call, made with the package as m on one array a (5 x 4)
CASES = {
    "shape": lambda m, a: m.shape(a),
    "sort0": lambda m, a: m.sort(a, 0),
    "sort1": lambda m, a: m.sort(a, 1, descending=True),
    "split_sections": lambda m, a: m.split(a, 5, 0),
    "split_indices": lambda m, a: m.split(a, [1, 3], 0),
    "split1": lambda m, a: m.split(a, [3, 1], 1),
    "split_unequal": lambda m, a: m.split(a, 3, 0),
    "squeeze": lambda m, a: m.squeeze(m.expand_dims(a, 1), 1),
    "squeeze_method": lambda m, a: m.expand_dims(a, 0).squeeze(),
    "stack0": lambda m, a: m.stack([a, a], 0),
    "stack1": lambda m, a: m.stack([a, a, a], 1),
    "stack2": lambda m, a: m.stack([a, a], -1),
    "swapaxes": lambda m, a: m.swapaxes(a, 0, 1),
    "tile": lambda m, a: m.tile(a, 2),
    "tile2": lambda m, a: m.tile(a, (2, 1)),
    "tile3": lambda m, a: m.tile(a, (2, 1, 3)),
    "topk0": lambda m, a: m.topk(a, 2, 0),
    "topk1": lambda m, a: m.topk(a, 3, 1, largest=False),
    "unfold0": lambda m, a: m.unfold(a, 0, 2, 1),
    "unfold1": lambda m, a: m.unfold(a, 1, 3, 2),
    "unique": lambda m, a: m.unique(a),
    "unique_inverse": lambda m, a: m.unique(a, return_inverse=True),
    "unique_axis": lambda m, a: m.unique(a, axis=0),
    "unique_method": lambda m, a: a.unique(),
    "vsplit": lambda m, a: m.vsplit(a, [2]),
    "vstack": lambda m, a: m.vstack([a, a]),
    "sanitize_memory_layout": lambda m, a: m.sanitize_memory_layout(a, "F"),
}


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("dtype", DTYPES)
def test_manipulation_matches_reference(name, dtype):
    a = data(dtype, seed=3)
    if dtype.startswith("int"):
        a = (a % 4).astype(dtype)  # ties for the sorts, top-k and unique
    for split in SPLITS:
        same_outcome(lambda m, x: CASES[name](m, x), [ht.array(a, split=split)], [hj.array(a, split=split)])


def test_sort_and_topk_ties_zeros_and_nans_are_the_references():
    """A stable argsort's order (-0.0 equal to +0.0, NaN last) and
    ``lax.top_k``'s (the total order: +0.0 above -0.0, a NaN of negative
    sign below -inf), the indices bitwise."""
    v = np.array([0.0, -0.0, np.nan, 1.0, -0.0, 0.0, -np.nan, -1.0, 2.0, 2.0, 2.0, 3.0], np.float32)
    for split in (None, 0):
        p, r = ht.array(v, split=split), hj.array(v, split=split)
        for desc in (False, True):
            got, want = ht.sort(p, descending=desc), hj.sort(r, descending=desc)
            np.testing.assert_array_equal(got[1].numpy(), want[1].numpy())
            np.testing.assert_array_equal(got[0].numpy().view(np.int32), want[0].numpy().view(np.int32))
        for largest in (True, False):
            for k in (1, 3, 12):
                got, want = ht.topk(p, k, largest=largest), hj.topk(r, k, largest=largest)
                np.testing.assert_array_equal(got[1].numpy(), want[1].numpy())
                np.testing.assert_array_equal(got[0].numpy().view(np.int32), want[0].numpy().view(np.int32))
    same(ht.sort(ht.array(3.0)), hj.sort(hj.array(3.0)))  # a 0-d array: the flattened argsort's (1,)
    ties = np.array([1, 2, 2, 2, 3], np.int32)
    assert ht.topk(ht.array(ties), 2)[1].numpy().tolist() == hj.topk(hj.array(ties), 2)[1].numpy().tolist() == [4, 1]


def test_unique_collapses_nans_as_the_reference():
    v = np.array([np.nan, np.nan, 1.0, -0.0, 0.0, 1.0], np.float64)
    for split in (None, 0):
        same(ht.unique(ht.array(v, split=split)), hj.unique(hj.array(v, split=split)))
        got = ht.unique(ht.array(v, split=split), return_inverse=True)
        want = hj.unique(hj.array(v, split=split), return_inverse=True)
        same(got, want)


def test_sort_out_and_topk_out_match_reference():
    a = data("float32", seed=5)
    for split in SPLITS:
        po, ro = ht.zeros((5, 4), dtype=ht.float64, split=split), hj.zeros((5, 4), dtype=hj.float64, split=split)
        got = ht.sort(ht.array(a, split=split), 0, out=po)
        want = hj.sort(hj.array(a, split=split), 0, out=ro)
        assert got[0] is po
        same(got, want)
        outs = (ht.zeros((2, 4), split=split), ht.zeros((2, 4), dtype=ht.int64, split=split))
        refs = (hj.zeros((2, 4), split=split), hj.zeros((2, 4), dtype=hj.int64, split=split))
        got = ht.topk(ht.array(a, split=split), 2, 0, out=outs)
        want = hj.topk(hj.array(a, split=split), 2, 0, out=refs)
        assert got[0] is outs[0] and got[1] is outs[1]
        same(got, want)
