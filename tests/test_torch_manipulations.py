"""The port's manipulations.py (broadcasting, joining, diagonals,
flattening and flipping, and every call on a vector), memory.py and
tiling.py against heat_tpu's on a world of one, over the types bool, int8,
int32, int64, float32, float64 and complex64 and the splits None, 0 and 1:
results of the reference's type, shape and split, integers bitwise and
floats within the reference's bounds (tests/torch_parity.py), a refusal of
the reference's exception type.  The reference runs on a one-device
Communication: a few routes (top-k's merge) depend on the world's size.
The rest of the module: test_torch_manipulations_rows.py and
test_torch_manipulations_sort.py."""

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
    "broadcast_to": lambda m, a: m.broadcast_to(a, (3, 5, 4)),
    "broadcast_arrays": lambda m, a: m.broadcast_arrays(a, m.expand_dims(a, 0)),
    "collect": lambda m, a: m.collect(a),
    "column_stack": lambda m, a: m.column_stack([a, a]),
    "concatenate0": lambda m, a: m.concatenate([a, a, a], axis=0),
    "concatenate1": lambda m, a: m.concatenate([a, a], axis=1),
    "diag": lambda m, a: m.diag(a),
    "diag_offset": lambda m, a: m.diag(a, 1),
    "diagonal": lambda m, a: m.diagonal(a, -1),
    "diagonal_swapped": lambda m, a: m.diagonal(a, 2, 1, 0),
    "dsplit": lambda m, a: m.dsplit(m.expand_dims(a, 2), 1),
    "expand_dims0": lambda m, a: m.expand_dims(a, 0),
    "expand_dims2": lambda m, a: m.expand_dims(a, -1),
    "flatten": lambda m, a: m.flatten(a),
    "flip": lambda m, a: m.flip(a),
    "flip0": lambda m, a: m.flip(a, 0),
    "flip1": lambda m, a: m.flip(a, 1),
    "fliplr": lambda m, a: m.fliplr(a),
    "flipud": lambda m, a: m.flipud(a),
    "flatten_method": lambda m, a: a.flatten(),
    "expand_dims_method": lambda m, a: a.expand_dims(1),
    "copy": lambda m, a: m.copy(a),
}

# 1-D calls
CASES_1D = {
    "diag": lambda m, v: m.diag(v),
    "diag_below": lambda m, v: m.diag(v, -2),
    "topk": lambda m, v: m.topk(v, 3),
    "topk_smallest": lambda m, v: m.topk(v, 4, largest=False),
    "sort": lambda m, v: m.sort(v),
    "sort_descending": lambda m, v: m.sort(v, descending=True),
    "unique": lambda m, v: m.unique(v),
    "hstack": lambda m, v: m.hstack([v, v]),
    "column_stack": lambda m, v: m.column_stack([v, v]),
    "row_stack": lambda m, v: m.row_stack([v, v]),
    "hsplit": lambda m, v: m.hsplit(v, [2, 4]),
    "roll": lambda m, v: m.roll(v, 4),
    "unfold": lambda m, v: m.unfold(v, 0, 3, 2),
    "pad": lambda m, v: m.pad(v, (3, 2), mode="reflect"),
    "repeat": lambda m, v: m.repeat(v, 2),
}


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("dtype", DTYPES)
def test_manipulation_matches_reference(name, dtype):
    a = data(dtype, seed=3)
    if dtype.startswith("int"):
        a = (a % 4).astype(dtype)  # ties for the sorts, top-k and unique
    for split in SPLITS:
        same_outcome(lambda m, x: CASES[name](m, x), [ht.array(a, split=split)], [hj.array(a, split=split)])


@pytest.mark.parametrize("name", sorted(CASES_1D))
@pytest.mark.parametrize("dtype", DTYPES)
def test_manipulation_of_a_vector_matches_reference(name, dtype):
    v = data(dtype, shape=(11,), seed=4)
    if dtype.startswith("int"):
        v = (v % 3).astype(dtype)
    for split in (None, 0):
        same_outcome(lambda m, x: CASES_1D[name](m, x), [ht.array(v, split=split)], [hj.array(v, split=split)])


def test_fill_diagonal_matches_reference():
    for dtype in ("int32", "float64"):
        for shape in ((5, 4), (3, 6)):
            a = data(dtype, shape=shape, seed=9)
            for split in SPLITS:
                p, r = ht.array(a, split=split), hj.array(a, split=split)
                assert p.fill_diagonal(7) is p
                r.fill_diagonal(7)
                same(p, r)


@pytest.mark.parametrize("split", SPLITS)
def test_split_tiles_match_reference(split):
    a = data("float32", shape=(7, 5), seed=10)
    p, r = ht.array(a, split=split), hj.array(a, split=split)
    pt, rt = ht.tiling.SplitTiles(p), hj.tiling.SplitTiles(r)
    np.testing.assert_array_equal(pt.tile_locations, rt.tile_locations)
    np.testing.assert_array_equal(pt.tile_ends_g, rt.tile_ends_g)
    np.testing.assert_array_equal(pt.tile_dimensions, rt.tile_dimensions)
    np.testing.assert_array_equal(pt.lshape_map, rt.lshape_map)
    for key in ((0, 0), 0, (slice(None), 0), (0, slice(0, 1))):
        assert pt.get_tile_size(key) == rt.get_tile_size(key)
        np.testing.assert_array_equal(pt[key].numpy(), np.asarray(rt[key]))
    pt[0, 0] = 3.0
    rt[0, 0] = 3.0
    same(p, r)


@pytest.mark.parametrize("split", [0, 1])
@pytest.mark.parametrize("shape", [(9, 5), (5, 9)])
def test_square_diag_tiles_match_reference(split, shape):
    a = data("float64", shape=shape, seed=11)
    p, r = ht.array(a, split=split), hj.array(a, split=split)
    pt, rt = ht.tiling.SquareDiagTiles(p, tiles_per_proc=2), hj.tiling.SquareDiagTiles(r, tiles_per_proc=2)
    for attr in ("row_indices", "col_indices", "tile_rows", "tile_columns", "tile_rows_per_process",
                 "tile_columns_per_process", "last_diagonal_process"):
        assert getattr(pt, attr) == getattr(rt, attr), attr
    np.testing.assert_array_equal(pt.tile_map, rt.tile_map)
    for key in ((0, 0), (-1, 0), (0, slice(None)), (-1, -1)):
        assert pt.get_start_stop(key) == rt.get_start_stop(key)
        np.testing.assert_array_equal(pt[key].numpy(), np.asarray(rt[key]))
        np.testing.assert_array_equal(pt.local_get(key).numpy(), np.asarray(rt.local_get(key)))
    pt[-1, 0] = -1.0
    rt[-1, 0] = -1.0
    pt.local_set((0, -1), 2.0)
    rt.local_set((0, -1), 2.0)
    same(p, r)
    assert pt.local_to_global((1, 1), 0) == rt.local_to_global((1, 1), 0)
    with pytest.raises(ValueError):
        ht.tiling.SquareDiagTiles(ht.array(a), tiles_per_proc=2)
