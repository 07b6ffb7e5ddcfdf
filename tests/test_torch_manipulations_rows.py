"""The port's manipulations.py, the calls that move rows along an axis
(pad in every mode, repeat, reshape, resplit, roll, rot90, the stacks and
splits along axis 1), against heat_tpu's on a world of one: the types and
splits, bounds and refusals of test_torch_manipulations.py."""

import jax
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
    "hsplit": lambda m, a: m.hsplit(a, 2),
    "hstack": lambda m, a: m.hstack([a, a]),
    "moveaxis": lambda m, a: m.moveaxis(a, 0, 1),
    "pad_constant": lambda m, a: m.pad(a, ((1, 2), (0, 3)), constant_values=7),
    "pad_edge": lambda m, a: m.pad(a, 2, mode="edge"),
    "pad_wrap": lambda m, a: m.pad(a, ((7, 1), (2, 5)), mode="wrap"),
    "pad_reflect": lambda m, a: m.pad(a, ((3, 6), (1, 2)), mode="reflect"),
    "pad_symmetric_odd": lambda m, a: m.pad(a, ((2, 1), (3, 0)), mode="symmetric", reflect_type="odd"),
    "pad_linear_ramp": lambda m, a: m.pad(a, ((2, 3), (1, 1)), mode="linear_ramp", end_values=5),
    "pad_maximum": lambda m, a: m.pad(a, ((1, 2), (2, 0)), mode="maximum", stat_length=2),
    "pad_mean": lambda m, a: m.pad(a, ((1, 2), (2, 1)), mode="mean"),
    "pad_median": lambda m, a: m.pad(a, ((2, 1), (0, 2)), mode="median"),
    "pad_empty": lambda m, a: m.pad(a, ((1, 1), (0, 0)), mode="empty"),
    "ravel": lambda m, a: m.ravel(a),
    "repeat": lambda m, a: m.repeat(a, 2),
    "repeat0": lambda m, a: m.repeat(a, 3, axis=0),
    "repeat_counts": lambda m, a: m.repeat(a, [1, 0, 2, 1, 3], axis=0),
    "repeat1": lambda m, a: m.repeat(a, [2, 1, 0, 1], axis=1),
    "reshape": lambda m, a: m.reshape(a, (4, 5)),
    "reshape_flat": lambda m, a: m.reshape(a, (20,)),
    "reshape_new_split": lambda m, a: m.reshape(a, (2, 10), new_split=1),
    "reshape_unknown": lambda m, a: m.reshape(a, (-1, 2, 2)),
    "reshape_method": lambda m, a: a.reshape(10, 2),
    "resplit": lambda m, a: m.resplit(a, 1),
    "roll": lambda m, a: m.roll(a, 3),
    "roll0": lambda m, a: m.roll(a, -7, 0),
    "roll1": lambda m, a: m.roll(a, 1, 1),
    "roll_both": lambda m, a: m.roll(a, (2, -1), (0, 1)),
    "rot90": lambda m, a: m.rot90(a),
    "rot90_2": lambda m, a: m.rot90(a, 2),
    "rot90_3": lambda m, a: m.rot90(a, 3, (1, 0)),
    "row_stack": lambda m, a: m.row_stack([a, a]),
    "ravel_method": lambda m, a: a.ravel(),
}


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("dtype", DTYPES)
def test_manipulation_matches_reference(name, dtype):
    a = data(dtype, seed=3)
    if dtype.startswith("int"):
        a = (a % 4).astype(dtype)  # ties for the sorts, top-k and unique
    for split in SPLITS:
        same_outcome(lambda m, x: CASES[name](m, x), [ht.array(a, split=split)], [hj.array(a, split=split)])


def test_stack_out_and_refusals_match_reference():
    a = data("int32", seed=6)
    for split in SPLITS:
        po, ro = ht.zeros((2, 5, 4), dtype=ht.int32, split=split), hj.zeros((2, 5, 4), dtype=hj.int32, split=split)
        assert ht.stack([ht.array(a, split=split)] * 2, out=po) is po
        hj.stack([hj.array(a, split=split)] * 2, out=ro)
        same(po, ro)
    p, r = ht.array(a, split=0), hj.array(a, split=0)
    for call in (lambda m, x: m.concatenate(x), lambda m, x: m.concatenate([]), lambda m, x: m.squeeze(x, 0),
                 lambda m, x: m.unfold(x, 0, 9), lambda m, x: m.unfold(x, 0, 0), lambda m, x: m.pad(x, 1, mode="bad"),
                 lambda m, x: m.pad(x, 1, mode="edge", constant_values=2), lambda m, x: m.reshape(x, (3, 7)),
                 lambda m, x: m.vsplit(m.flatten(x), 2), lambda m, x: m.dsplit(x, 2), lambda m, x: m.rot90(x, 1, (0,)),
                 lambda m, x: m.moveaxis(x, (0, 1), 0), lambda m, x: m.diag(m.expand_dims(x, 0))):
        same_outcome(call, [p], [r])


def test_mixed_types_and_numpy_operands_match_reference():
    a, b = data("int8", seed=7), data("float32", seed=8)
    for split in SPLITS:
        same(ht.concatenate([ht.array(a, split=split), ht.array(b, split=split)], 1),
             hj.concatenate([hj.array(a, split=split), hj.array(b, split=split)], 1))
        same(ht.vstack([ht.array(a, split=split), b]), hj.vstack([hj.array(a, split=split), b]))
        same(ht.stack([b, ht.array(b, split=split)]), hj.stack([b, hj.array(b, split=split)]))
