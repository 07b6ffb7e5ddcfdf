"""heat_tpu_torch.random against heat_tpu.random: seeded draws are bitwise
equal (the port re-implements JAX's Threefry-2x32 and uniform mantissa
construction on torch integer tensors)."""

import numpy as np
import pytest

import heat_tpu as hj
import heat_tpu_torch as ht


@pytest.fixture(autouse=True)
def _port_on_cpu():
    ht.use_device("cpu")


def _bits(a: np.ndarray) -> np.ndarray:
    return a.view(np.uint32 if a.dtype == np.float32 else np.uint64)


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5])
def test_successive_rand_bitwise(seed):
    hj.random.seed(seed)
    ht.random.seed(seed)
    for n in (1, 7, 1003, 65539):
        want = hj.random.rand(n).numpy()
        got = ht.random.rand(n).numpy()
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(_bits(got), _bits(want))
        assert ht.random.get_state() == hj.random.get_state()


@pytest.mark.parametrize("seed", [3, 12345])
def test_rand_shapes_and_float64_bitwise(seed):
    hj.random.seed(seed)
    ht.random.seed(seed)
    np.testing.assert_array_equal(_bits(ht.random.rand(4, 5, 3).numpy()), _bits(hj.random.rand(4, 5, 3).numpy()))
    got = ht.random.rand(33, 2, dtype=ht.float64).numpy()
    want = hj.random.rand(33, 2, dtype=hj.float64).numpy()
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_split_draw_equals_unsplit():
    ht.random.seed(11)
    whole = ht.random.rand(1003).numpy()
    ht.random.seed(11)
    split = ht.random.rand(1003, split=0)
    assert split.split == 0
    np.testing.assert_array_equal(split.numpy(), whole)


def test_state_tracks_counter():
    ht.random.seed(5)
    hj.random.seed(5)
    assert ht.random.get_state() == hj.random.get_state() == ("Threefry", 5, 0, 0, 0.0)
    ht.random.rand(3)
    ht.random.rand(2, 2)
    hj.random.rand(3)
    hj.random.rand(2, 2)
    assert ht.random.get_state() == hj.random.get_state() == ("Threefry", 5, 2, 0, 0.0)
    saved = ht.random.get_state()
    first = ht.random.rand(9).numpy()
    ht.random.set_state(saved)
    np.testing.assert_array_equal(ht.random.rand(9).numpy(), first)
    hj.random.set_state(saved)
    np.testing.assert_array_equal(hj.random.rand(9).numpy(), first)
    with pytest.raises(ValueError):
        ht.random.set_state(("Philox", 1, 2))
