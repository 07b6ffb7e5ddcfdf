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


def _ulps(got: np.ndarray, want: np.ndarray) -> int:
    """Largest distance in units in the last place (same-sign values)."""
    ints = np.int32 if got.dtype == np.float32 else np.int64
    return int(np.abs(got.view(ints).astype(np.int64) - want.view(ints).astype(np.int64)).max())


# jax.random.normal is sqrt(2) erfinv(u); the port evaluates XLA's erfinv,
# log1p and log polynomials in torch.  Measured over 3 seeds x 2^20 draws:
# float32 at most 2 ulp apart (99.996% bitwise equal), float64 at most 3
@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5])
def test_randn_within_two_ulp_of_the_reference(seed):
    hj.random.seed(seed)
    ht.random.seed(seed)
    for shape in ((1,), (7, 3), (1 << 20,)):
        want = hj.random.randn(*shape).numpy()
        got = ht.random.randn(*shape).numpy()
        assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
        assert np.isfinite(got).all()
        assert _ulps(got, want) <= 2
    assert ht.random.get_state() == hj.random.get_state()


def test_randn_float64_and_standard_normal():
    hj.random.seed(4)
    ht.random.seed(4)
    want = hj.random.randn(1 << 16, dtype=hj.float64).numpy()
    got = ht.random.randn(1 << 16, dtype=ht.float64).numpy()
    assert got.dtype == want.dtype == np.float64
    assert _ulps(got, want) <= 3
    want = hj.random.standard_normal((33, 5)).numpy()
    got = ht.random.standard_normal((33, 5)).numpy()
    assert got.shape == want.shape == (33, 5) and _ulps(got, want) <= 2
    assert ht.random.standard_normal().shape == hj.random.standard_normal().shape == (1,)


def test_normal_scales_and_broadcasts_like_the_reference():
    hj.random.seed(5)
    ht.random.seed(5)
    want = hj.random.normal(1.5, 2.0, (4096,)).numpy()
    got = ht.random.normal(1.5, 2.0, (4096,)).numpy()
    # randn within 2 ulp, then one multiply and one add, each rounded
    np.testing.assert_allclose(got, want, rtol=0, atol=4 * np.spacing(np.abs(want).max()))
    mean, std = np.array([0.0, 10.0], np.float32), np.array([1.0, 3.0], np.float32)
    want = hj.random.normal(hj.array(mean), hj.array(std), (500, 2)).numpy()
    got = ht.random.normal(ht.array(mean), ht.array(std), (500, 2)).numpy()
    assert got.shape == want.shape == (500, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=4 * np.spacing(np.abs(want).max()))
    with pytest.raises(ValueError, match="std needs to be positive"):
        ht.random.normal(0.0, -1.0, (3,))
    with pytest.raises(ValueError, match="std needs to be positive"):
        ht.random.normal(0.0, ht.array(np.array([1.0, -0.5], np.float32)), (2,))


def test_randn_split_layout_equals_the_reference():
    """Each rank of a world of 3 keeps its chunk of the same draw, laid out
    as the reference's 3-device array is."""
    import jax

    hj.random.seed(6)
    want = hj.random.randn(1003, 4, split=0, comm=hj.Communication(jax.devices()[:3]))
    chunks = []
    for rank in range(3):
        ht.random.seed(6)
        got = ht.random.randn(1003, 4, split=0, comm=ht.Communication(size=3, rank=rank))
        assert got.split == want.split == 0
        np.testing.assert_array_equal(got.lshape_map, want.lshape_map)
        chunks.append(got.larray.numpy())
    assert _ulps(np.concatenate(chunks), want.numpy()) <= 2


@pytest.mark.parametrize("start", [0, (1 << 32) - 3, 5 * (1 << 32) + 11])
def test_hash_words_at_any_start_match_jax_threefry(start):
    """The plain hash of counters start..start+n-1 (the card kernel is held
    bitwise against it in tests/test_torch_gpu.py) against JAX's own
    threefry primitive on the same (high, low) counter words."""
    import jax.numpy as jnp
    import torch
    from jax._src import prng

    from heat_tpu_torch.core import random as rnd

    key, n = (0x9E3779B9, 0x7F4A7C15), 1003
    b0, b1 = rnd._random_bits(key, n, torch.device("cpu"), start)
    i = np.arange(start, start + n, dtype=np.uint64)
    words = np.concatenate([(i >> np.uint64(32)).astype(np.uint32), (i & np.uint64(0xFFFFFFFF)).astype(np.uint32)])
    want = np.asarray(prng.threefry_2x32((jnp.uint32(key[0]), jnp.uint32(key[1])), jnp.asarray(words)))
    np.testing.assert_array_equal(b0.numpy().view(np.uint32), want[:n])
    np.testing.assert_array_equal(b1.numpy().view(np.uint32), want[n:])


def test_plain_hash_serves_the_cpu_only():
    import torch

    from heat_tpu_torch.core import random as rnd

    before = rnd.THREEFRY_LAUNCHES
    u = rnd._unit_f32((3, 4), 100, torch.device("cpu"))
    assert u.dtype == torch.float32 and bool(((u >= 0) & (u < 1)).all())
    assert rnd.THREEFRY_LAUNCHES == before  # the plain version launches nothing
    with pytest.raises(ValueError, match="no threefry hash"):
        rnd._random_bits((3, 4), 4, torch.device("meta"))
