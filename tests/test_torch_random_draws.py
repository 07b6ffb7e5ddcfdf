"""The rest of heat_tpu_torch.random against heat_tpu.random: randint and
its aliases, uniform and the random_sample aliases, the permutations
(permutation, randperm, shuffle), choice's four branches and bytes.  Every
draw is bitwise equal to the reference's for the same seed, and the
generator's state matches after every call.

The reference runs under the test suite's x64 setting, where randint's
default dtype is int64 (the 64-bit unsigned path) and a pool or
permutation of an int is int64."""

from fractions import Fraction

import numpy as np
import pytest
import torch

import heat_tpu as hj
import heat_tpu_torch as ht
from heat_tpu_torch.core import random as rnd


@pytest.fixture(autouse=True)
def _port_on_cpu():
    ht.use_device("cpu")


def _same(got, want):
    """Bitwise equal values, dtype and shape, and the same generator state."""
    got = got.numpy() if hasattr(got, "numpy") else np.asarray(got)
    want = want.numpy() if hasattr(want, "numpy") else np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype.kind == "f":
        got, want = got.view(np.uint8), want.view(np.uint8)
    np.testing.assert_array_equal(got, want)
    assert ht.random.get_state() == hj.random.get_state()


def _seed(s):
    hj.random.seed(s)
    ht.random.seed(s)


# (low, high): negative lows; spans of 1, 2^31 - 1, 2^62 and 2^63 + 5; the
# whole int64 range (span 2^64 - 1, every word's top bit in play)
INT64_RANGES = [(0, 10), (-5, 3), (7, 8), (0, 2**31 - 1), (-(2**61), 2**61), (-(2**62) - 3, 2**62 + 2),
                (-(2**63), 2**63 - 1), (-(2**63), 5), (2**40, 2**62 + 2**40)]
# int32: the same, and bounds past int32 that JAX clips (a high above the
# range widens the span by one, to 2^32 = 0 where the low is clipped too)
INT32_RANGES = [(0, 10), (-5, 3), (7, 8), (-7, 2**31 - 1), (0, 2**17 + 3), (-(2**31), 2**31),
                (-(2**31), 2**40), (-(2**40), 5), (2**31 + 5, 2**31 + 10), (-(2**30), 2**30 + 7)]


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5])
@pytest.mark.parametrize("low,high", INT64_RANGES)
def test_randint_int64_bitwise(seed, low, high):
    _seed(seed)
    for size in (None, 1, (3, 7), (1003,)):
        _same(ht.random.randint(low, high, size=size), hj.random.randint(low, high, size=size))


@pytest.mark.parametrize("seed", [0, 11])
@pytest.mark.parametrize("low,high", INT32_RANGES)
def test_randint_int32_bitwise(seed, low, high):
    _seed(seed)
    for size in (None, (5, 4), 1003):
        _same(ht.random.randint(low, high, size=size, dtype=ht.int32),
              hj.random.randint(low, high, size=size, dtype=hj.int32))


def test_randint_aliases_defaults_and_refusals():
    _seed(3)
    _same(ht.random.randint(9), hj.random.randint(9))
    _same(ht.random.random_integer(-4, 4, (6,)), hj.random.random_integer(-4, 4, (6,)))
    _same(ht.random.random_integers(5, size=(40,)), hj.random.random_integers(5, size=(40,)))
    _same(ht.random.random_integers(-3, 3, size=(2, 9)), hj.random.random_integers(-3, 3, size=(2, 9)))
    got = ht.random.randint(0, 100, size=(1003,), split=0)
    assert got.split == 0 and got.dtype == ht.int64
    _same(got, hj.random.randint(0, 100, size=(1003,), split=0))
    with pytest.raises(ValueError, match="low >= high"):
        ht.random.randint(5, 5)
    with pytest.raises(ValueError, match="Unsupported dtype"):
        ht.random.randint(0, 5, dtype=ht.float32)
    assert ht.random.get_state() == hj.random.get_state()  # refusals draw nothing


def test_unsigned_remainder_edges():
    """The int64 stand-in for XLA's unsigned 64-bit remainder, against
    python integers, at words with the top bit set and divisors on either
    side of 2^63 (0 divides nothing, as in XLA)."""
    words = [0, 1, 2**63 - 1, 2**63, 2**63 + 1, 2**64 - 1, 2**64 - 2, 0xDEADBEEF_CAFEBABE, 12345678901234567]
    held = torch.tensor([rnd._i64(w) for w in words], dtype=torch.int64)
    for s in (1, 2, 3, 10, 2**31 - 1, 2**32, 2**62, 2**62 + 7, 2**63 - 1, 2**63, 2**63 + 5, 2**64 - 1, 0):
        got = rnd._urem64(held, s).numpy().view(np.uint64)
        np.testing.assert_array_equal(got, np.array([w % s if s else w for w in words], dtype=np.uint64))


@pytest.mark.parametrize("seed", [0, 9])
def test_uniform_and_random_sample_bitwise(seed):
    """uniform scales and shifts by one fused multiply-add, as XLA does:
    emulated exactly in both float widths."""
    _seed(seed)
    for low, high in ((0.0, 1.0), (-3.7, 11.2), (0.1, 0.3), (-1e-3, 1e6), (5, 6)):
        _same(ht.random.uniform(low, high, (4099,)), hj.random.uniform(low, high, (4099,)))
        _same(ht.random.uniform(low, high, (33, 3), dtype=ht.float64),
              hj.random.uniform(low, high, (33, 3), dtype=hj.float64))
    _same(ht.random.uniform(), hj.random.uniform())
    _same(ht.random.uniform(-2, 2, size=(1003,), split=0), hj.random.uniform(-2, 2, size=(1003,), split=0))
    for name in ("random_sample", "random", "ranf", "sample"):
        _same(getattr(ht.random, name)((7, 5)), getattr(hj.random, name)((7, 5)))
        _same(getattr(ht.random, name)(), getattr(hj.random, name)())
    _same(ht.random.random_sample((65,), dtype=ht.float64), hj.random.random_sample((65,), dtype=hj.float64))


def test_fused_multiply_add_emulation_is_exact():
    """The float32 and float64 fused multiply-adds against exact rational
    arithmetic rounded once, where a separate multiply and add round twice."""
    rng = np.random.default_rng(0)
    for fma, dtype in ((rnd._fma32, np.float32), (rnd._fma64, np.float64)):
        a, b, c = ((rng.standard_normal(2000) * 10.0 ** rng.integers(-3, 4, 2000)).astype(dtype) for _ in range(3))
        got = fma(*(torch.from_numpy(v) for v in (a, b, c))).numpy()
        exact = [Fraction(float(p)) * Fraction(float(q)) + Fraction(float(r)) for p, q, r in zip(a, b, c)]
        # float() of a Fraction rounds once to float64; float32 once more by hand
        want = np.array([_round_f32(e) if dtype == np.float32 else float(e) for e in exact], dtype=dtype)
        np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))
        assert not np.array_equal((a * b + c).view(np.uint8), want.view(np.uint8))


def _round_f32(exact):
    """The float32 nearest the rational ``exact``, ties to even."""
    near = np.float32(float(exact))  # within one float32 step of the answer
    cands = [np.nextafter(near, np.float32(-np.inf)), near, np.nextafter(near, np.float32(np.inf))]
    dist = [abs(Fraction(float(c)) - exact) for c in cands]
    best = [c for c, d in zip(cands, dist) if d == min(dist)]
    return best[0] if len(best) == 1 else next(c for c in best if int(np.array(c).view(np.uint32)) % 2 == 0)


# 0 rounds at n = 1, 1 up to 1625, 2 from 1626, 3 past about 2.6e6
@pytest.mark.parametrize("n", [1, 5, 1625, 1626, 1 << 22])
def test_permutation_of_an_int_bitwise(n):
    _seed(n)
    got = ht.random.permutation(n)
    _same(got, hj.random.permutation(n))
    perm = got.numpy()
    assert np.array_equal(np.sort(perm), np.arange(n))
    assert n == 1 or not np.array_equal(perm, np.arange(n))


def test_shuffle_round_count():
    """JAX's round count, ceil(3 ln n / ln(2^32 - 1)) in float64; the
    permutations above pin 0, 1, 1, 2 and 3 rounds."""
    import jax.numpy as jnp
    from jax._src import dtypes

    for n, rounds in ((0, 0), (1, 0), (2, 1), (1625, 1), (1626, 2), (2642245, 2), (2642246, 3), (1 << 27, 3)):
        assert rnd._shuffle_rounds(n) == rounds
        assert rounds == int(np.ceil(3 * np.log(max(1, n)) / np.log(dtypes.iinfo(jnp.uint32).max)))


def test_permutation_of_arrays_bitwise():
    _seed(21)
    rng = np.random.default_rng(1)
    x2 = rng.standard_normal((1003, 3)).astype(np.float32)
    got = ht.random.permutation(ht.array(x2, split=0))
    want = hj.random.permutation(hj.array(x2, split=0))
    assert got.split == want.split == 0
    _same(got, want)
    x1 = rng.integers(-50, 50, 77)
    got = ht.random.permutation(ht.array(x1))
    assert got.split is None
    _same(got, hj.random.permutation(hj.array(x1)))
    _same(ht.random.permutation(x2), hj.random.permutation(x2))  # numpy, rows
    _same(ht.random.permutation(x1), hj.random.permutation(x1))
    _same(ht.random.permutation([1.5, 2.5, 3.5]), hj.random.permutation([1.5, 2.5, 3.5]))
    _same(ht.random.permutation(np.int64(12)), hj.random.permutation(np.int64(12)))
    assert ht.random.permutation(33, split=0).split == 0
    hj.random.permutation(33, split=0)
    with pytest.raises(TypeError):
        ht.random.permutation(np.float64(3.0))
    hj.random.permutation(np.arange(3))  # the reference's key of the refused call


@pytest.mark.parametrize("dtype", [None, "int32", "int64", "float32", "float64"])
def test_randperm_bitwise(dtype):
    _seed(4)
    kw = {} if dtype is None else {"dtype": getattr(ht, dtype)}
    ref_kw = {} if dtype is None else {"dtype": getattr(hj, dtype)}
    for n in (1, 10, 1003):
        _same(ht.random.randperm(n, **kw), hj.random.randperm(n, **ref_kw))
    got = ht.random.randperm(100, split=0, **kw)
    assert got.split == 0
    _same(got, hj.random.randperm(100, split=0, **ref_kw))
    with pytest.raises(TypeError):
        ht.random.randperm(3.0)


def test_shuffle_in_place_bitwise():
    _seed(8)
    x = np.random.default_rng(2).standard_normal((1003, 4)).astype(np.float32)
    for split in (0, None):
        got, want = ht.array(x, split=split), hj.array(x, split=split)
        padded = got.larray_padded.shape
        ht.random.shuffle(got)
        hj.random.shuffle(want)
        assert got.split == split and got.larray_padded.shape == padded
        _same(got, want)
    with pytest.raises(TypeError):
        ht.random.shuffle(x)


@pytest.mark.parametrize("seed", [0, 5, 123])
def test_choice_without_p_bitwise(seed):
    """With replacement: randint over the pool; without: a prefix of the
    pool's permutation.  Int pools are arange (int64)."""
    _seed(seed)
    pool = np.random.default_rng(seed).standard_normal((40, 3))
    for replace in (True, False):
        _same(ht.random.choice(50, size=(4, 5), replace=replace), hj.random.choice(50, size=(4, 5), replace=replace))
        _same(ht.random.choice(1626, size=30, replace=replace), hj.random.choice(1626, size=30, replace=replace))
        _same(ht.random.choice(pool, size=7, replace=replace), hj.random.choice(pool, size=7, replace=replace))
        _same(ht.random.choice(ht.array(pool[:, 0]), size=(2, 3), replace=replace),
              hj.random.choice(hj.array(pool[:, 0]), size=(2, 3), replace=replace))
    got, want = ht.random.choice(9), hj.random.choice(9)
    assert got.shape == want.shape == () and got.item() == want.item()
    _same(got, want)
    _same(ht.random.choice(9, size=(0,)), hj.random.choice(9, size=(0,)))


@pytest.mark.parametrize("seed", [0, 5, 123])
def test_choice_with_p_bitwise(seed):
    """With replacement: the cumulative sum searched at p_cuml[-1] (1 - u);
    the indices are equal where no u lies on a boundary of the two
    packages' cumulative sums, which sum in other orders."""
    _seed(seed)
    rng = np.random.default_rng(seed)
    for dtype in (np.float64, np.float32):
        p = rng.random(50).astype(dtype)
        p /= p.sum()
        _same(ht.random.choice(50, size=(30,), p=p), hj.random.choice(50, size=(30,), p=p))
        _same(ht.random.choice(50, p=p), hj.random.choice(50, p=p))
    pool = rng.standard_normal((20, 2)).astype(np.float32)
    _same(ht.random.choice(pool, size=(3, 4), p=[0.05] * 20), hj.random.choice(pool, size=(3, 4), p=[0.05] * 20))
    _same(ht.random.choice(ht.array(pool), size=9, p=ht.array(np.full(20, 0.05))),
          hj.random.choice(hj.array(pool), size=9, p=hj.array(np.full(20, 0.05))))


@pytest.mark.parametrize("seed", [0, 5, 123, 2024])
def test_gumbel_choice_without_replacement_indices(seed):
    """Gumbel top-k: -log(-log(u)) + log(p) through the port's float32 log,
    within 2 ulp of XLA's (the class of randn), so keys could in principle
    swap at a near-tie; the indices are equal for these seeds.  Ties go to
    the lower index (a stable descending sort, as lax.top_k)."""
    _seed(seed)
    rng = np.random.default_rng(seed)
    for dtype, n, k in ((np.float32, 60, 25), (np.float64, 60, 25), (np.float32, 2000, 300)):
        p = rng.random(n).astype(dtype)
        p[::7] = 0.0  # log(0) = -inf: never picked while others remain
        p /= p.sum()
        _same(ht.random.choice(n, size=(k,), replace=False, p=p), hj.random.choice(n, size=(k,), replace=False, p=p))
    p = np.full(8, 0.125, np.float32)
    _same(ht.random.choice(8, size=8, replace=False, p=p), hj.random.choice(8, size=8, replace=False, p=p))


def test_choice_refusals_consume_the_key_as_the_reference_does():
    _seed(2)
    for kw in ({"size": 6, "replace": False}, {"size": 2, "p": [0.5, 0.5]}):
        with pytest.raises(ValueError):
            ht.random.choice(5, **kw)
        with pytest.raises(ValueError):
            hj.random.choice(5, **kw)
        assert ht.random.get_state() == hj.random.get_state()
    with pytest.raises(ValueError):
        ht.random.choice(0, size=2)
    with pytest.raises(ValueError):
        hj.random.choice(0, size=2)
    _same(ht.random.choice(5, size=3), hj.random.choice(5, size=3))


@pytest.mark.parametrize("length", [0, 1, 17, 1003])
def test_bytes_bitwise(length):
    _seed(length)
    got, want = ht.random.bytes(length), hj.random.bytes(length)
    assert isinstance(got, bytes) and got == want and len(got) == length
    assert ht.random.get_state() == hj.random.get_state()


def test_every_reference_export_is_ported():
    assert sorted(ht.random.__all__) == sorted(hj.random.__all__)
    for name in hj.random.__all__:
        assert callable(getattr(ht.random, name)), name


def test_split_and_bits_are_jax_s():
    """The key split and the 32- and 64-bit words against jax.random's own
    functions on the same key."""
    import jax
    import jax.numpy as jnp
    from jax._src import prng

    key = (0x12345678, 0x9ABCDEF0)
    jkey = jnp.asarray(np.array(key, dtype=np.uint32))
    want = np.asarray(prng.threefry_split(jkey, (2,)))
    assert rnd._split(key) == tuple(tuple(int(w) for w in row) for row in want)
    cpu = torch.device("cpu")
    np.testing.assert_array_equal(rnd._bits32(key, 1003, cpu).numpy().view(np.uint32),
                                  np.asarray(prng.threefry_random_bits(jkey, 32, (1003,))))
    np.testing.assert_array_equal(rnd._bits64(key, 1003, cpu).numpy().view(np.uint64),
                                  np.asarray(prng.threefry_random_bits(jkey, 64, (1003,))))
    assert jax.config.jax_threefry_partitionable
