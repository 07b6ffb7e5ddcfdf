"""The port's ``convolve`` (heat_tpu_torch/core/signal.py) against
heat_tpu's on a world of one: the three modes over float32, float64,
int32, bool and complex64 signals and kernels of odd and even length
(split None and 0), a kernel longer than the signal (swapped in 'full',
refused otherwise), the refusals of 'same' with an even kernel, of an
unknown mode and of 2-D operands; values within rtol 1e-6 (float32: atol
1e-6 for entries near zero), exact types rounded half to even and cast
back as the reference does."""

import jax
import numpy as np
import pytest

import heat_tpu as hj
import heat_tpu_torch as ht
from torch_parity import data, same, same_outcome


@pytest.fixture(autouse=True)
def world_of_one():
    ht.use_device("cpu")
    saved = hj.get_comm()
    hj.use_comm(hj.Communication(jax.devices()[:1]))
    try:
        yield
    finally:
        hj.use_comm(saved)


def _bounds(dtype):
    return (1e-6, 1e-6) if dtype in ("float32", "complex64") else (1e-12, 1e-12)


@pytest.mark.parametrize("mode", ["full", "same", "valid"])
@pytest.mark.parametrize("dtype", ["float32", "float64", "int32", "bool", "complex64"])
@pytest.mark.parametrize("klen", [1, 4, 7])
def test_convolve_matches_reference(mode, dtype, klen):
    sig = data(dtype, shape=(23,), seed=60)
    ker = data(dtype, shape=(klen,), seed=61)
    rtol, atol = _bounds(dtype)
    for split in (None, 0):
        same_outcome(lambda m, a, v: m.convolve(a, v, mode=mode), [ht.array(sig, split=split), ht.array(ker)],
                     [hj.array(sig, split=split), hj.array(ker)], rtol=rtol, atol=atol)


def test_mixed_types_lists_and_a_longer_kernel():
    sig = data("float32", shape=(5,), seed=62)
    ker = data("float64", shape=(9,), seed=63)
    for mode in ("full", "same", "valid"):
        same_outcome(lambda m, a, v: m.convolve(a, v, mode=mode), [ht.array(sig, split=0), ht.array(ker)],
                     [hj.array(sig, split=0), hj.array(ker)], rtol=1e-12, atol=1e-12)
    ints = data("int32", shape=(12,), seed=64)
    same_outcome(lambda m, a, v: m.convolve(a, v, mode="same"), [ht.array(ints), [1, -2, 3]],
                 [hj.array(ints), [1, -2, 3]])
    same_outcome(lambda m, a, v: m.convolve(a, v), [ints.tolist(), ht.array(np.array([0.5, 0.25], np.float32))],
                 [ints.tolist(), hj.array(np.array([0.5, 0.25], np.float32))], rtol=1e-6, atol=1e-6)


def test_refusals():
    a, v2 = data("float32", shape=(10,), seed=65), data("float32", shape=(2, 3), seed=66)
    calls = (lambda m, x: m.convolve(x, m.array(np.ones(4, np.float32)), mode="same"),
             lambda m, x: m.convolve(x, m.array(np.ones(3, np.float32)), mode="circular"),
             lambda m, x: m.convolve(m.array(v2), x))
    for call in calls:
        same_outcome(call, [ht.array(a)], [hj.array(a)])


def test_the_kernel_convolves_in_float64_exactly():
    """The valid convolution of the padded signal with the flipped kernel is
    numpy's convolution (float64: equal within 1e-12)."""
    rng = np.random.default_rng(67)
    sig, ker = rng.standard_normal(1000), rng.standard_normal(33)
    got = ht.convolve(ht.array(sig), ht.array(ker)).numpy()
    np.testing.assert_allclose(got, np.convolve(sig, ker), rtol=1e-12, atol=1e-12)
    assert ht.convolve(ht.array(sig, split=0), ht.array(ker), mode="valid").split == 0
    want = hj.convolve(hj.array(sig, split=0), hj.array(ker), mode="same")
    same(ht.convolve(ht.array(sig, split=0), ht.array(ker), mode="same"), want)
