"""The port's repairs of faults F17-F23 (ROADMAP queue 3), each held
against heat_tpu on the same seeded numpy inputs, on a one-device
Communication (the port's world of one), at splits None and 0.

* F17: float16 bin edges (``histogram``, ``histc``, napi's
  ``histogram2d``/``histogramdd``/``histogram_bin_edges``); the integers
  of up to 32 bits and bool are binned in float32, as jnp's
  ``to_inexact_dtype`` takes them.  Edges bitwise for 2 to 128 bins.
* F18: unsigned results in their own type, wrapped to the width
  (``diff``, ``ediff1d``, ``outer``, ``dot``, ``matmul``, ``vdot``).
* F19: uint64 by its unsigned value (``topk``, ``trace``, ``gradient``,
  ``trapz``, ``cond``, ``>>`` by 65 or more); ``trapz`` of uint32 in
  float32.
* F20: result types (``vdot`` keeps the operands' type, ``var``/``std``
  of float16 are float16, bool edges float32, ``diff`` with a python
  scalar ``prepend`` weakly typed).
* F21: answers where torch's CPU kernels have none (unsigned and bool
  orderings, uint64 ``nonzero``, unsigned products, complex ``nanmax``,
  ``fmax``, ``histogram`` and ``logaddexp2``).
* F22: ``ht.array`` of an ml_dtypes bfloat16 ndarray.
* F23: the reference's exception types for its refusals.
* F24-F26, found by a sweep of napi while these were repaired: ``nanvar``
  and ``nanstd`` of float16 computed in float32 and rounded once,
  ``nanargmax`` of complex refused with TypeError, ``histogram2d`` and
  ``histogramdd`` of complex answered.

Integer and bool results compare bitwise, float results within the
reference's float32 bounds (``tests/torch_parity.py``); bin edges of
every type are held bitwise in ``test_f17_edges_are_bitwise_for_2_to_128_bins``
and ``test_f21_complex_histograms_are_bitwise``.  All
191 of this file's tests fail on b4d3a21 (``>>`` by exactly 64 agreed
there already and is not listed)."""

import jax
import numpy as np
import pytest

import heat_tpu as hj
import heat_tpu_torch as ht
from torch_fault_cases import CASES, values
from torch_parity import same, same_outcome


@pytest.fixture(autouse=True)
def _one_device():
    """The port on the CPU, the reference on one device."""
    ht.use_device("cpu")
    saved = hj.get_comm()
    hj.use_comm(hj.Communication(jax.devices()[:1]))
    try:
        yield
    finally:
        hj.use_comm(saved)


@pytest.mark.parametrize("split", [None, 0])
@pytest.mark.parametrize("name", sorted(CASES))
def test_fault_case_matches_the_reference(name, split):
    fn, inputs = CASES[name]
    arrays = inputs()
    port = [ht.array(a, split=split if i == 0 else None) for i, a in enumerate(arrays)]
    ref = [hj.array(a, split=split if i == 0 else None) for i, a in enumerate(arrays)]
    same_outcome(fn, port, ref)


@pytest.mark.parametrize("dtype", ["float16", "float32", "float64"])
def test_f17_edges_are_bitwise_for_2_to_128_bins(dtype):
    """XLA's linspace: each operation rounded to the type, the last sum
    fused, edge 1 of at most 33 bins fused the other way round."""
    rng = np.random.default_rng(0)
    for trial in range(4):
        lo, hi = sorted(rng.standard_normal(2) * 10.0 ** rng.integers(-2, 3))
        a = np.array([lo, hi], dtype)
        for bins in (2, 3, 5, 10, 17, 33, 34, 64, 100, 128):
            got = ht.histogram(ht.array(a), bins=bins)[1].numpy()
            want = np.asarray(hj.histogram(hj.array(a), bins=bins)[1].numpy())
            assert got.tobytes() == want.tobytes(), (dtype, bins, np.nonzero(got != want)[0])
    x = values("float16", 3, (40,))
    for split in (None, 0):
        same(ht.histogram(ht.array(x, split=split), bins=9)[0], hj.histogram(hj.array(x, split=split), bins=9)[0])


@pytest.mark.parametrize("split", [None, 0, 1])
def test_f22_array_of_ml_dtypes_bfloat16(split):
    ml_dtypes = pytest.importorskip("ml_dtypes")
    a = np.array([[1.5, -2.25, 3e38], [0.1, np.nan, -0.0]], dtype=ml_dtypes.bfloat16)
    p, r = ht.array(a, split=split), hj.array(a, split=split)
    assert p.dtype is ht.bfloat16 and p.split == r.split
    # numpy() of the port's bfloat16 is float32 (ROADMAP caveats): compare the values
    np.testing.assert_array_equal(p.numpy(), np.asarray(r.numpy()).astype(np.float32))
    np.testing.assert_array_equal(p.numpy(), a.astype(np.float32))
    same(ht.array(a, dtype=ht.float32, split=split), hj.array(a, dtype=hj.float32, split=split))


def test_f21_complex_histograms_are_bitwise():
    """Complex edges as XLA computes them (each part ``lo (1 - s) + hi s``,
    every operation rounded) and complex values binned by JAX's own binary
    search, also where rounding leaves the edges out of lexicographic
    order (all real parts equal)."""
    rng = np.random.default_rng(3)
    for trial in range(4):
        for dtype in ("complex64", "complex128"):
            a = ((rng.standard_normal(40) + 1j * rng.standard_normal(40)) * 10.0 ** rng.integers(-2, 3)).astype(dtype)
            if trial % 2 == 0:
                a.real[:] = 1.5
            for bins in (2, 7, 33, 34):
                for got, want in zip(ht.histogram(ht.array(a), bins=bins), hj.histogram(hj.array(a), bins=bins)):
                    assert got.numpy().tobytes() == np.asarray(want.numpy()).tobytes(), (dtype, bins, trial)
            for got, want in zip(ht.histogram2d(ht.array(a[:20]), ht.array(a[20:]), bins=(3, 5)),
                                 hj.histogram2d(hj.array(a[:20]), hj.array(a[20:]), bins=(3, 5))):
                assert got.numpy().tobytes() == np.asarray(want.numpy()).tobytes(), (dtype, trial)
