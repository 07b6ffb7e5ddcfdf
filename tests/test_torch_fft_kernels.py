"""Each FFT kernel module of the port against the reference's Pallas kernel
run through the interpreter, as heat_tpu's own tests run it on the CPU.
On the CPU the port's wrappers run their plain PyTorch versions, which is
what is held here; tests/test_torch_gpu.py holds the CUDA kernels against
them on the card.

Tolerances (``_rel`` = max abs difference / max abs of the truth): 2e-4 for
K3-K5 (tests/test_fft_leading.py's own for its kernels); rtol 2e-4, atol
2e-3 for K6 (tests/test_fft_pallas_kernel.py's), plus numpy float64 truth."""

import numpy as np
import pytest
import torch

from heat_tpu.fft import _leading as ref_leading
from heat_tpu.fft import _pallas_fft as ref_pf
from heat_tpu_torch.core._tf32x3 import tf32_mm, tf32_rna, tf32x3_mm
from heat_tpu_torch.fft import _axis_pass, _leading


def _rel(a, b):
    a, b = np.asarray(a, np.complex128), np.asarray(b, np.complex128)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-12)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(t):
    return t.numpy()


@pytest.mark.parametrize("inverse,scale", [(False, 1.0), (True, 1.0 / 128)])
def test_k3_stage_matches_pallas_interpret(inverse, scale):
    rng = np.random.default_rng(4)
    n = 128
    re = rng.standard_normal((n, 4, 64)).astype(np.float32)
    im = rng.standard_normal((n, 4, 64)).astype(np.float32)
    want = ref_leading._stage_fused_pallas(re, im, n, inverse, scale)
    before = _leading.FFT_STAGE_LAUNCHES
    got = _leading._stage_fused(_t(re), _t(im), n, inverse, scale)
    assert _leading.FFT_STAGE_LAUNCHES == before  # the plain version launches nothing
    assert got[0].shape == (4, 64, n)
    for g, w in zip(got, want):
        assert _rel(_np(g), w) < 2e-4


def test_k3_blocked_stage_matches_pallas_interpret():
    rng = np.random.default_rng(14)
    k, b, m, n = 128, 3, 128, 128
    z = rng.standard_normal((k, b, 2 * m)).astype(np.float32)
    want = ref_leading._stage_fused_pallas_blocked(z, n, m, False, 1.0)
    got = _leading._stage_fused_blocked(_t(z), n, m, False, 1.0)
    assert got[0].shape == (b, m, n)
    for g, w in zip(got, want):
        assert _rel(_np(g), w) < 2e-4


@pytest.mark.parametrize("inverse,scale", [(False, 1.0), (True, 0.25)])
def test_k4_pair_stage_matches_pallas_interpret(inverse, scale):
    rng = np.random.default_rng(6)
    k, m, n = 128, 128, 128
    z = rng.standard_normal((k, 2, 2, m)).astype(np.float32)
    want = np.asarray(ref_leading._stage_pair_fused(z, n, inverse, scale))
    got = _leading._stage_pair_fused(_t(z), n, inverse, scale)
    assert tuple(got.shape) == want.shape == (2, m, 2, n)
    assert _rel(_np(got), want) < 2e-4
    # the same stage written as the (re, im) planes of the result
    re, im = _leading._stage_pair_fused(_t(z), n, inverse, scale, planes=True)
    assert _rel(_np(re), want[..., 0, :]) < 2e-4 and _rel(_np(im), want[..., 1, :]) < 2e-4
    # and against the reference's pair-block XLA twin
    twin = np.asarray(ref_leading._stage_pair(z, n, inverse, scale, None))
    assert _rel(_np(got), twin) < 2e-4


@pytest.mark.parametrize("inverse", [False, True])
def test_k4_entry_matches_pallas_interpret(inverse):
    rng = np.random.default_rng(8)
    n = 128
    re = rng.standard_normal((n, 2, 128)).astype(np.float32)
    im = rng.standard_normal((n, 2, 128)).astype(np.float32)
    want = np.asarray(ref_leading._entry_pair_fused(re, im, n, inverse))
    got = _leading._entry_pair_fused(_t(re), _t(im), n, inverse)
    assert tuple(got.shape) == want.shape == (2, 128, 2, n)
    assert _rel(_np(got), want) < 2e-4
    # the real and imaginary views of one complex tensor give the same result
    c = torch.complex(_t(re), _t(im))
    assert _rel(_np(_leading._entry_pair_fused(c.real, c.imag, n, inverse)), want) < 2e-4


def test_k5_extension_matches_pallas_interpret():
    rng = np.random.default_rng(10)
    m, n1, n2 = 8, 8, 128
    zr = rng.standard_normal((m, n1, 2 * n2)).astype(np.float32)
    zi = rng.standard_normal((m, n1, 2 * n2)).astype(np.float32)
    nyr = rng.standard_normal((n1, n2)).astype(np.float32)
    nyi = rng.standard_normal((n1, n2)).astype(np.float32)
    want = ref_leading._ext_fused_pallas(zr, zi, nyr, nyi)
    got = _leading._ext_fused(_t(zr), _t(zi), _t(nyr), _t(nyi))
    assert got[0].shape == (2 * m, n1, n2)
    for g, w in zip(got, want):
        assert _rel(_np(g), w) < 2e-4
    # the indexed copy is exact: against the reference's XLA extension bitwise
    ere = zr[..., :n2] - zi[..., n2:]
    eim = zr[..., n2:] + zi[..., :n2]
    twin = ref_leading._ext_xla(ere, eim, nyr, nyi)
    for g, w in zip(got, twin):
        np.testing.assert_array_equal(_np(g), np.asarray(w))


@pytest.mark.parametrize("n", [512, 384, 96, 1000])
@pytest.mark.parametrize("inverse", [False, True])
def test_k6_axis_pass_matches_pallas_interpret(n, inverse):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((6, n)).astype(np.float32)
    y = rng.standard_normal((6, n)).astype(np.float32)
    want_re, want_im = ref_pf.fused_axis_pass(x, y, inverse, "highest")
    want = np.asarray(want_re) + 1j * np.asarray(want_im)
    before = _axis_pass.FFT_AXIS_LAUNCHES
    got_re, got_im = _axis_pass.fused_axis_pass(_t(x), _t(y), inverse)
    assert _axis_pass.FFT_AXIS_LAUNCHES == before
    got = _np(got_re) + 1j * _np(got_im)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-3)
    z = x.astype(np.float64) + 1j * y
    truth = np.fft.ifft(z, axis=-1) * n if inverse else np.fft.fft(z, axis=-1)
    np.testing.assert_allclose(got, truth, rtol=2e-4, atol=2e-3)


def test_k6_real_input_variant():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((4, 256)).astype(np.float32)
    want_re, want_im = ref_pf.fused_axis_pass(x, None, False, "highest")
    got_re, got_im = _axis_pass.fused_axis_pass(_t(x), None, False)
    got = _np(got_re) + 1j * _np(got_im)
    np.testing.assert_allclose(got, np.asarray(want_re) + 1j * np.asarray(want_im), rtol=2e-4, atol=2e-3)
    np.testing.assert_allclose(got, np.fft.fft(x.astype(np.float64), axis=-1), rtol=2e-4, atol=2e-3)


def test_gates_refuse_what_the_kernels_do_not_take():
    assert _leading.stage_unsupported(8, 8, 8, torch.float64) is not None
    assert _leading.stage_unsupported(8, 0, 8, torch.float32) is not None
    assert _leading.stage_unsupported(100, 77, 100, torch.float32) is None  # ragged shapes are taken
    assert _leading.ext_unsupported(3, 5, 7, torch.float32) is None
    assert _leading.ext_unsupported(3, 5, 7, torch.float64) is not None
    assert _axis_pass.axis_pass_unsupported(1000, 3, torch.float32) is None
    assert _axis_pass.axis_pass_unsupported(1000, 3, torch.float64) is not None
    assert _axis_pass.axis_pass_unsupported(262, 3, torch.float32) is not None  # 2 x 131: no factor pair
    with pytest.raises(TypeError):
        _leading._stage_fused(torch.zeros(8, 4, dtype=torch.float64), torch.zeros(8, 4, dtype=torch.float64), 8, False, 1.0)
    with pytest.raises(ValueError):
        _axis_pass.fused_axis_pass(torch.zeros(2, 262), None, False)


# ----------------------------------------------------------------------
# the precision of csrc/fft_stage.cu and csrc/fft_axis.cu: 3xTF32 on the
# tensor cores, emulated here with integer operations on the f32 bits
# ----------------------------------------------------------------------
# the emulation of csrc/tf32x3.cuh, shared with tests/test_torch_flash.py and
# tests/test_torch_syrk.py
_tf32_rna, _tf32x3_mm, _tf32_mm = tf32_rna, tf32x3_mm, tf32_mm


def test_tf32_rounding_is_to_nearest_ties_away():
    one = 1.0 + 2.0**-10  # the TF32 neighbour above 1
    x = torch.tensor([1.0 + 2.0**-11, -(1.0 + 2.0**-11), 1.0 + 2.0**-11 - 2.0**-23, 1.0 + 3 * 2.0**-12, 0.0],
                     dtype=torch.float32)
    assert _tf32_rna(x).tolist() == [one, -one, 1.0, one, 0.0]
    v = torch.from_numpy(np.random.default_rng(2).standard_normal(4096).astype(np.float32))
    big = _tf32_rna(v)
    small = _tf32_rna(v - big)
    assert torch.equal(_tf32_rna(big), big) and torch.equal(_tf32_rna(small), small)  # both exact in TF32
    assert float(((big.double() + small.double() - v.double()).abs() / v.double().abs()).max()) <= 2.0**-22


@pytest.mark.parametrize("inverse", [False, True])
def test_k3_stage_in_3xtf32_holds_f32_accuracy(inverse):
    """K3's contraction at K = n = 512 (the 512^3 stage's depth), M small,
    with every product taken in 3xTF32: within 1e-6 of a float64 DFT and
    within the FFT tolerance (5e-4) of the reference's Pallas K3 run by the
    interpreter; one TF32 pass misses 1e-5."""
    rng = np.random.default_rng(17)
    n, m = 512, 128
    re = rng.standard_normal((n, m)).astype(np.float32)
    im = rng.standard_normal((n, m)).astype(np.float32)
    w = _leading._w(_leading._w_cat, n, "float32", inverse, 1.0, like=_t(re))
    c, s = w[:, :n], w[:, n:]
    a_re, a_im = _t(re).T.contiguous(), _t(im).T.contiguous()  # (M, K): row r of the output

    def stage(mm):
        return mm(a_re, c) - mm(a_im, s), mm(a_re, s) + mm(a_im, c)

    got = stage(_tf32x3_mm)
    z = re.astype(np.float64) + 1j * im
    truth = (np.fft.ifft(z, axis=0) * n if inverse else np.fft.fft(z, axis=0)).T
    got_c = _np(got[0]).astype(np.float64) + 1j * _np(got[1])
    assert _rel(got_c, truth) < 1e-6
    want = ref_leading._stage_fused_pallas(re, im, n, inverse, 1.0)
    assert _rel(got_c, np.asarray(want[0]) + 1j * np.asarray(want[1])) < 5e-4
    one = stage(_tf32_mm)
    assert _rel(_np(one[0]).astype(np.float64) + 1j * _np(one[1]), truth) > 1e-5
