"""The FFT's "weights" -- its DFT, twiddle, chirp and exit matrices -- carried
across: every weight function of heat_tpu_torch.fft is bitwise equal to the
reference's (heat_tpu.fft) at even, odd and prime n, in both directions.
Both packages build them on the host in float64 with the same formulas."""

import numpy as np
import pytest

from heat_tpu.fft import _leading as ref_leading
from heat_tpu.fft import _pallas_fft as ref_pf
from heat_tpu.fft import _planar as ref_planar
from heat_tpu_torch.fft import _axis_pass, _leading, _planar

NS = [2, 8, 12, 15, 97, 128, 131]


def _same(got, want):
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
        return
    if isinstance(want, (int, np.integer)):
        assert got == want
        return
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(np.ascontiguousarray(got).view(np.uint8), np.ascontiguousarray(want).view(np.uint8))


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("inverse", [False, True])
def test_leading_weights_are_bitwise_the_references(n, inverse):
    _same(_leading._cs(n, inverse), ref_leading._cs(n, inverse))
    for dt in ("float32", "float64"):
        for scale in (1.0, 1.0 / n, n ** -0.5):
            _same(_leading._w_cat(n, dt, inverse, scale), ref_leading._w_cat(n, dt, inverse, scale))
            _same(_leading._w_cat_im(n, dt, inverse, scale), ref_leading._w_cat_im(n, dt, inverse, scale))
            _same(_leading._w_block(n, dt, inverse, scale), ref_leading._w_block(n, dt, inverse, scale))
        m = max(1, n // 2)
        _same(_leading._w_entry_cat(n, m, dt), ref_leading._w_entry_cat(n, m, dt))
        for part in ("re", "im"):
            _same(_leading._w_entry_half(n, m, dt, part), ref_leading._w_entry_half(n, m, dt, part))


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("inverse", [False, True])
def test_planar_weights_are_bitwise_the_references(n, inverse):
    for dt in ("float32", "float64"):
        _same(_planar._dft_w(n, inverse, dt), ref_planar._dft_w(n, inverse, dt))
        _same(_planar._bluestein_consts(n, inverse, dt), ref_planar._bluestein_consts(n, inverse, dt))
        _same(_planar._w2_full(n, inverse, dt), ref_planar._w2_full(n, inverse, dt))
        _same(_planar._w2_split(n, dt, inverse), ref_planar._w2_split(n, dt, inverse))
        _same(_planar._w2_row_split(n, dt, inverse), ref_planar._w2_row_split(n, dt, inverse))
        _same(_planar._w2_real_in(n, n // 2 + 1, dt), ref_planar._w2_real_in(n, n // 2 + 1, dt))
        for n1, n2 in ((n, 3), (4, n)):
            _same(_planar._twiddle(n1, n2, n1 * n2, inverse, dt), ref_planar._twiddle(n1, n2, n1 * n2, inverse, dt))
        for n_out in (2 * n - 2, 2 * n - 1):
            if n_out >= 2:
                m_used = n_out // 2 + 1
                _same(_planar._w_irfft_exit(m_used, n_out, dt), ref_planar._w_irfft_exit(m_used, n_out, dt))


@pytest.mark.parametrize("n", [96, 127, 384, 512, 1000, 1024, 6])
@pytest.mark.parametrize("inverse", [False, True])
def test_axis_pass_consts_are_bitwise_the_references(n, inverse):
    assert _axis_pass._split_factors(n) == ref_pf._split_factors(n)
    _same(_axis_pass._consts(n, inverse), ref_pf._consts(n, inverse))


def test_split_factor_table():
    for n in (262, 131072, 2 * 131):
        assert _axis_pass._split_factors(n) is None and ref_pf._split_factors(n) is None
