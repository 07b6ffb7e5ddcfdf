"""The port's ht.fft against heat_tpu on the same numpy inputs and against
numpy in float64.

The reference runs its accelerator route: the planar path
(``HEAT_TPU_PLANAR=1``) with its fused axis pass on (``HEAT_TPU_FFT_PALLAS=1``);
the port has that one route, with its kernels' plain versions on the CPU.
Complex results are native complex tensors in the port and planar in the
reference, so they are compared by value.  Tolerance: ``_rel`` (max abs
difference / max abs of the truth) below 5e-4, tests/test_fft_leading.py's
own for whole transforms."""

import numpy as np
import pytest
import torch

import heat_tpu as hj
import heat_tpu_torch as ht
from heat_tpu_torch.fft import _axis_pass, _leading

NORMS = [None, "ortho", "forward", "backward"]


@pytest.fixture(autouse=True)
def _routes(monkeypatch):
    ht.use_device("cpu")
    monkeypatch.setenv("HEAT_TPU_PLANAR", "1")
    monkeypatch.setenv("HEAT_TPU_FFT_PALLAS", "1")


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-12)


def _data(shape, complex_, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape)
    if complex_:
        x = x + 1j * rng.standard_normal(shape)
        return x.astype(np.complex64)
    return x.astype(np.float32)


def _check(name, x, *, ref=True, split=None, **kw):
    got = getattr(ht.fft, name)(ht.array(x, split=split), **kw)
    want = getattr(np.fft, name)(x.astype(np.complex128 if np.iscomplexobj(x) else np.float64), **kw)
    assert got.shape == want.shape and got.split == split
    assert got.larray_padded.is_complex() == np.iscomplexobj(want)
    assert _rel(got.numpy(), want) < 5e-4, name
    if ref:
        theirs = getattr(hj.fft, name)(hj.array(x, split=split), **kw).numpy()
        assert _rel(got.numpy(), theirs) < 5e-4, name
    return got


@pytest.mark.parametrize("norm", NORMS)
@pytest.mark.parametrize("shape", [(8, 6, 10), (12, 10)])
@pytest.mark.parametrize("complex_", [False, True])
def test_fftn_and_ifftn(shape, complex_, norm):
    x = _data(shape, complex_)
    for name in ("fftn", "ifftn"):
        _check(name, x, norm=norm, ref=norm in (None, "ortho"))


def test_fftn_of_an_odd_leading_axis_takes_the_interleaved_engine():
    _check("fftn", _data((7, 8, 6), False))
    _check("fftn", _data((9, 6), False))
    _check("ifftn", _data((7, 8, 6), False))


def test_real_fftn_takes_k3_and_k5_and_complex_fftn_k4(monkeypatch):
    """The 3-D real fftn is the leading engine's (K3 blocked, K5); a complex
    fftn/ifftn takes K4 three times; a real fft2 takes one K4 stage; each
    through its plain version here."""
    calls = []
    for name in ("_stage_fused_blocked", "_ext_fused", "_stage_pair_fused", "_entry_pair_fused"):
        orig = getattr(_leading, name)

        def spy(*a, _orig=orig, _name=name, **k):
            calls.append(_name)
            return _orig(*a, **k)

        monkeypatch.setattr(_leading, name, spy)
    y = ht.fft.fftn(ht.array(_data((8, 6, 10), False)))
    assert calls == ["_stage_fused_blocked", "_ext_fused"]
    calls.clear()
    ht.fft.ifftn(y)
    assert calls == ["_entry_pair_fused", "_stage_pair_fused", "_stage_pair_fused"]
    calls.clear()
    ht.fft.fft2(ht.array(_data((12, 10), False)))
    assert calls == ["_stage_pair_fused"]


@pytest.mark.parametrize("norm", [None, "ortho"])
def test_fft2_and_ifft2(norm):
    _check("fft2", _data((16, 12), False), norm=norm)
    _check("ifft2", _data((16, 12), True), norm=norm)
    _check("fft2", _data((5, 6, 8), True), norm=norm, axes=(0, 2))


@pytest.mark.parametrize("n", [40, 96, 131, 384, 512, 1000])
def test_one_dimensional_transforms(n):
    """n <= 64: the matrix base case; 131 (prime past 64): Bluestein; 96,
    384, 512, 1000: K6; each against numpy and the reference."""
    xr = _data((3, n), False, seed=n)
    xc = _data((3, n), True, seed=n)
    ref = n in (96, 131, 1000)  # the reference's kernel in interpret mode is slow: one kind each
    for name, x in (("fft", xc), ("ifft", xc), ("rfft", xr), ("ihfft", xr)):
        _check(name, x, ref=ref and name == "fft")
    h = np.fft.rfft(xr).astype(np.complex64)  # a Hermitian input for irfft / hfft
    for name in ("irfft", "hfft"):
        _check(name, h, ref=ref and name == "irfft" and n == 96, n=n)


def test_k6_takes_the_rows_where_its_gate_admits_them(monkeypatch):
    calls = []
    orig = _axis_pass.fused_axis_pass

    def spy(re, im, inverse):
        calls.append(re.shape[-1])
        return orig(re, im, inverse)

    monkeypatch.setattr(_axis_pass, "fused_axis_pass", spy)
    for n in (40, 96, 131, 262, 1000):
        ht.fft.fft(ht.array(_data((2, n), True)))
    # 40: matrix base case; 131: Bluestein (its power-of-two convolution of
    # 512 rides K6 twice); 262 = 2 x 131: the four-step, whose 131-point
    # factor is Bluestein again
    assert calls[0] == 96 and calls[-1] == 1000
    assert 40 not in calls and 131 not in calls and 262 not in calls


@pytest.mark.parametrize("norm", [None, "forward"])
def test_explicit_lengths_and_axes(norm):
    x = _data((6, 20), True)
    _check("fft", x, n=24, axis=0, norm=norm)
    _check("ifft", x, n=15, norm=norm)
    _check("fftn", _data((6, 8, 5), True), s=(4, 10), axes=(0, 2), norm=norm)
    _check("rfft", _data((6, 20), False), n=30, axis=0, norm=norm)


@pytest.mark.parametrize("norm", [None, "ortho"])
def test_real_and_hermitian_nd_kinds(norm):
    x3, x2 = _data((6, 8, 10), False), _data((8, 12), False)
    _check("rfftn", x3, norm=norm)
    _check("rfft2", x2, norm=norm)
    got = ht.fft.ihfft2(ht.array(x2), norm=norm).numpy()
    want = np.fft.ifft(np.fft.ihfft(x2.astype(np.float64), axis=1, norm=norm), axis=0, norm=norm)
    assert _rel(got, want) < 5e-4
    assert _rel(got, hj.fft.ihfft2(hj.array(x2), norm=norm).numpy()) < 5e-4
    h3 = np.fft.rfftn(x3).astype(np.complex64)
    h2 = np.fft.rfft2(x2).astype(np.complex64)
    _check("irfftn", h3, norm=norm, s=(6, 8, 10), axes=(0, 1, 2))
    _check("irfft2", h2, norm=norm)
    got = ht.fft.hfft2(ht.array(h2), norm=norm).numpy()
    want = np.fft.hfft(np.fft.fft(h2.astype(np.complex128), axis=0, norm=norm), axis=1, norm=norm)
    assert _rel(got, want) < 5e-4
    # numpy has no hfftn/ihfftn: the reference and the chain of 1-D numpy calls
    got = ht.fft.hfftn(ht.array(h3), norm=norm).numpy()
    want = np.fft.hfft(np.fft.fft(np.fft.fft(h3.astype(np.complex128), axis=0, norm=norm), axis=1, norm=norm), axis=2, norm=norm)
    assert _rel(got, want) < 5e-4
    assert _rel(got, hj.fft.hfftn(hj.array(h3), norm=norm).numpy()) < 5e-4
    got = ht.fft.ihfftn(ht.array(x3), norm=norm).numpy()
    want = np.fft.ifft(np.fft.ifft(np.fft.ihfft(x3.astype(np.float64), axis=2, norm=norm), axis=0, norm=norm), axis=1, norm=norm)
    assert _rel(got, want) < 5e-4
    assert _rel(got, hj.fft.ihfftn(hj.array(x3), norm=norm).numpy()) < 5e-4


def test_float64_takes_the_matmul_route_in_complex128():
    x = _data((8, 6, 10), False).astype(np.float64)
    y = ht.fft.fftn(ht.array(x))
    assert y.larray_padded.dtype == torch.complex128
    np.testing.assert_allclose(y.numpy(), np.fft.fftn(x), atol=1e-9)
    back = ht.fft.ifftn(y)
    np.testing.assert_allclose(back.numpy(), x, atol=1e-12)
    f = ht.fft.fft(ht.array(_data((3, 1000), True).astype(np.complex128)))
    assert f.larray_padded.dtype == torch.complex128


def test_integer_input_promotes_to_complex64():
    x = np.arange(24, dtype=np.int32).reshape(4, 6)
    y = ht.fft.fft2(ht.array(x))
    assert y.dtype is ht.complex64
    assert _rel(y.numpy(), np.fft.fft2(x)) < 5e-4


def test_split_axis_kept_in_a_world_of_one():
    x = _data((8, 6, 10), True)
    y = _check("fftn", x, split=0)
    assert y.lshape == (8, 6, 10)
    _check("fft", x, split=1, axis=1)


# A transformed split axis in a world of one takes the output's extent:
# rfft/ihfft halve it, irfft/hfft and an explicit n or s set it.
_SPLIT_AXIS_CASES = [
    ("rfft", {}),
    ("ihfft", {}),
    ("irfft", {}),
    ("hfft", {}),
    ("fft", {"n": 16, "axis": 0}),
    ("fft2", {"s": (16, 4)}),
    ("fftn", {"s": (16, 4), "axes": (0, 1)}),
]


@pytest.mark.parametrize("split", [0, 1])
@pytest.mark.parametrize("name,kw", _SPLIT_AXIS_CASES, ids=[c[0] + ("_n" if c[1] else "") for c in _SPLIT_AXIS_CASES])
def test_transformed_split_axis_takes_the_output_extent_in_a_world_of_one(name, kw, split):
    complex_in = name in ("irfft", "hfft")
    x = _data((12, 10), complex_in, seed=5)
    if name in ("rfft", "ihfft", "irfft", "hfft") and split == 0:
        kw = {"axis": 0}
    got = _check(name, x, split=split, **kw)
    assert got.lshape == got.shape


def test_real_input_to_rfft_only():
    with pytest.raises(TypeError):
        ht.fft.rfft(ht.array(_data((4, 8), True)))
    with pytest.raises(TypeError):
        ht.fft.ihfftn(ht.array(_data((4, 8), True)))
    with pytest.raises(TypeError):
        ht.fft.fft(np.zeros(4))


def test_frequencies_and_shifts():
    for n, d in ((8, 1.0), (9, 0.1)):
        for name in ("fftfreq", "rfftfreq"):
            got = getattr(ht.fft, name)(n, d=d)
            want = getattr(hj.fft, name)(n, d=d).numpy()
            assert got.dtype is ht.float32
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
            np.testing.assert_allclose(got.numpy(), getattr(np.fft, name)(n, d=d), rtol=1e-6)
    assert ht.fft.fftfreq(8, dtype=ht.float64).dtype is ht.float64
    x = _data((5, 8), True)
    for axes in (None, 0, (1,), (0, 1)):
        for name in ("fftshift", "ifftshift"):
            got = getattr(ht.fft, name)(ht.array(x, split=0), axes=axes)
            np.testing.assert_array_equal(got.numpy(), getattr(np.fft, name)(x, axes=axes))
            np.testing.assert_array_equal(got.numpy(), getattr(hj.fft, name)(hj.array(x), axes=axes).numpy())
            assert got.split == 0


def test_reference_spectrum_into_the_ports_inverse():
    x = _data((8, 6, 10), False)
    spec = hj.fft.fftn(hj.array(x, split=0))
    port_spec = ht.interop.from_reference_array(spec.numpy(), split=0)
    assert port_spec.dtype is ht.complex64 and port_spec.split == 0
    assert _rel(ht.fft.ifftn(port_spec).numpy(), x) < 5e-4
    planes = (spec.numpy().real.copy(), spec.numpy().imag.copy())
    from_planes = ht.interop.from_reference_array(planes)
    np.testing.assert_array_equal(from_planes.numpy(), port_spec.numpy())
    with pytest.raises(ValueError):
        ht.interop.from_reference_array((planes[0], planes[1][:2]))


def test_complex_arrays_in_the_array_runtime():
    z = _data((5, 3), True)
    a = ht.array(z, split=0)
    assert a.dtype is ht.complex64 and ht.types.heat_type_is_complexfloating(a.dtype)
    assert ht.types.heat_type_is_inexact(a.dtype)
    np.testing.assert_array_equal(a.numpy(), z)
    assert ht.array([1 + 2j]).dtype is ht.complex64
    assert ht.array(z.astype(np.complex128)).dtype is ht.complex128
    assert ht.types.promote_types(ht.float64, ht.complex64) is ht.complex128
    assert ht.types.canonical_heat_type("complex") is ht.complex64


@pytest.mark.parametrize("inverse", [False, True])
def test_engines_no_entry_point_reaches_against_the_reference(inverse):
    """cfft3/cfft2_interleaved (the reference reaches them only with its
    leading engine switched off) and fftn_planes, held directly."""
    from heat_tpu.fft import _planar as ref_pl
    from heat_tpu_torch.fft import _planar as pl

    for shape, fn in (((6, 8, 10), "cfft3_interleaved"), ((12, 10), "cfft2_interleaved")):
        z = _data(shape, True, seed=len(shape))
        re, im = np.ascontiguousarray(z.real), np.ascontiguousarray(z.imag)
        got = getattr(pl, fn)(torch.from_numpy(re), torch.from_numpy(im), inverse, "ortho")
        want = getattr(ref_pl, fn)(re, im, inverse, "ortho")
        truth = (np.fft.ifftn if inverse else np.fft.fftn)(z.astype(np.complex128), norm="ortho")
        got = got[0].numpy() + 1j * got[1].numpy()
        assert _rel(got, np.asarray(want[0]) + 1j * np.asarray(want[1])) < 5e-4
        assert _rel(got, truth) < 5e-4
    z = _data((6, 40, 96), True, seed=3)
    re, im = np.ascontiguousarray(z.real), np.ascontiguousarray(z.imag)
    got = pl.fftn_planes(torch.from_numpy(re), torch.from_numpy(im), (2, 1), inverse, "forward")
    truth = (np.fft.ifftn if inverse else np.fft.fftn)(z.astype(np.complex128), axes=(2, 1), norm="forward")
    assert _rel(got[0].numpy() + 1j * got[1].numpy(), truth) < 5e-4
