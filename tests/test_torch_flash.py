"""The plain version of the port's flash-attention kernel (K7,
heat_tpu_torch/nn/_flash.py) against the JAX package's own: the Pallas TPU
flash kernel that heat_tpu/nn/attention.py::_local_flash calls, run by the
Pallas interpreter, padding rows included; then against float64 numpy at
ragged shapes, and the gate of the CUDA kernel."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from heat_tpu.nn import attention as ref_attention
from heat_tpu_torch.nn import _flash

S, H, D = 256, 2, 64  # the reference kernel's blocks are 128 long: s a multiple of 128
SCALE = 1.0 / np.sqrt(D)
CASES = [(causal, n_true) for causal in (False, True) for n_true in (S, 200)]
# the interpreted kernel sits 6.7e-7 from float64; the plain version ~3e-7
TOL = 1e-5


def _qkv(s, h, d, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((s, h, d)).astype(np.float32) for _ in range(3))


def _truth(q, k, v, scale, causal, n_true):
    """Attention in float64 with the kernel's masking: a query attends a
    key iff both lie before n_true or both at or after it, and (causal)
    the key is not after the query."""
    q, k, v = (x.astype(np.float64) for x in (q, k, v))
    pos = np.arange(q.shape[0])
    pad = pos >= n_true
    mask = pad[:, None] == pad[None, :]
    if causal:
        mask &= pos[None, :] <= pos[:, None]
    scores = np.where(mask[None], np.einsum("qhd,khd->hqk", q, k) * scale, -np.inf)
    w = np.exp(scores - scores.max(-1, keepdims=True))
    return np.einsum("hqk,khd->qhd", w / w.sum(-1, keepdims=True), v)


def _plain(q, k, v, scale, causal, n_true):
    return _flash._flash_plain(*(torch.from_numpy(x) for x in (q, k, v)), scale, causal, n_true).numpy()


@pytest.fixture(scope="module")
def reference():
    """The reference kernel's outputs for CASES: four interpreted calls.
    The kernel's causal index maps mix int32 and int64 under x64, so it
    runs with x64 off, as on a TPU."""
    q, k, v = _qkv(S, H, D, 0)
    out = {}
    with pltpu.force_tpu_interpret_mode(), jax.enable_x64(False):
        for causal, n_true in CASES:
            got = ref_attention._local_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), SCALE, causal, n_true)
            out[causal, n_true] = np.asarray(got)
    return (q, k, v), out


@pytest.mark.parametrize("causal,n_true", CASES)
def test_plain_matches_the_reference_kernel(reference, causal, n_true):
    (q, k, v), want = reference
    got = _plain(q, k, v, SCALE, causal, n_true)
    assert got.shape == (S, H, D) and got.dtype == np.float32
    np.testing.assert_allclose(got, want[causal, n_true], atol=TOL, rtol=0)  # padding rows too
    np.testing.assert_allclose(want[causal, n_true], _truth(q, k, v, SCALE, causal, n_true), atol=TOL, rtol=0)


@pytest.mark.parametrize("s,h,d,n_true", [(1, 1, 1, 1), (7, 3, 16, 5), (130, 2, 256, 130), (130, 1, 16, 64), (7, 2, 1, 0)])
@pytest.mark.parametrize("causal", [False, True])
def test_plain_at_ragged_shapes(s, h, d, n_true, causal):
    q, k, v = _qkv(s, h, d, s + d)
    scale = 1.0 / np.sqrt(d)
    np.testing.assert_allclose(_plain(q, k, v, scale, causal, n_true), _truth(q, k, v, scale, causal, n_true),
                               atol=TOL, rtol=0)


def test_plain_in_query_blocks_equals_one_block(monkeypatch):
    q, k, v = _qkv(130, 3, 16, 9)
    whole = [_plain(q, k, v, 0.3, causal, 100) for causal in (False, True)]
    monkeypatch.setattr(_flash, "_PLAIN_SCORES", 3 * 130 * 7)  # blocks of 7 queries
    for causal, want in zip((False, True), whole):
        np.testing.assert_allclose(_plain(q, k, v, 0.3, causal, 100), want, atol=1e-6, rtol=0)


def test_wrapper_on_the_cpu_takes_the_plain_version_and_strided_inputs():
    q, k, v = _qkv(40, 4, 8, 3)
    before = _flash.FLASH_LAUNCHES
    qt = torch.from_numpy(np.ascontiguousarray(q.transpose(1, 0, 2))).transpose(0, 1)  # (s, h, d), strided
    got = _flash.flash_attention(qt, torch.from_numpy(k), torch.from_numpy(v), 0.5, True, 33)
    assert _flash.FLASH_LAUNCHES == before  # no kernel on the CPU
    np.testing.assert_allclose(got.numpy(), _truth(q, k, v, 0.5, True, 33), atol=TOL, rtol=0)
    # n_true past the sequence means no padding
    np.testing.assert_array_equal(_flash.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)), 0.5, False, 99).numpy(),
                                  _plain(q, k, v, 0.5, False, 40))
    with pytest.raises(ValueError, match="one"):
        _flash.flash_attention(torch.zeros(4, 2, 8), torch.zeros(4, 2, 8), torch.zeros(5, 2, 8), 1.0, False, 4)


@pytest.mark.parametrize(
    "s,h,d,dtype,reason",
    [
        (16, 2, 64, torch.float64, "float32"),
        (16, 2, 64, torch.bfloat16, "float32"),
        (16, 2, 0, torch.float32, "head dimension"),
        (16, 2, 257, torch.float32, "head dimension"),
        (0, 2, 64, torch.float32, "s >= 1"),
        (16, 0, 64, torch.float32, "h >= 1"),
        (1 << 40, 1 << 10, 64, torch.float32, "at most"),
    ],
)
def test_gate_refuses(s, h, d, dtype, reason):
    assert reason in _flash.flash_unsupported(s, h, d, dtype)


@pytest.mark.parametrize("s,h,d", [(1, 1, 1), (16384, 8, 64), (1000, 3, 256), (127, 1, 16)])
def test_gate_takes(s, h, d):
    assert _flash.flash_unsupported(s, h, d, torch.float32) is None


# ----------------------------------------------------------------------
# the precision of csrc/flash_attn.cu: 3xTF32 on the tensor cores,
# emulated with integer operations on the f32 bits (core/_tf32x3.py)
# ----------------------------------------------------------------------
def _flash_emulated(q, k, v, scale, causal, n_true, mm):
    """K7's arithmetic on (s, h, d) float32 tensors: per query tile of 64
    and key tile of 64 (the kernel's tiles), S = Q K^T as one chain, the
    online softmax in float32 (m, l, corr), this tile's P V from zero and
    added to the rescaled output, the output divided by l at the end.  The
    products are ``mm`` (3xTF32, or one TF32 pass for contrast)."""
    s, h, d = q.shape
    qh, kh, vh = (x.permute(1, 0, 2) for x in (q, k, v))  # (h, s, d)
    out = torch.empty((s, h, d), dtype=torch.float32)
    pos = torch.arange(s)
    for i0 in range(0, s, 64):
        i1 = min(s, i0 + 64)
        rows = pos[i0:i1]
        m = torch.full((h, i1 - i0, 1), float("-inf"))
        l = torch.zeros((h, i1 - i0, 1))
        o = torch.zeros((h, i1 - i0, d))
        for k0 in range(0, (i1 if causal else s), 64):
            k1 = min(s, k0 + 64)
            keys = pos[k0:k1]
            ok = (keys[None, :] >= n_true) == (rows[:, None] >= n_true)
            if causal:
                ok &= keys[None, :] <= rows[:, None]
            if not bool(ok.any()):
                continue  # a tile the kernel skips
            x = mm(qh[:, i0:i1], kh[:, k0:k1].transpose(1, 2)) * scale
            x = x.masked_fill(~ok, float("-inf"))
            m_new = torch.maximum(m, x.amax(-1, keepdim=True))
            base = torch.where(m_new == float("-inf"), torch.zeros_like(m_new), m_new)
            corr = torch.exp(m - base)
            p = torch.exp(x - base)
            l = l * corr + p.sum(-1, keepdim=True)
            m = m_new
            o = o * corr + mm(p, vh[:, k0:k1])
        out[i0:i1] = (o / l).permute(1, 0, 2)
    return out


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("causal,n_true", [(True, 1024), (False, 1000), (True, 1000)])
def test_3xtf32_flash_holds_f32_accuracy(causal, n_true):
    """K7's tiles and chains at d = 64, s = 1024 with every product in
    3xTF32: within 1e-6 of float64, and within 1e-5 of the reference's
    Pallas flash kernel (interpreted); one TF32 pass misses 1e-5."""
    from heat_tpu_torch.core._tf32x3 import tf32_mm, tf32x3_mm

    s, h, d = 1024, 2, 64
    q, k, v = _qkv(s, h, d, 21)
    scale = 1.0 / np.sqrt(d)
    truth = _truth(q, k, v, scale, causal, n_true)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    got = _flash_emulated(tq, tk, tv, scale, causal, n_true, tf32x3_mm).numpy()
    assert _rel(got, truth) < 1e-6
    with pltpu.force_tpu_interpret_mode(), jax.enable_x64(False):
        want = np.asarray(ref_attention._local_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale, causal,
                                                     n_true))
    assert _rel(got, want) < TOL
    one = _flash_emulated(tq, tk, tv, scale, causal, n_true, tf32_mm).numpy()
    assert _rel(one, truth) > TOL


def test_3xtf32_flash_with_a_peaked_softmax():
    """q scaled by 8 (the card's stress case, at the interpreter's size): the
    scores are large, so float32 itself sits about 2.6e-6 from float64 here.
    The 3xTF32 emulation stays within the card's 1e-5 of the plain version
    and of float64; one TF32 pass misses both by two orders."""
    from heat_tpu_torch.core._tf32x3 import tf32_mm, tf32x3_mm

    s, h, d = 512, 2, 64
    q, k, v = _qkv(s, h, d, 23)
    q = q * 8
    for causal in (False, True):
        truth = _truth(q, k, v, 0.125, causal, s - 37)
        plain = _plain(q, k, v, 0.125, causal, s - 37)
        tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
        got = _flash_emulated(tq, tk, tv, 0.125, causal, s - 37, tf32x3_mm).numpy()
        assert _rel(got, plain) < TOL and _rel(got, truth) < TOL
        one = _flash_emulated(tq, tk, tv, 0.125, causal, s - 37, tf32_mm).numpy()
        assert _rel(one, truth) > 100 * TOL
