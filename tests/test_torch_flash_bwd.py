"""The gradient of the port's flash attention (heat_tpu_torch/nn/_flash.py):
the plain backward (the function the card's K7-bwd kernels are held to)
against jax.grad of the JAX package's own flash attention, whose backward is
the Pallas TPU dkv and dq kernels, run by the Pallas interpreter, padding
rows included; then against float64 at ragged shapes, gradcheck of the
autograd Function, and the gradients of ring and Ulysses attention against
jax.grad of the JAX package's functions in a world of one."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import heat_tpu as hj
import heat_tpu_torch as ht
from heat_tpu.nn import attention as ref_attention
from heat_tpu_torch.nn import _flash

S, H, D = 256, 2, 64  # the reference kernel's blocks are 128 long: s a multiple of 128
SCALE = 1.0 / np.sqrt(D)
CASES = [(causal, n_true) for causal in (False, True) for n_true in (S, 200)]
# the interpreted kernels sit 1.2e-6 from float64; the plain backward about as far
TOL = 1e-5


def _arrays(s, h, d, seed, n=4):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((s, h, d)).astype(np.float32) for _ in range(n))


def _port_grads(q, k, v, g, scale, causal, n_true, fn=None):
    """dQ, dK, dV of sum(attention * g) through the port, as numpy."""
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = (fn or _flash.flash_attention)(tq, tk, tv, scale, causal, n_true)
    out.backward(torch.from_numpy(g))
    return tuple(t.grad.numpy() for t in (tq, tk, tv))


def _truth_grads(q, k, v, g, scale, causal, n_true):
    """The same gradients in float64 from a dense masked attention under
    torch's autograd, written independently of the port."""
    tq, tk, tv = (torch.from_numpy(x.astype(np.float64)).requires_grad_() for x in (q, k, v))
    pos = torch.arange(q.shape[0])
    pad = pos >= n_true
    mask = pad[:, None] == pad[None, :]
    if causal:
        mask &= pos[None, :] <= pos[:, None]
    scores = torch.einsum("qhd,khd->hqk", tq, tk) * scale
    out = torch.einsum("hqk,khd->qhd", torch.softmax(scores.masked_fill(~mask, float("-inf")), -1), tv)
    out.backward(torch.from_numpy(g.astype(np.float64)))
    return tuple(t.grad.numpy() for t in (tq, tk, tv))


def _rel(got, want):
    """max abs error over max abs, taken over the three gradients together."""
    err = max(np.abs(np.asarray(a, np.float64) - b).max() for a, b in zip(got, want))
    return err / max(np.abs(b).max() for b in want)


@pytest.fixture(scope="module")
def reference():
    """jax.grad through the reference's Pallas flash kernel for CASES: four
    interpreted forwards and backwards (dkv and dq kernels), with x64 off
    as on a TPU (its causal index maps mix int32 and int64 under x64)."""
    q, k, v, g = _arrays(S, H, D, 0)
    out = {}
    with pltpu.force_tpu_interpret_mode(), jax.enable_x64(False):
        for causal, n_true in CASES:
            def loss(a, b, c):
                return jnp.sum(ref_attention._local_flash(a, b, c, SCALE, causal, n_true) * jnp.asarray(g))

            grads = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
            out[causal, n_true] = tuple(np.asarray(x) for x in grads)
    return (q, k, v, g), out


@pytest.mark.parametrize("causal,n_true", CASES)
def test_plain_backward_matches_the_reference_kernels(reference, causal, n_true):
    (q, k, v, g), want = reference
    got = _port_grads(q, k, v, g, SCALE, causal, n_true)
    for a, b in zip(got, want[causal, n_true]):  # padding rows too
        assert a.shape == (S, H, D) and a.dtype == np.float32
        np.testing.assert_allclose(a, b, atol=TOL, rtol=0)
    assert _rel(want[causal, n_true], _truth_grads(q, k, v, g, SCALE, causal, n_true)) < TOL


@pytest.mark.parametrize("s,n_true", [(1, 1), (63, 60), (65, 65), (200, 137)])
@pytest.mark.parametrize("d", [16, 100, 256])
@pytest.mark.parametrize("causal", [False, True])
def test_plain_backward_at_ragged_shapes(s, n_true, d, causal):
    q, k, v, g = _arrays(s, 2, d, s + d)
    scale = 1.0 / np.sqrt(d)
    want = _truth_grads(q, k, v, g, scale, causal, n_true)
    assert _rel(_port_grads(q, k, v, g, scale, causal, n_true), want) < TOL


def test_plain_backward_in_query_blocks_equals_one_block(monkeypatch):
    q, k, v, g = _arrays(130, 3, 16, 9)
    whole = [_port_grads(q, k, v, g, 0.3, causal, 100) for causal in (False, True)]
    monkeypatch.setattr(_flash, "_PLAIN_SCORES", 3 * 130 * 7)  # blocks of 7 queries
    for causal, want in zip((False, True), whole):
        assert _rel(_port_grads(q, k, v, g, 0.3, causal, 100), want) < 1e-6


@pytest.mark.parametrize("causal,n_true", [(False, 9), (True, 9), (True, 6), (False, 0)])
def test_the_function_passes_gradcheck_in_float64(causal, n_true):
    rng = np.random.default_rng(n_true)
    x = [torch.tensor(rng.standard_normal((9, 2, 5)), requires_grad=True) for _ in range(3)]
    assert torch.autograd.gradcheck(lambda a, b, c: _flash._FlashAttention.apply(a, b, c, 0.4, causal, n_true), x)


def test_the_wrapper_on_the_cpu():
    """A gradient wanted: the Function, with a grad_fn, from the plain
    versions (no kernel launched); none wanted: the forward alone, the same
    values.  Strided inputs and a stride-0 gradient are taken."""
    q, k, v, g = _arrays(40, 4, 8, 3)
    before = (_flash.FLASH_LAUNCHES, dict(_flash.FLASH_BWD_LAUNCHES))
    base = torch.from_numpy(np.ascontiguousarray(q.transpose(1, 0, 2))).requires_grad_()
    tq = base.transpose(0, 1)  # (s, h, d), strided
    tk, tv = (torch.from_numpy(x).requires_grad_() for x in (k, v))
    out = _flash.flash_attention(tq, tk, tv, 0.5, True, 33)
    assert out.grad_fn is not None
    with torch.no_grad():
        plain = _flash.flash_attention(tq, tk, tv, 0.5, True, 33)
    assert plain.grad_fn is None
    np.testing.assert_array_equal(out.detach().numpy(), plain.numpy())
    out.sum().backward()  # autograd's gradient of a sum is an expanded, stride-0 tensor
    want = _truth_grads(q, k, v, np.ones_like(g), 0.5, True, 33)
    assert _rel((base.grad.transpose(0, 1).numpy(), tk.grad.numpy(), tv.grad.numpy()), want) < TOL
    assert (_flash.FLASH_LAUNCHES, _flash.FLASH_BWD_LAUNCHES) == before  # no kernel on the CPU


def test_the_gate_counts_the_backwards_shorter_tiles():
    """The backward's blocks own 32 rows at d > 128, so the gate counts
    blocks of 32: a shape the forward's blocks of 64 would fit is refused."""
    s, h = 64 << 25, 33  # 2^25 * 33 blocks of 64 fit the grid; 2^26 * 33 of 32 do not
    assert "at most" in _flash.flash_unsupported(s, h, 64, torch.float32)
    assert _flash.flash_unsupported(s, 16, 64, torch.float32) is None


# ----------------------------------------------------------------------
# ring and Ulysses attention in a world of one against jax.grad of the JAX
# package's functions.  On the CPU the reference's Ulysses runs its einsum
# path, which masks padded keys only, while the port's flash path isolates
# the padded tail as a segment; a loss over the real tokens (a zero
# cotangent on the padded rows) sees the same gradients either way.
# ----------------------------------------------------------------------
@pytest.mark.parametrize("method", ["ring", "ulysses", "flash"])
@pytest.mark.parametrize("causal", [False, True])
def test_sequence_parallel_gradients_match_the_reference(method, causal):
    s, h, d, n_true = 256, 2, 64, 200
    q, k, v, g = _arrays(s, h, d, 11)
    g[n_true:] = 0.0
    comm = hj.Communication(jax.devices()[:1])
    ref_fn = hj.nn.ring_attention if method == "ring" else hj.nn.ulysses_attention
    kw = {"use_flash": True} if method == "flash" else {}

    def loss(a, b, c):
        return jnp.sum(ref_fn(a, b, c, comm=comm, causal=causal, n_true=n_true, **kw) * jnp.asarray(g))

    want = [np.asarray(x) for x in jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))]
    port_fn = ht.nn.ring_attention if method == "ring" else ht.nn.ulysses_attention
    got = _port_grads(q, k, v, g, None, causal, n_true,
                      fn=lambda a, b, c, scale, cz, nt: port_fn(a, b, c, causal=cz, n_true=nt, **kw))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, atol=TOL, rtol=0)
