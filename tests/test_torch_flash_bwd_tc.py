"""The precision of the flash-attention backward's tc route
(heat_tpu_torch/csrc/flash_attn_bwd.cu: flash_bwd_dkv_tc and flash_bwd_dq_tc,
3xTF32 on the tensor cores), emulated with integer operations on the f32
bits (heat_tpu_torch/core/_tf32x3.py) at the kernels' tiles and chains:
against float64, against the plain backward (the function the card holds
the kernels to, within 5e-5), against jax.grad through the JAX package's
flash attention (the Pallas TPU dkv and dq kernels, run by the Pallas
interpreter), and one TF32 pass for contrast.  Also the tc route's pre-pass
layout (its plain version) and the route's gate."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from heat_tpu.nn import attention as ref_attention
from heat_tpu_torch.core._tf32x3 import tf32_mm, tf32_rna, tf32x3_mm
from heat_tpu_torch.nn import _flash

CARD_TOL = 5e-5  # chip_smoke.py's and the card tests' bound of the kernels against the plain backward
TILE = 64  # rows a warpgroup owns and rows of a streamed tile, both kernels
LOG2E = 1.4426950408889634  # the kernels take P as exp2f of a scaled argument (flash_attn_bwd.cu kLog2e)


@pytest.fixture(autouse=True)
def _one_thread():
    """The emulation is thousands of small products: one thread a test, so
    that a run with several workers does not oversubscribe the cores (the
    sums are the same; only their scheduling changes)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _arrays(s, h, d, seed, n=4):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((s, h, d)).astype(np.float32) for _ in range(n))


def _bwd_tc_emulated(q, k, v, do, lse, di, scale, causal, n_true, mm):
    """dQ, dK, dV by the tc route's arithmetic on (s, h, d) float32 tensors:
    per 64 x 64 tile of queries and keys that holds an attended pair, the
    dkv kernel's S^T = K Q^T and dP^T = V dO^T and the dq kernel's S = Q K^T
    and dP = dO V^T, each one chain over the depths; P from the log-sum-exp
    as the kernels take it, 2^(scale log2(e) s - log2(e) lse), and dS = P
    (dP - di) in float32; the tile's P^T dO, dS^T Q and dS K
    from zero, added in float32 to the running dV, dK (over query tiles in
    order) and dQ (over key tiles in order).  The products are ``mm``
    (3xTF32, or one TF32 pass for contrast).

    The loop runs over the key tiles; each step computes the tiles of every
    query tile at once, batched along a tile axis, and adds them in the
    same order as a loop over query tiles would (s a multiple of 64)."""
    s, h, d = q.shape
    assert s % TILE == 0, s
    nt = s // TILE
    tiled = [x.permute(1, 0, 2).reshape(h, nt, TILE, d) for x in (q, k, v, do)]  # (h, tile, row, d)
    qh, kh, vh, gh = tiled
    dq, dk, dv = (torch.zeros((h, nt, TILE, d)) for _ in range(3))
    pos = torch.arange(s)
    zero = torch.zeros(())
    scale2 = torch.tensor(scale * LOG2E, dtype=torch.float32)
    lse2 = (lse * torch.tensor(LOG2E, dtype=torch.float32)).reshape(h, nt, TILE)
    dit = di.reshape(h, nt, TILE)
    pad = pos >= n_true
    allowed = pad[:, None] == pad[None, :]  # (query, key)
    if causal:
        allowed &= pos[None, :] <= pos[:, None]
    allowed = allowed.reshape(nt, TILE, nt, TILE)
    for j in range(nt):
        ok = allowed[:, :, j]  # (query tile, row, key): every query tile against key tile j
        live = ok.flatten(1).any(1)  # the query tiles both kernels visit with key tile j
        if not bool(live.any()):
            continue
        kt, vt = kh[:, j, None], vh[:, j, None]  # (h, 1, 64, d), broadcast over the query tiles
        # flash_bwd_dkv_tc: the warpgroup of keys j, on every query tile
        pt = torch.where(ok.transpose(1, 2), torch.exp2(mm(kt, qh.transpose(2, 3)) * scale2 - lse2[:, :, None, :]),
                         zero)
        dst = pt * (mm(vt, gh.transpose(2, 3)) - dit[:, :, None, :])
        dv_i, dk_i = mm(pt, gh), mm(dst, qh)
        for i in torch.nonzero(live)[:, 0].tolist():  # added over the query tiles in order
            dv[:, j] += dv_i[:, i]
            dk[:, j] += dk_i[:, i]
        # flash_bwd_dq_tc: the warpgroup of each query tile, on key tile j
        p = torch.where(ok, torch.exp2(mm(qh, kt.transpose(2, 3)) * scale2 - lse2[:, :, :, None]), zero)
        dq_j = mm(p * (mm(gh, vt.transpose(2, 3)) - dit[:, :, :, None]), kt)
        dq += torch.where(live[None, :, None, None], dq_j, zero)
    return tuple(x.reshape(h, s, d).permute(1, 0, 2) for x in (dq * scale, dk * scale, dv))


def _inputs(q, k, v, g, scale, causal, n_true):
    """Torch tensors of the arrays, and the log-sum-exp and di the
    kernels receive (the plain forward's, in float32)."""
    tq, tk, tv, tg = (torch.from_numpy(x) for x in (q, k, v, g))
    out, lse = _flash._flash_plain(tq, tk, tv, scale, causal, n_true, with_lse=True)
    return (tq, tk, tv, tg), lse, _flash._bwd_di_plain(out, tg)


def _emulated(q, k, v, g, scale, causal, n_true, mm=tf32x3_mm):
    ts, lse, di = _inputs(q, k, v, g, scale, causal, n_true)
    return [x.numpy() for x in _bwd_tc_emulated(*ts, lse, di, scale, causal, n_true, mm)]


def _plain(q, k, v, g, scale, causal, n_true):
    ts, lse, di = _inputs(q, k, v, g, scale, causal, n_true)
    dk, dv = _flash._bwd_dkv_plain(*ts, lse, di, scale, causal, n_true)
    return [x.numpy() for x in (_flash._bwd_dq_plain(*ts, lse, di, scale, causal, n_true), dk, dv)]


def _truth(q, k, v, g, scale, causal, n_true):
    """dQ, dK, dV of sum(attention * g) in float64 from a dense masked
    attention under torch's autograd."""
    tq, tk, tv = (torch.from_numpy(x.astype(np.float64)).requires_grad_() for x in (q, k, v))
    pos = torch.arange(q.shape[0])
    pad = pos >= n_true
    mask = pad[:, None] == pad[None, :]
    if causal:
        mask &= pos[None, :] <= pos[:, None]
    scores = (torch.einsum("qhd,khd->hqk", tq, tk) * scale).masked_fill(~mask, float("-inf"))
    torch.einsum("hqk,khd->qhd", torch.softmax(scores, -1), tv).backward(torch.from_numpy(g.astype(np.float64)))
    return [t.grad.numpy() for t in (tq, tk, tv)]


def _rel(got, want):
    """max abs error over max abs, over the three gradients together."""
    err = max(np.abs(np.asarray(a, np.float64) - b).max() for a, b in zip(got, want))
    return err / max(np.abs(np.asarray(b, np.float64)).max() for b in want)


@pytest.mark.parametrize("causal,n_true", [(True, 1024), (False, 1024), (True, 1000), (False, 1000)])
def test_3xtf32_backward_holds_f32_accuracy(causal, n_true):
    """s = 1024, h = 2, d = 64: the emulated tc route sits at most 1.1e-6
    from float64 and from the plain backward (as close as float32's own
    plain backward sits to float64), held here within 2e-6, far inside the
    card's 5e-5; one TF32 pass is 4e-4 to 1.4e-3 off, missing both."""
    q, k, v, g = _arrays(1024, 2, 64, 31)
    args = (q, k, v, g, 0.125, causal, n_true)
    truth = _truth(*args)
    got = _emulated(*args)
    assert all(a.shape == (1024, 2, 64) and a.dtype == np.float32 for a in got)
    assert _rel(got, truth) < 2e-6
    assert _rel(got, _plain(*args)) < 2e-6
    assert _rel(_emulated(*args, mm=tf32_mm), truth) > CARD_TOL


@pytest.mark.parametrize("causal", [False, True])
def test_3xtf32_backward_with_a_peaked_softmax(causal):
    """q scaled by 8 (the card's stress case, at a CPU size): float32's own
    plain backward sits up to 2.8e-6 from float64 here and the emulation up
    to 5.4e-6 from either, held within 1e-5; one TF32 pass is about 7e-3 off."""
    q, k, v, g = _arrays(512, 2, 64, 33)
    args = (q * 8, k, v, g, 0.125, causal, 512 - 37)
    truth = _truth(*args)
    got = _emulated(*args)
    assert _rel(got, truth) < 1e-5 and _rel(got, _plain(*args)) < 1e-5
    assert _rel(_emulated(*args, mm=tf32_mm), truth) > 100 * CARD_TOL


S, H, D = 256, 2, 64  # the reference kernels' blocks are 128 long: s a multiple of 128
SCALE = 1.0 / np.sqrt(D)
CASES = [(causal, n_true) for causal in (False, True) for n_true in (S, 200)]


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
def test_3xtf32_backward_matches_the_reference_kernels(reference, causal, n_true):
    """Padding rows too, within 1e-5 of the interpreted Pallas kernels' gradients."""
    (q, k, v, g), want = reference
    got = _emulated(q, k, v, g, SCALE, causal, n_true)
    for a, b in zip(got, want[causal, n_true]):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)


# ----------------------------------------------------------------------
# the pre-pass's layout and the route's gate
# ----------------------------------------------------------------------
def _cm_off(r, j):
    """tf32x3.cuh's cm_off in floats: the place of (row r, depth j) in a
    64 x 64 tile laid out for the wgmma descriptors."""
    return (j >> 3) * 512 + (r >> 3) * 64 + ((j >> 2) & 1) * 32 + (r & 7) * 4 + (j & 3)


def test_tile_order_inverts_the_descriptor_layout():
    rows, cols = _flash._tile_order()
    r, j = torch.meshgrid(torch.arange(64), torch.arange(64), indexing="ij")
    e = _cm_off(r, j)
    assert sorted(e.flatten().tolist()) == list(range(4096))
    assert torch.equal(rows[e], r) and torch.equal(cols[e], j)


def test_prep_plain_lays_out_the_planes():
    """Its planes: big + small of each tensor, natural (rows x depths) and
    transposed (depths x rows, row perm8(p) at position p of each group of
    8), each (h, sp / 64) tiles in the descriptors' layout, sp = s rounded
    up to 128, zeros past s and d; big and small TF32; then lse and di."""
    s, h, d = 130, 3, 33
    arrays = _arrays(s, h, d, 7)
    base = torch.from_numpy(np.ascontiguousarray(np.stack(arrays).transpose(0, 2, 1, 3)))  # (4, h, s, d)
    q, k, v, do = (base[i].transpose(0, 1) for i in range(4))  # strided (s, h, d)
    lse, di = torch.randn(2, h, s, generator=torch.Generator().manual_seed(1))
    out = _flash._bwd_prep_plain(q, k, v, do, lse, di)
    sp = 256
    planes = out[: 14 * h * sp * 64].view(14, h, sp // 64, 4096)
    perm = [8 * (p // 8) + 2 * (p % 4) + (p % 8) // 4 for p in range(sp)]
    assert sorted(perm) == list(range(sp)) and perm[:8] == [0, 2, 4, 6, 1, 3, 5, 7]
    r, j = torch.meshgrid(torch.arange(64), torch.arange(64), indexing="ij")
    at = _cm_off(r, j)  # (64, 64): the place of each (row, depth) of a tile
    for i, x in enumerate((q, k, v, do, q, k, do)):
        big, small = planes[2 * i], planes[2 * i + 1]
        assert torch.equal(big, tf32_rna(big)) and torch.equal(small, tf32_rna(small))
        whole = (big + small).double()[:, :, at]  # (h, tile, row, depth) of the plane
        want = torch.zeros((h, sp, 64), dtype=torch.float64)
        want[:, :s, :d] = x.permute(1, 0, 2).double()
        if i < 4:
            want = want.view(h, sp // 64, 64, 64)
        else:  # row = depth, depth = position within the tile of rows
            want = want[:, perm].view(h, sp // 64, 64, 64).transpose(2, 3)
        assert float((whole - want).abs().max()) <= 2.0**-21 * float(want.abs().max())
        assert not bool(whole[want == 0].any())
    pad = out[14 * h * sp * 64:].view(2, h, sp)
    assert torch.equal(pad[:, :, :s], torch.stack((lse, di))) and not bool(pad[:, :, s:].any())


@pytest.mark.parametrize("s,h,d,route", [(16384, 8, 64, "tc"), (1, 1, 1, "tc"), (1000, 3, 33, "tc"),
                                         (100, 2, 65, "cuda_core"), (100, 2, 128, "cuda_core"),
                                         (100, 2, 256, "cuda_core")])
def test_bwd_route_by_head_dimension(s, h, d, route):
    assert _flash.bwd_route(s, h, d) == route


def test_the_tc_route_refuses_wide_heads_and_unknown_routes():
    q = torch.zeros(4, 1, 65)
    with pytest.raises(ValueError, match="d <= 64"):
        _flash._route(q, "tc")
    with pytest.raises(ValueError, match="routes"):
        _flash._route(q, "walk")
    assert _flash._route(q, None) == "cuda_core" and _flash._route(q[..., :64], "cuda_core") == "cuda_core"
