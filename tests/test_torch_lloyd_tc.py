"""The arithmetic of the Lloyd kernel's tc route (csrc/lloyd.cu), emulated on
the CPU, against the JAX package's Pallas Lloyd kernel in interpret mode.

The tc route sums each warp's batch of 32 points per cluster as one-hot
products on the tensor cores: the features split into three TF32 planes
by truncation (``_tf32x3.tf32_split``, exact for float32), the one-hot
matrix of the labels exact; per output tile of 16 features x 8 clusters
three chains of 4 mma (4 steps of 8 points, one chain a plane) started from
zero, added as small + mid + big in float32 and that into float64
accumulators; counts are exact integers (the one-hot fragments' own); the
inertia terms are added in float64.  The emulation below takes the same planes, chains and flushes, with each mma's
8-term dot product and each chain's addition in IEEE float32 (the tensor
core's own accumulation truncates, which the card's checks in chip_smoke.py
and tests/test_torch_gpu.py cover).  Nothing on the kernel's path calls it.

Tolerances are those of tests/test_kernels.py: centres atol 5e-5, inertia
rtol 1e-4; counts exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heat_tpu.cluster.kmeans import _lloyd_step as ref_lloyd_step
from heat_tpu.core import kernels as ref_kernels
from heat_tpu_torch.core import kernels
from heat_tpu_torch.core._tf32x3 import tf32_rna, tf32_split
from heat_tpu_torch.core.linalg.basics import full_f32_matmul

BATCH = 32  # points a warp owns at a time
STEP = 8  # points a mma step takes (its K)


def _emulate_tc(xp: np.ndarray, c: np.ndarray, n_true: int):
    """The tc route's sums, counts and inertia of a padded chunk, by its
    planes, chains and flushes: ``(sums (k, f) f64, counts (k,) f64,
    inertia f64)``."""
    rows, f = xp.shape
    k = c.shape[0]
    fb = 16 * -(-f // 16)
    kb = 8 * -(-k // 8)
    nb = -(-rows // BATCH)
    x = torch.zeros((nb * BATCH, fb), dtype=torch.float32)
    x[:rows, :f] = torch.from_numpy(xp)
    cs = torch.from_numpy(c)
    # labels and the inertia terms: |c|^2 - 2 x.c in float32, first-index argmin
    with full_f32_matmul():
        half = (cs * cs).sum(1)[None, :] - 2.0 * (x[:, :f] @ cs.T)
    lab = torch.argmin(half, dim=1)
    best = half.gather(1, lab[:, None])[:, 0]
    valid = torch.arange(nb * BATCH) < min(n_true, rows)
    lab = torch.where(valid, lab, torch.full_like(lab, -1))
    onehot = (lab[:, None] == torch.arange(kb)[None, :]).to(torch.float32)
    # chains: per batch, output tile and plane, 4 steps from zero; then
    # small + mid + big in float32
    oh = onehot.view(nb, BATCH // STEP, STEP, kb)
    chains = []
    with full_f32_matmul():
        for p in reversed(tf32_split(x)):
            p = p.view(nb, BATCH // STEP, STEP, fb)
            chain = torch.zeros((nb, fb, kb), dtype=torch.float32)
            for s in range(BATCH // STEP):
                chain = chain + p[:, s].transpose(1, 2) @ oh[:, s]
            chains.append(chain)
    sums = ((chains[0] + chains[1]) + chains[2]).double().sum(0)[:f, :k].T
    counts = onehot[:, :k].double().sum(0)
    # inertia: each point's float32 term added in float64
    v = torch.where(valid, (x * x).sum(1) + best, torch.zeros(()))
    return sums, counts, v.double().sum()


CASES = [(1003, 16, 8), (517, 8, 5), (130, 4, 7), (999, 16, 12), (96, 128, 8), (64, 64, 2), (1 << 16, 16, 8)]


@pytest.mark.parametrize("n,f,k", CASES)
def test_tc_sums_match_pallas_interpret(n, f, k):
    rng = np.random.default_rng(n + f + k)
    truth = (rng.standard_normal((k, f)) * 10.0).astype(np.float32)
    x = (truth[rng.integers(0, k, n)] + rng.standard_normal((n, f))).astype(np.float32)
    c = (truth + rng.standard_normal((k, f)).astype(np.float32)).astype(np.float32)
    npad = -(-n // 32) * 32
    xp = np.zeros((npad, f), np.float32)
    xp[:n] = x
    sums, counts, inertia = _emulate_tc(xp, c, n)
    want_c, _, want_i = ref_kernels._lloyd_single(jnp.asarray(xp), jnp.asarray(c), n)
    labels = np.asarray(ref_lloyd_step(jnp.asarray(xp), jnp.asarray(c), n, k)[0])[:n]
    np.testing.assert_array_equal(counts.numpy(), np.bincount(labels, minlength=k))
    mean = sums / counts.clamp(min=1)[:, None]
    got_c = torch.where(counts[:, None] > 0, mean, torch.from_numpy(c).double()).float()
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), atol=5e-5)
    np.testing.assert_allclose(float(inertia), float(want_i), rtol=1e-4)


def test_three_planes_are_exact_and_tf32():
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.standard_normal(1 << 16) * np.exp(rng.standard_normal(1 << 16) * 8)).astype(np.float32))
    big, mid, small = tf32_split(x)
    assert torch.equal(big.double() + mid.double() + small.double(), x.double())
    for p in (big, mid, small):
        assert int((p.view(torch.int32) & 0x1FFF).count_nonzero()) == 0  # no bit the tensor core would drop
        assert torch.equal(tf32_rna(p), p)
    assert bool((big.abs() <= x.abs()).all())  # truncated toward zero
    two = tf32_split(x, 2)
    assert torch.equal(two[0], tf32_rna(x))
    rel = ((two[0].double() + two[1].double() - x.double()).abs() / x.double().abs()).max()
    assert 0 < float(rel) <= 2.0**-22


def test_chain_per_tile_is_exact_for_one_step_of_integers():
    # one batch of small integers: every product and partial sum is exact,
    # so the emulated chains give the sums exactly
    xp = np.arange(32 * 16, dtype=np.float32).reshape(32, 16) % 7
    c = np.stack([np.zeros(16), np.full(16, 6.0)]).astype(np.float32)
    sums, counts, _ = _emulate_tc(xp, c, 32)
    lab = np.argmin(((xp[:, None, :] - c[None]) ** 2).sum(-1), axis=1)
    for j in range(2):
        np.testing.assert_array_equal(sums[j].numpy(), xp[lab == j].astype(np.float64).sum(0))
        assert float(counts[j]) == float((lab == j).sum())


@pytest.mark.parametrize(
    "f,k,route",
    [(16, 8, "tc"), (4, 3, "tc"), (16, 64, "tc"), (16, 65, "walk"), (17, 8, "walk"), (128, 8, "tc"), (128, 9, "walk"),
     (64, 16, "tc"), (64, 17, "walk"), (32, 32, "tc"), (20, 12, "tc"), (1, 1, "walk")],
)
def test_route_rule(f, k, route):
    assert kernels.lloyd_route(f, k) == route
    assert kernels.lloyd_route(f, k, aligned=False) == "walk"
    if route == "tc":
        # the tc route's shared memory: the warps' f64 accumulators, the centres, four rings of 2-3 batches
        fb = 16 * -(-f // 16)
        batch = 64 if fb <= 32 else 32
        assert kernels.lloyd_smem_bytes(f, k) >= 4 * (3 if fb <= 64 else 2) * batch * fb * 4
        assert kernels.lloyd_smem_bytes(f, k) <= 232448


def test_main_path_shape_takes_the_tc_route_within_smem():
    assert kernels.lloyd_route(16, 8) == "tc"
    assert kernels.lloyd_smem_bytes(16, 8) == 8 * 4 * 138 + 4 * (128 + 8 + 4 * 3 * 64 * 16)
    assert kernels.lloyd_unsupported(16, 8) is None
