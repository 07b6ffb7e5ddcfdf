"""The port's Gram matrix (heat_tpu_torch.core.kernels.gram_partials) against
the JAX package's one-read Gram kernel ``gram_syrk`` run through the Pallas
interpreter (as tests/test_kernels.py runs it) and against float64 truth.
On the CPU the port's wrapper runs its plain PyTorch version, which is what
is held here; tests/test_torch_gpu.py holds the CUDA kernel against it on
the card.

Tolerances: relative Frobenius error at most 5e-5 against f64 truth (the
reference's own bound for its kernel) and 1e-5 against the reference's
kernel; G exactly symmetric."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import heat_tpu_torch as ht
from heat_tpu.core import kernels as ref_kernels
from heat_tpu_torch.core import kernels
from heat_tpu_torch.core.linalg import svdtools


@pytest.fixture(autouse=True)
def _port_on_cpu():
    ht.use_device("cpu")


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def test_plain_matches_pallas_interpret():
    rng = np.random.default_rng(3)
    m = 2 * ref_kernels._SYRK_TILE + 137  # the reference's kernel plus its XLA tail
    x = rng.standard_normal((m, 128)).astype(np.float32)
    want = np.asarray(ref_kernels.gram_syrk(jnp.asarray(x)))
    got = kernels.gram_partials(torch.from_numpy(x), m)
    assert got.dtype == torch.float32 and got.shape == (128, 128)
    assert _rel(got.numpy(), want) <= 1e-5
    truth = x.astype(np.float64).T @ x.astype(np.float64)
    assert _rel(got.numpy(), truth) <= 5e-5
    assert torch.equal(got, got.T)


@pytest.mark.parametrize(
    "rows,n,n_true",
    [(4233, 128, 4100), (3 * 2048 + 11, 64, 3 * 2048 + 11), (5000, 200, 5000), (2049, 512, 2049), (100, 128, 100), (50, 7, 0)],
)
def test_plain_against_f64_truth_with_poisoned_padding(rows, n, n_true):
    rng = np.random.default_rng(rows + n)
    x = rng.standard_normal((rows, n)).astype(np.float32)
    x[n_true:] = 1e6  # rows at or past n_true are padding and must add nothing
    got = kernels.gram_partials(torch.from_numpy(x), n_true)
    truth = x[:n_true].astype(np.float64).T @ x[:n_true].astype(np.float64)
    if n_true:
        assert _rel(got.numpy(), truth) <= 5e-5
    else:
        assert not got.any()
    assert torch.equal(got, got.T)


def test_cpu_call_leaves_launch_count():
    before = kernels.GRAM_LAUNCHES
    kernels.gram_partials(torch.ones(300, 16), 300)
    assert kernels.GRAM_LAUNCHES == before


def test_gate():
    assert kernels.gram_unsupported(128, torch.float32) is None
    assert kernels.gram_unsupported(1, torch.float32) is None
    assert kernels.gram_unsupported(512, torch.float32) is None
    assert "512 columns" in kernels.gram_unsupported(513, torch.float32)
    assert kernels.gram_unsupported(0, torch.float32) is not None
    assert "float32" in kernels.gram_unsupported(128, torch.float64)


def test_shape_and_device_checks():
    with pytest.raises(ValueError):
        kernels.gram_partials(torch.zeros(10), 10)
    with pytest.raises(ValueError):
        kernels.gram_partials(torch.zeros(10, 4), 11)
    with pytest.raises(ValueError):
        kernels.gram_partials(torch.zeros(10, 4, device="meta"), 10)


@pytest.mark.parametrize(
    "n,dtype,through_kernel",
    [(64, torch.float32, True), (512, torch.float32, True), (513, torch.float32, False), (64, torch.float64, False)],
)
def test_hsvd_gram_takes_the_kernel_where_the_gate_admits(n, dtype, through_kernel, monkeypatch):
    calls = []
    real = kernels.gram_partials

    def counting(x, n_true):
        calls.append((tuple(x.shape), n_true))
        return real(x, n_true)

    monkeypatch.setattr(kernels, "gram_partials", counting)
    rng = np.random.default_rng(n)
    x = torch.from_numpy(rng.standard_normal((700, n))).to(dtype)
    g = svdtools._gram(x, 650)
    assert calls == ([((700, n), 650)] if through_kernel else [])
    assert g.dtype == dtype
    truth = x[:650].double().T @ x[:650].double()
    assert _rel(g.numpy(), truth.numpy()) <= (5e-5 if dtype == torch.float32 else 1e-12)


# ----------------------------------------------------------------------
# the precision of csrc/syrk.cu: 3xTF32 on the tensor cores, emulated with
# integer operations on the f32 bits (core/_tf32x3.py)
# ----------------------------------------------------------------------
def _gram_emulated(x, mm, runs=4):
    """K2's arithmetic on a float32 (rows, n) tensor: the rows cut into
    ``runs`` runs; in each, one chain from zero per stage of 64 rows, added
    in float32, the float32 sums added into float64 every 4 stages (256
    rows); the runs' partials added in order in float64, the upper triangle
    mirrored.  The products are ``mm`` (3xTF32, or one TF32 pass)."""
    rows, n = x.shape
    per = -(-rows // (64 * runs)) * 64
    g = torch.zeros((n, n), dtype=torch.float64)
    for r0 in range(0, rows, per):
        xr = x[r0 : r0 + per]
        pad = (-xr.shape[0]) % 64
        xr = torch.cat([xr, torch.zeros((pad, n))]) if pad else xr
        stages = xr.reshape(-1, 64, n)
        chains = mm(stages.transpose(1, 2), stages)  # (stages, n, n), each from zero
        dacc = torch.zeros((n, n), dtype=torch.float64)
        for f0 in range(0, chains.shape[0], 4):
            facc = torch.zeros((n, n))
            for c in chains[f0 : f0 + 4]:
                facc = facc + c
            dacc += facc.double()
        g += dacc
    up = torch.triu(g)
    return (up + torch.triu(g, 1).T).float()


def test_3xtf32_gram_of_offset_data_holds_f32_accuracy():
    """K2's stages and flushes at 2^16 x 128 on data of mean 10 (uncentred,
    as hsvd_rank receives it) with every product in 3xTF32: within 5e-6
    (Frobenius) of float64 and of the reference's gram_syrk (interpreted),
    exactly symmetric.  On the same data centred (PCA's input) 3xTF32 stays
    within 5e-6 where one TF32 pass misses it (about 1.3e-5; on the offset
    data the mean's large, exact part hides it)."""
    from heat_tpu_torch.core._tf32x3 import tf32_mm, tf32x3_mm

    rng = np.random.default_rng(29)
    x = (rng.standard_normal((1 << 16, 128)) + 10.0).astype(np.float32)
    truth = x.astype(np.float64).T @ x.astype(np.float64)
    got = _gram_emulated(torch.from_numpy(x), tf32x3_mm)
    assert torch.equal(got, got.T)
    assert _rel(got.numpy(), truth) <= 5e-6
    want = np.asarray(ref_kernels.gram_syrk(jnp.asarray(x)))
    assert _rel(got.numpy(), want) <= 5e-6
    xc = x - x.mean(0)
    centred = xc.astype(np.float64).T @ xc.astype(np.float64)
    assert _rel(_gram_emulated(torch.from_numpy(xc), tf32x3_mm).numpy(), centred) <= 5e-6
    assert _rel(_gram_emulated(torch.from_numpy(xc), tf32_mm).numpy(), centred) > 5e-6
