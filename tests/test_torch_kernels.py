"""The port's fused Lloyd step (heat_tpu_torch.core.kernels) against the JAX
package's: the Pallas kernel run through its interpreter
(``heat_tpu.core.kernels._lloyd_single``, as tests/test_kernels.py runs it)
and the XLA step ``heat_tpu.cluster.kmeans._lloyd_step``.  On the CPU the
port's wrapper runs its plain PyTorch version, which is what is held here;
tests/test_torch_gpu.py holds the CUDA kernel against it on the card.

Tolerances are those of tests/test_kernels.py: centres atol 5e-5, inertia
rtol 1e-4; labels are compared bitwise."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import heat_tpu as hj
import heat_tpu_torch as ht
from heat_tpu.cluster.kmeans import _lloyd_step as ref_lloyd_step
from heat_tpu.core import kernels as ref_kernels
from heat_tpu_torch.core import kernels


@pytest.fixture(autouse=True)
def _port_on_cpu():
    ht.use_device("cpu")


def _case(n, f, k, seed=0, pad_value=0.0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, f)).astype(np.float32)
    c = rng.standard_normal((k, f)).astype(np.float32)
    npad = -(-n // 32) * 32
    xp = np.full((npad, f), pad_value, np.float32)
    xp[:n] = x
    return xp, c


@pytest.mark.parametrize(
    "n,f,k",
    [(1003, 16, 8), (517, 8, 5), (130, 4, 7), (999, 16, 12), (96, 128, 8), (64, 64, 2)],
)
def test_plain_matches_pallas_interpret(n, f, k):
    xp, c = _case(n, f, k)
    want_c, _, want_i = ref_kernels._lloyd_single(jnp.asarray(xp), jnp.asarray(c), n)
    got_c, shift, got_i = kernels._lloyd_single(torch.from_numpy(xp), torch.from_numpy(c), n)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), atol=5e-5)
    np.testing.assert_allclose(float(got_i), float(want_i), rtol=1e-4)
    want_shift = float(np.sum((np.asarray(want_c, np.float32) - c) ** 2))
    np.testing.assert_allclose(float(shift), want_shift, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize(
    "n,f,k,n_true,pad_value",
    [
        (1003, 16, 8, 1003, 0.0),
        (517, 8, 5, 517, 0.0),
        (1003, 16, 8, 901, 1e6),  # padding past n_true, poisoned
        (1003, 17, 30, 1003, 0.0),  # the TPU gate refuses f=17, k=30
        (640, 17, 30, 600, -3e5),
    ],
)
def test_labels_bitwise_against_xla_step(n, f, k, n_true, pad_value):
    rng = np.random.default_rng(n + f + k)
    xp = rng.standard_normal((n, f)).astype(np.float32)
    xp[n_true:] = pad_value
    c = rng.standard_normal((k, f)).astype(np.float32)
    labels, new, _, inertia = ref_lloyd_step(jnp.asarray(xp), jnp.asarray(c), n_true, k)
    got_c, _, got_i, got_l = kernels._lloyd_single(torch.from_numpy(xp), torch.from_numpy(c), n_true, labels=True)
    np.testing.assert_array_equal(got_l.numpy()[:n_true], np.asarray(labels)[:n_true])
    assert got_l.dtype == torch.int64 and got_l.shape == (n,)
    np.testing.assert_allclose(float(got_i), float(inertia), rtol=1e-4)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(new), atol=5e-5)


def test_partials_count_only_valid_rows():
    xp, c = _case(200, 16, 4, seed=3, pad_value=1e6)
    sums, counts, inertia, lab = kernels.lloyd_partials(torch.from_numpy(xp), torch.from_numpy(c), 150)
    assert lab is None
    assert sums.dtype == counts.dtype == inertia.dtype == torch.float64
    assert float(counts.sum()) == 150.0
    assert float(sums.abs().max()) < 1e3  # no poisoned row was summed


def test_empty_cluster_keeps_center():
    x = np.zeros((64, 16), np.float32)
    c = np.stack([np.zeros(16), np.full(16, 100.0)]).astype(np.float32)
    new, shift, _ = kernels._lloyd_single(torch.from_numpy(x), torch.from_numpy(c), 64)
    np.testing.assert_array_equal(new.numpy()[1], c[1])
    np.testing.assert_array_equal(new.numpy()[0], np.zeros(16, np.float32))
    assert float(shift) == 0.0


def test_cpu_call_leaves_launch_count():
    before = kernels.LLOYD_LAUNCHES
    xp, c = _case(300, 16, 8)
    kernels._lloyd_single(torch.from_numpy(xp), torch.from_numpy(c), 300, labels=True)
    assert kernels.LLOYD_LAUNCHES == before


def test_lloyd_update_on_dndarray_matches_sharded_reference():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((1003, 16)).astype(np.float32)
    c = rng.standard_normal((8, 16)).astype(np.float32)
    want_c, _, want_i = ref_kernels.lloyd_update(hj.array(x, split=0), jnp.asarray(c))
    got_c, _, got_i, lab = kernels.lloyd_update(ht.array(x, split=0), torch.from_numpy(c), labels=True)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), atol=5e-5)
    np.testing.assert_allclose(float(got_i), float(want_i), rtol=1e-4)
    assert lab.shape == (1003,)


def test_kernel_gate():
    assert kernels.lloyd_unsupported(16, 8) is None
    assert kernels.lloyd_unsupported(17, 30) is None
    assert kernels.lloyd_unsupported(128, 40) is None
    assert "128 features" in kernels.lloyd_unsupported(129, 8)
    assert "shared memory" in kernels.lloyd_unsupported(128, 400)
    assert kernels.lloyd_unsupported(0, 8) is not None
    assert kernels.lloyd_smem_bytes(16, 8, "walk") < 48 * 1024
    assert kernels.lloyd_smem_bytes(16, 8) <= 232448  # the tc route, which (16, 8) takes


def test_shape_and_device_checks():
    with pytest.raises(ValueError):
        kernels.lloyd_partials(torch.zeros(10, 4), torch.zeros(3, 5), 10)
    with pytest.raises(ValueError):
        kernels.lloyd_partials(torch.zeros(10, 4), torch.zeros(3, 4, device="meta"), 10)
    with pytest.raises(NotImplementedError):
        kernels.lloyd_update(ht.zeros((4, 6), split=1), torch.zeros(2, 4))
