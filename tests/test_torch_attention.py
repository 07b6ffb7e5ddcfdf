"""The port's ht.nn.scaled_dot_product_attention against heat_tpu's on the
same numpy inputs, for every method on split=0 and split=None, and against
float64 numpy.

The port runs at world size 1 here (the gloo world of 3 in
tests/test_torch_gloo.py covers the exchange); the reference runs on its
test mesh.  Its "flash" method takes the einsum path off a TPU, the port's
the plain version of the flash kernel.  Tolerances: 1e-5 between the two
packages (both exact float32 attention), and the reference test's own 2e-4
against float64 numpy (tests/test_attention.py)."""

import numpy as np
import pytest
import torch

import heat_tpu as hj
import heat_tpu_torch as ht
from heat_tpu_torch import interop
from heat_tpu_torch.nn import _flash

H, D = 24, 4  # 24 heads divide every test mesh's size (1, 2, 3, 4, 6, 8)
METHODS = ["ring", "ulysses", "alltoall", "flash"]


@pytest.fixture(autouse=True)
def _port_on_cpu():
    ht.use_device("cpu")


def _dense_attention(q, k, v, causal=False):
    q, k, v = (x.astype(np.float64) for x in (q, k, v))
    seq, h, d = q.shape
    scores = np.einsum("qhd,khd->hqk", q, k) / np.sqrt(d)
    if causal:
        pos = np.arange(seq)
        scores = np.where(pos[None, None, :] <= pos[None, :, None], scores, -np.inf)
    scores -= scores.max(axis=-1, keepdims=True)
    w = np.exp(scores)
    w /= w.sum(axis=-1, keepdims=True)
    return np.einsum("hqk,khd->qhd", w, v)


def _qkv(seq, h=H, d=D, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((seq, h, d)).astype(np.float32) for _ in range(3))


@pytest.mark.parametrize("seq", [16, 13])  # 13: padded tail blocks on the reference's mesh
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("split", [0, None])
@pytest.mark.parametrize("method", METHODS)
def test_matches_the_reference(method, split, causal, seq):
    qkv = _qkv(seq, seed=seq)
    want = hj.nn.scaled_dot_product_attention(*(hj.array(x, split=split) for x in qkv), causal=causal, method=method)
    before = _flash.FLASH_LAUNCHES
    got = ht.nn.scaled_dot_product_attention(
        *(interop.from_reference_array(x, split=split) for x in qkv), causal=causal, method=method
    )
    assert _flash.FLASH_LAUNCHES == before  # the CPU takes the plain version
    assert got.split == split and got.shape == (seq, H, D) and got.dtype == ht.float32
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.numpy(), _dense_attention(*qkv, causal), rtol=2e-4, atol=2e-4)


def test_scale_is_passed_through():
    qkv = _qkv(10, h=3, d=5, seed=1)
    want = hj.nn.scaled_dot_product_attention(*(hj.array(x) for x in qkv), causal=True, scale=0.3)
    for method in METHODS:
        got = ht.nn.scaled_dot_product_attention(*(ht.array(x, split=0) for x in qkv), causal=True, scale=0.3,
                                                 method=method if method != "ulysses" else "alltoall")
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=0, err_msg=method)


def test_ring_attention_on_raw_padded_chunks():
    # one rank's padded chunk is the whole padded sequence here: 2048 true
    # rows and 5 rows of junk padding that n_true must mask
    q, k, v = _qkv(2048, h=2, d=8, seed=2)
    junk = np.full((5, 2, 8), 1e3, np.float32)
    padded = [torch.from_numpy(np.concatenate([x, junk])) for x in (q, k, v)]
    got = ht.nn.ring_attention(*padded, n_true=2048)
    assert got.shape == (2053, 2, 8)
    want = hj.nn.ring_attention(*(hj.array(x, split=0).larray_padded for x in (q, k, v)), n_true=2048)
    np.testing.assert_allclose(got.numpy()[:2048], np.asarray(want)[:2048], atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.numpy()[:2048], _dense_attention(q, k, v), rtol=2e-4, atol=2e-4)
    causal = ht.nn.ulysses_attention(*padded, causal=True, n_true=2048, use_flash=True)
    np.testing.assert_allclose(causal.numpy()[:2048], _dense_attention(q, k, v, True), rtol=2e-4, atol=2e-4)


def test_functional_and_layers_fall_through_to_torch():
    assert ht.nn.functional.relu is torch.nn.functional.relu
    assert ht.nn.Linear is torch.nn.Linear
    with pytest.raises(AttributeError):
        ht.nn.NoSuchLayer
    with pytest.raises(AttributeError):
        ht.nn.functional.no_such_function


class TestValidation:
    """Every error the reference raises (tests/test_attention.py), with its message."""

    def _port(self, *arrays, split=0):
        return [ht.array(x, split=split) for x in arrays]

    def test_rejects_mismatched_split(self):
        q, k, v = _qkv(16)
        with pytest.raises(ValueError, match="must share a split"):
            ht.nn.scaled_dot_product_attention(ht.array(q, split=0), ht.array(k), ht.array(v))

    def test_rejects_bad_method(self):
        with pytest.raises(ValueError, match='method must be "ring", "ulysses", "alltoall" or "flash"'):
            ht.nn.scaled_dot_product_attention(*self._port(*_qkv(16)), method="blocked")

    def test_rejects_wrong_rank(self):
        q, k, v = _qkv(16)
        with pytest.raises(ValueError, match=r"must be \(seq, heads, head_dim\), got 2-D"):
            ht.nn.scaled_dot_product_attention(*self._port(q[:, 0], k[:, 0], v[:, 0]))

    def test_rejects_non_dndarrays(self):
        q, k, v = _qkv(16)
        with pytest.raises(TypeError, match="q must be a DNDarray"):
            ht.nn.scaled_dot_product_attention(torch.from_numpy(q), *self._port(k, v))

    def test_rejects_unequal_shapes(self):
        q, k, v = _qkv(16)
        with pytest.raises(ValueError, match="identical shapes"):
            ht.nn.scaled_dot_product_attention(*self._port(q, k, v[:15]))

    def test_rejects_split_along_heads(self):
        with pytest.raises(ValueError, match="sequence-parallel over split=0, got split=1"):
            ht.nn.scaled_dot_product_attention(*self._port(*_qkv(16), split=1))

    def test_flash_method_matches_the_local_path(self):
        q, k, v = _qkv(16)
        a = ht.nn.scaled_dot_product_attention(*self._port(q, k, v), method="flash", causal=True)
        b = ht.nn.scaled_dot_product_attention(*self._port(q, k, v, split=None), causal=True)
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)
