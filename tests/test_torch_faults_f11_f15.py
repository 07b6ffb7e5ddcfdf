"""The port's repairs of faults F11-F15 (ROADMAP queue 3), each held
against heat_tpu on the same seeded numpy inputs.

* F11: the DNDarray's metadata (``nbytes``, ``strides``, ``lloc`` ...) and
  the top-level names of sanitation, stride_tricks and the comm layer.
* F12: ``outer`` of N-D operands, ``cov`` of m and y split otherwise along
  their observations.
* F13: result types and integer values: ``vecdot`` in the promoted type,
  ``skew`` widened to float64 (complex128) by its numpy correction,
  ``kurtosis`` of complex, integer ``pow`` with negative exponents (JAX's
  binary exponentiation over the exponent's six lowest bits, bitwise).
* F14: complex operands ordered lexicographically, complex ``rint``,
  ``deg2rad``, ``arctan2``, bool shifts, and the reference's exception
  types for the complex refusals.
* F15: the gates choose the route: ``kernels.lloyd_route`` answers
  ``"plain"`` where the Lloyd kernel refuses a shape, and the flash gate
  sends a refused card shape to the einsum path (the card tests run both).

Integer and bool results compare bitwise; float results within the
reference's float32 bounds (rtol 3e-5, atol 1e-6), which ``skew`` keeps
although its result is float64: its moments are float32 in both packages,
only the correction is float64."""

import types as pytypes

import jax
import numpy as np
import pytest
import torch

import heat_tpu as hj
import heat_tpu_torch as ht
from heat_tpu_torch.core import kernels
from heat_tpu_torch.nn import attention as port_attention
from torch_parity import both, data, same, same_outcome


@pytest.fixture(autouse=True)
def _port_on_cpu():
    ht.use_device("cpu")


@pytest.fixture
def one_device():
    """The reference on a one-device Communication (the port's world of one):
    its complex reductions across devices are not implemented by XLA's CPU."""
    saved = hj.get_comm()
    hj.use_comm(hj.Communication(jax.devices()[:1]))
    try:
        yield
    finally:
        hj.use_comm(saved)


# ----------------------------------------------------------------------
# F11
# ----------------------------------------------------------------------
@pytest.mark.parametrize("dtype,split", [("float32", 0), ("int8", 1), ("complex64", None), ("uint16", 0)])
def test_f11_metadata_matches_the_reference(dtype, split):
    a = np.arange(20).reshape(5, 4).astype(dtype)
    p, r = ht.array(a, split=split), hj.array(a, split=split)
    for name in ("gnumel", "gnbytes", "nbytes", "itemsize", "stride", "strides"):
        assert getattr(p, name) == getattr(r, name), name
    assert p.lnumel == int(np.prod(p.lshape)) and p.lnbytes == p.lnumel * p.itemsize
    np.testing.assert_array_equal(np.array(list(p.flat)), np.array(list(r.flat)))
    assert p.cpu() is p
    if dtype == "float32":
        assert p.nbytes == 80 and p.strides == (16, 4)


def test_f11_lloc_reads_and_writes_the_local_chunk():
    a = np.arange(20, dtype=np.float32).reshape(5, 4)
    p = ht.array(a, split=0)
    assert torch.equal(p.lloc[1:3, 2], torch.from_numpy(a[1:3, 2]))
    p.lloc[0, 0] = 7.5
    assert p.numpy()[0, 0] == 7.5 and p.lloc[0, 0].item() == 7.5


def test_f11_top_level_names():
    for name in hj.core.sanitation.__all__:
        assert callable(getattr(ht, name)), name
    assert ht.broadcast_shapes((5, 1), (1, 4), (4,)) == hj.broadcast_shapes((5, 1), (1, 4), (4,))
    with pytest.raises(ValueError):
        ht.broadcast_shapes((2,), (3,))
    assert ht.sanitize_slice(slice(None, -1, 2), 7) == hj.sanitize_slice(slice(None, -1, 2), 7)
    assert ht.SELF.size == 1 and ht.SELF.rank == 0
    x = ht.array(np.arange(6.0), split=0, comm=ht.SELF)
    assert x.lshape == (6,)
    p, r = ht.array(np.ones((3, 2)), split=1), hj.array(np.ones((3, 2)), split=1)
    assert ht.sanitize_distribution(p, target=ht.zeros((3, 2), split=0)).split == \
        hj.sanitize_distribution(r, target=hj.zeros((3, 2), split=0)).split


# ----------------------------------------------------------------------
# F12
# ----------------------------------------------------------------------
@pytest.mark.parametrize("sa,sb", [(0, None), (None, 1), (1, 0), (None, None)])
def test_f12_outer_of_nd_operands(sa, sb):
    a, b = data("float32"), data("float32", shape=(2, 4), seed=1)
    same_outcome(lambda m, x, y: m.outer(x, y), (ht.array(a, split=sa), ht.array(b, split=sb)),
                 (hj.array(a, split=sa), hj.array(b, split=sb)))


@pytest.mark.parametrize("sm,sy", [(None, 1), (0, None), (1, None), (None, 0), (0, 1)])
@pytest.mark.parametrize("rowvar", [True, False])
def test_f12_cov_of_operands_split_otherwise(sm, sy, rowvar):
    m, y = data("float32", shape=(5, 7)), data("float32", shape=(5, 7), seed=2)
    same_outcome(lambda mod, x, z: mod.cov(x, z, rowvar=rowvar), (ht.array(m, split=sm), ht.array(y, split=sy)),
                 (hj.array(m, split=sm), hj.array(y, split=sy)))


# ----------------------------------------------------------------------
# F13
# ----------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["int32", "int8", "uint8", "bool", "int64", "float32"])
def test_f13_vecdot_in_the_promoted_type(dtype):
    a, b = data(dtype), data(dtype, seed=5)
    for split in (None, 0, 1):
        same_outcome(lambda m, x, y: m.vecdot(x, y), (ht.array(a, split=split), ht.array(b, split=split)),
                     (hj.array(a, split=split), hj.array(b, split=split)))


@pytest.mark.parametrize("dtype", ["float32", "int32", "bool", "complex64"])
@pytest.mark.parametrize("axis", [None, 0, 1])
def test_f13_skew_and_kurtosis_types(dtype, axis):
    a = data(dtype, seed=3)
    for split in (None, 0):
        p, r = both(a, split)
        same(ht.skew(p, axis=axis), hj.skew(r, axis=axis), rtol=3e-5, atol=1e-6)
        same(ht.skew(p, axis=axis, unbiased=False), hj.skew(r, axis=axis, unbiased=False))
        same(ht.kurtosis(p, axis=axis), hj.kurtosis(r, axis=axis), rtol=3e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["int32", "int64", "int8", "uint8"])
def test_f13_integer_power_with_negative_and_large_exponents(dtype):
    if dtype == "uint8":
        base, expo = np.array([2, 3, 5, 0, 1, 255, 7, 9], dtype), np.array([1, 63, 64, 3, 2, 65, 8, 100], "uint8")
    else:
        base = np.array([2, -3, 5, 3, 0, 1, -1, 7], dtype=dtype)
        expo = np.array([-1, -1, -1, -1, -2, -5, -3, 70], dtype="int32")
    for split in (None, 0):
        p, r = both(base, split)
        pe, re = both(expo, split)
        same(ht.pow(p, pe), hj.pow(r, re))
        same(p ** pe, r ** re)
        if dtype != "uint8":
            same(p ** -1, r ** -1)
    p, r = both(np.array([2, -3, 5, 3], np.int32), None)
    np.testing.assert_array_equal((p ** -1).numpy(), [0, -2111105451, 1501274061, 2111105451])


# ----------------------------------------------------------------------
# F14
# ----------------------------------------------------------------------
def test_f14_complex_extrema_in_lexicographic_order(one_device):
    c = data("complex64", seed=3)
    c[1, 0] = c[2, 0].real + 1j * (c[2, 0].imag + 1)  # a tie of real parts
    c2 = data("complex64", seed=4)
    for split in (None, 0, 1):
        p, r = both(c, split)
        p2, r2 = both(c2, split)
        for axis in (None, 0, 1):
            same(ht.max(p, axis=axis), hj.max(r, axis=axis))
            same(ht.min(p, axis=axis), hj.min(r, axis=axis))
        for name in ("maximum", "minimum", "lt", "le", "gt", "ge"):
            same(getattr(ht, name)(p, p2), getattr(hj, name)(r, r2))
            same(getattr(ht, name)(p, p), getattr(hj, name)(r, r))


@pytest.mark.parametrize("name", ["rint", "deg2rad", "rad2deg", "degrees", "radians"])
def test_f14_complex_unary(name):
    c = data("complex64", seed=3) * 3
    for split in (None, 0):
        same_outcome(lambda m, x: getattr(m, name)(x), (ht.array(c, split=split),), (hj.array(c, split=split),))


def test_f14_complex_arctan2():
    y, x = data("complex64", seed=3), data("complex64", seed=4)
    same_outcome(lambda m, a, b: m.arctan2(a, b), both(y, 0)[:1] + both(x, 0)[:1], both(y, 0)[1:] + both(x, 0)[1:])


@pytest.mark.parametrize("name", ["left_shift", "right_shift"])
def test_f14_bool_shifts_give_int32(name):
    a, b = data("bool"), data("bool", seed=1)
    same_outcome(lambda m, x, y: getattr(m, name)(x, y), (ht.array(a, split=0), ht.array(b, split=0)),
                 (hj.array(a, split=0), hj.array(b, split=0)))


UNARY_REFUSALS = ["floor", "ceil", "trunc", "fix", "cbrt", "modf", "frexp", "i0", "signbit", "isposinf",
                  "isneginf", "fabs", "argmin", "argmax"]
BINARY_REFUSALS = ["copysign", "hypot", "fmod", "mod", "floordiv", "heaviside"]


@pytest.mark.parametrize("name", UNARY_REFUSALS + BINARY_REFUSALS + ["clip"])
def test_f14_complex_refusals_raise_the_reference_type(name):
    c, c2 = data("complex64", seed=3), data("complex64", seed=4)
    if name in BINARY_REFUSALS:
        call = lambda m, x, y: getattr(m, name)(x, y)  # noqa: E731
        ops = ((ht.array(c, split=0), ht.array(c2, split=0)), (hj.array(c, split=0), hj.array(c2, split=0)))
    elif name == "clip":
        call = lambda m, x: m.clip(x, 0, 1)  # noqa: E731
        ops = ((ht.array(c, split=0),), (hj.array(c, split=0),))
    else:
        call = lambda m, x: getattr(m, name)(x)  # noqa: E731
        ops = ((ht.array(c, split=0),), (hj.array(c, split=0),))
    with pytest.raises(Exception) as want:
        call(hj, *ops[1])
    assert want.type in (TypeError, ValueError)
    with pytest.raises(want.type):
        call(ht, *ops[0])


# ----------------------------------------------------------------------
# F15
# ----------------------------------------------------------------------
@pytest.mark.parametrize(
    "f,k,dtype,route",
    [(129, 4, torch.float32, "plain"), (200, 8, torch.float32, "plain"), (128, 61, torch.float32, "walk"),
     (128, 62, torch.float32, "plain"), (128, 8, torch.float32, "tc"), (65, 4, torch.float64, "plain"),
     (64, 88, torch.float64, "walk"), (64, 89, torch.float64, "plain"), (16, 8, torch.float16, "plain")],
)
def test_f15_lloyd_route_answers_plain_where_the_kernel_refuses(f, k, dtype, route):
    assert kernels.lloyd_route(f, k, dtype=dtype) == route
    assert (kernels.lloyd_unsupported(f, k, dtype) is not None) == (route == "plain")


def test_f15_kmeans_at_a_refused_width_matches_the_reference():
    """f = 200 (the card's plain route; here the plain version as always)."""
    rng = np.random.default_rng(4)
    centres = rng.standard_normal((4, 200)) * 6.0
    x = (centres[rng.integers(0, 4, 301)] + rng.standard_normal((301, 200))).astype(np.float32)
    init = x[[0, 100, 200, 300]]
    got = ht.cluster.KMeans(n_clusters=4, init=ht.array(init), max_iter=20).fit(ht.array(x, split=0))
    want = hj.cluster.KMeans(n_clusters=4, init=hj.array(init), max_iter=20).fit(hj.array(x, split=0))
    assert got.n_iter_ == want.n_iter_
    np.testing.assert_array_equal(got.labels_.numpy(), want.labels_.numpy())
    np.testing.assert_allclose(got.cluster_centers_.numpy(), want.cluster_centers_.numpy(), atol=5e-5)


def test_f15_flash_gate_chooses_the_route():
    card = lambda s, h, d: pytypes.SimpleNamespace(device=torch.device("cuda"), shape=(s, h, d))  # noqa: E731
    assert port_attention._flash_route(card(64, 2, 64)) == "flash"
    assert port_attention._flash_route(card(64, 2, 512)) == "einsum"
    assert port_attention._flash_route(torch.zeros(64, 2, 512)) == "flash"  # the CPU's plain version takes any d


def test_f15_flash_takes_the_einsum_path_its_gate_chooses(monkeypatch):
    rng = np.random.default_rng(2)
    qkv = [rng.standard_normal((40, 4, 8)).astype(np.float32) for _ in range(3)]
    want = {split: ht.nn.scaled_dot_product_attention(*(ht.array(x, split=split) for x in qkv), causal=True,
                                                      method="ulysses" if split == 0 else "ring")
            for split in (0, None)}
    monkeypatch.setattr(port_attention, "_flash_route", lambda q: "einsum")
    for split in (0, None):
        before = port_attention.EINSUM_ROUTES
        got = ht.nn.scaled_dot_product_attention(*(ht.array(x, split=split) for x in qkv), causal=True,
                                                 method="flash")
        assert port_attention.EINSUM_ROUTES - before == 1
        np.testing.assert_allclose(got.numpy(), want[split].numpy(), rtol=1e-5, atol=1e-6)


def test_f15_flash_casts_float64_to_float32_for_the_kernel():
    rng = np.random.default_rng(3)
    qkv = [rng.standard_normal((48, 2, 16)) for _ in range(3)]
    for split in (None, 0):
        got = ht.nn.scaled_dot_product_attention(*(ht.array(x, split=split) for x in qkv), method="flash")
        f32 = ht.nn.scaled_dot_product_attention(*(ht.array(x.astype(np.float32), split=split) for x in qkv),
                                                 method="flash")
        assert got.dtype == ht.float64
        np.testing.assert_array_equal(got.numpy(), f32.numpy().astype(np.float64))
