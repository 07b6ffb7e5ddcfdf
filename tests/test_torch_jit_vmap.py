"""``ht.jit`` (heat_tpu_torch/core/fusion.py) and ``ht.vmap``
(heat_tpu_torch/core/vmap.py) against the JAX package's: vmap's width
cases of tests/test_signal_vmap_width.py through both packages, jit's
results on split 0 and None, its refusals, its per-wrapper cache growing
as the reference's trace cache does, and the reference's contract that an
argument (or a view of one) updated in place inside the function leaves
the caller's array as it was, and that a result never aliases an
argument."""

import jax
import numpy as np
import pytest

import heat_tpu as hj
import heat_tpu_torch as ht
from heat_tpu_torch.core import dispatch


@pytest.fixture(autouse=True)
def _on_cpu():
    ht.use_device("cpu")


BOTH = pytest.mark.parametrize("pkg", [hj, ht], ids=["reference", "port"])


# ----------------------------------------------------------------------
# vmap: tests/test_signal_vmap_width.py::TestVmapWidth, in both packages
# ----------------------------------------------------------------------
def _vmap_case(pkg, case):
    m24 = np.arange(24, dtype=np.float32).reshape(4, 6)
    m12 = np.arange(12, dtype=np.float32).reshape(3, 4)
    w = np.array([0.5, 1.0, -1.0], np.float32)
    if case == "split_rows":
        return pkg.vmap(lambda r: r.sum())(pkg.array(m24, split=0)), m24.sum(axis=1)
    if case == "split_cols":
        return pkg.vmap(lambda c: c.max())(pkg.array(m24, split=1)), m24.max(axis=0)
    if case == "two_args":
        scale = 2.0
        f = pkg.vmap(lambda row, s: row * s * scale)
        return f(pkg.array(m12, split=0), pkg.array(w, split=0)), m12 * w[:, None] * scale
    if case == "out_dims":
        return pkg.vmap(lambda r: r + 1.0, out_dims=1)(pkg.array(m12, split=0)), (m12 + 1.0).T
    raise AssertionError(case)


@pytest.mark.parametrize("case", ["split_rows", "split_cols", "two_args", "out_dims"])
def test_vmap_width_cases_match_the_reference(case):
    got, truth = _vmap_case(ht, case)
    want, _ = _vmap_case(hj, case)
    np.testing.assert_allclose(got.numpy(), truth, rtol=1e-6)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6)
    assert got.shape == want.shape and got.split == want.split


@BOTH
def test_vmap_refuses_non_dndarray_only_args_and_non_callables(pkg):
    f = pkg.vmap(lambda x: x + 1)
    with pytest.raises(TypeError):
        f(3.0)
    with pytest.raises(TypeError):
        pkg.vmap(3)


def test_vmap_of_a_tuple_result_wraps_each_output():
    m = np.arange(12, dtype=np.float32).reshape(3, 4)
    for pkg in (hj, ht):
        lo, hi = pkg.vmap(lambda r: (r.min(), r.max()), out_dims=(0, 0))(pkg.array(m, split=0))
        np.testing.assert_array_equal(lo.numpy(), m.min(1))
        np.testing.assert_array_equal(hi.numpy(), m.max(1))


# ----------------------------------------------------------------------
# jit
# ----------------------------------------------------------------------
def _pipeline(pkg):
    def pipeline(a, b, scale):
        y = pkg.tanh(a @ b) * scale
        return y - pkg.mean(y, axis=0), pkg.sum(y)

    return pipeline


@pytest.mark.parametrize("split", [None, 0])
def test_jit_matches_the_reference_and_the_eager_run(split):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((13, 7))
    w = rng.standard_normal((7, 4))
    got, tot = ht.jit(_pipeline(ht))(ht.array(x, split=split), ht.array(w), 2.0)
    eager, etot = _pipeline(ht)(ht.array(x, split=split), ht.array(w), 2.0)
    want, wtot = hj.jit(_pipeline(hj))(hj.array(x, split=split), hj.array(w), 2.0)
    np.testing.assert_array_equal(got.numpy(), eager.numpy())  # eager inside: the same ops
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(float(tot), float(wtot), rtol=1e-10)
    assert got.split == want.split and float(tot) == float(etot)


def _cache_of(wrapper):
    """The per-wrapper cache dict (the ``cache`` cell of the wrapper's
    closure, in both packages)."""
    cells = dict(zip(wrapper.__code__.co_freevars, (c.cell_contents for c in wrapper.__closure__)))
    return cells["cache"]


@BOTH
def test_jit_cache_grows_per_key(pkg):
    calls = []

    @pkg.jit
    def f(a, k):
        calls.append(1)
        return a * k

    a = pkg.arange(10, dtype=pkg.float32, split=0)
    cache = _cache_of(f)
    f(a, 2.0)
    f(a, 2.0)
    assert len(cache) == 1
    f(a, 3.0)  # a new static value: a new key
    assert len(cache) == 2
    f(pkg.arange(20, dtype=pkg.float32, split=0), 3.0)  # a new shape
    assert len(cache) == 3
    f(pkg.arange(10, dtype=pkg.float32), 3.0)  # a new split
    assert len(cache) == 4
    # the reference traces once per key; the port runs eagerly on every call
    assert len(calls) == (4 if pkg is hj else 5)


def test_jit_counts_one_external_dispatch_per_call():
    f = ht.jit(lambda a: ht.sum(a * 2.0))
    a = ht.arange(6, dtype=ht.float32, split=0)
    dispatch.reset_stats()
    for _ in range(3):
        f(a)
    assert dispatch.cache_stats()["external_dispatches"] == 3


@BOTH
def test_jit_refuses_argument_indexed_options(pkg):
    for opt in ("static_argnums", "static_argnames", "donate_argnums", "donate_argnames",
                "in_shardings", "out_shardings"):
        with pytest.raises(TypeError, match="argument-indexed"):
            pkg.jit(lambda a: a, **{opt: 0})


@BOTH
def test_jit_refuses_an_unhashable_static(pkg):
    @pkg.jit
    def f(a, opts):
        return a

    with pytest.raises(TypeError, match="hashable statics"):
        f(pkg.arange(4), np.zeros(3))


@BOTH
def test_jit_takes_container_statics(pkg):
    @pkg.jit
    def f(a, opts):
        return a * opts["scale"] + opts["bias"][0]

    got = f(pkg.arange(5, dtype=pkg.float32, split=0), {"scale": 2.0, "bias": (1.0,)})
    np.testing.assert_allclose(got.numpy(), np.arange(5) * 2.0 + 1.0)


@BOTH
@pytest.mark.parametrize("split", [None, 0])
def test_jit_leaves_the_callers_array_unmodified_by_an_augmented_assignment(pkg, split):
    @pkg.jit
    def bump(a):
        a += 1
        return a

    x = pkg.array(np.arange(6, dtype=np.float32), split=split)
    np.testing.assert_array_equal(bump(x).numpy(), np.arange(6) + 1.0)
    np.testing.assert_array_equal(x.numpy(), np.arange(6))


@pytest.mark.parametrize("split", [None, 0])
def test_jit_leaves_the_callers_array_unmodified_by_an_item_write(split):
    # the reference's docstring states the same contract for ``a[0] = v``;
    # its trace of that write raises AttributeError ('sharding' of a tracer)
    # under this jax, so the port is held to the stated contract alone
    @ht.jit
    def write(a, v):
        a[0] = v
        a.fill_diagonal(v) if a.ndim == 2 else None
        return a * 1

    x = ht.array(np.arange(6, dtype=np.float32), split=split)
    want = np.arange(6, dtype=np.float32)
    want[0] = 9.0
    np.testing.assert_array_equal(write(x, 9.0).numpy(), want)
    np.testing.assert_array_equal(x.numpy(), np.arange(6))
    m = ht.array(np.zeros((3, 3), np.float32), split=split)
    np.testing.assert_array_equal(write(m, 2.0).numpy(), [[2, 2, 2], [0, 2, 0], [0, 0, 2]])
    np.testing.assert_array_equal(m.numpy(), np.zeros((3, 3)))


def test_jit_of_an_identity_write_does_not_reach_the_argument():
    @ht.jit
    def same(a):
        return a

    x = ht.arange(4, dtype=ht.float32)
    y = same(x)
    y[1] = 7.0  # the returned array is a copy: its write leaves the argument
    np.testing.assert_array_equal(x.numpy(), np.arange(4))
    assert float(y[1]) == 7.0


@pytest.mark.parametrize("split", [None, 0])
def test_jit_leaves_the_callers_array_unmodified_by_a_write_into_a_view(split):
    # reshape and expand_dims hand back arrays around views of the
    # argument's tensor; a[1:] a copy
    @ht.jit
    def write_view(a):
        b = ht.reshape(a, (2, 3))
        b[0, 0] = 9.0
        c = ht.expand_dims(a, 0)
        c.lloc[0, 1] = 8.0
        d = a[1:]
        d[0] = 7.0
        return ht.reshape(b, (6,)) + c.sum() + d.sum()

    x = ht.array(np.arange(6, dtype=np.float32), split=split)
    got = write_view(x)
    np.testing.assert_array_equal(got.numpy(), np.array([9, 1, 2, 3, 4, 5], np.float32) + 22.0 + 21.0)
    np.testing.assert_array_equal(x.numpy(), np.arange(6))


@BOTH
@pytest.mark.parametrize("split", [None, 0])
@pytest.mark.parametrize("body", ["identity", "slice", "reshape"])
def test_a_jit_result_does_not_alias_the_callers_array(pkg, split, body):
    bodies = {"identity": lambda a: a, "slice": lambda a: a[1:], "reshape": lambda a: pkg.reshape(a, (2, 3))}
    fn = pkg.jit(bodies[body])
    x = pkg.array(np.arange(6, dtype=np.float32), split=split)
    y = fn(x)
    want = y.numpy().copy()
    x[2] = 50.0  # a later write into the caller's array leaves the result
    np.testing.assert_array_equal(y.numpy(), want)


def test_a_jit_tensor_result_does_not_alias_the_callers_array():
    fn = ht.jit(lambda a: {"local": (a.larray,), "arr": [a]})
    x = ht.arange(4, dtype=ht.float32)
    out = fn(x)
    x[0] = 5.0
    assert float(out["local"][0][0]) == 0.0 and float(out["arr"][0][0]) == 0.0


def test_a_write_into_a_fresh_array_inside_jit_is_not_copied():
    @ht.jit
    def fresh(a):
        b = a * 2
        before = b.larray_padded.data_ptr()
        b[0] = 1.0
        return b, before == b.larray_padded.data_ptr()

    y, in_place = fresh(ht.arange(3, dtype=ht.float32))
    assert in_place
    np.testing.assert_array_equal(y.numpy(), [1.0, 2.0, 4.0])


def test_nested_jit_calls_keep_the_outer_arguments_protected():
    inner = ht.jit(lambda a: a)

    @ht.jit
    def outer(a, b):
        inner(b)[0] = 3.0
        a[0] = 4.0
        return a

    x, z = ht.arange(3, dtype=ht.float32), ht.arange(3, dtype=ht.float32)
    np.testing.assert_array_equal(outer(x, z).numpy(), [4.0, 1.0, 2.0])
    np.testing.assert_array_equal(x.numpy(), np.arange(3))
    np.testing.assert_array_equal(z.numpy(), np.arange(3))


def test_a_host_read_inside_jit_works_in_the_port_and_not_in_the_reference():
    def f(pkg):
        return pkg.jit(lambda a: a * float(pkg.sum(a)))

    np.testing.assert_allclose(f(ht)(ht.arange(3, dtype=ht.float32)).numpy(), [0.0, 3.0, 6.0])
    with pytest.raises((jax.errors.ConcretizationTypeError, jax.errors.TracerArrayConversionError)):
        f(hj)(hj.arange(3, dtype=hj.float32))
