"""The port's linalg/basics.py against heat_tpu's: matmul over every pair
of layouts (1-D and 2-D operands, a batch), dot, vdot, vecdot, outer,
cross, trace, projection, transpose with ``axes``, tril and triu (the
diagonal offset by each rank's first row or column), norm, vector_norm and
matrix_norm with ``ord``; det and inv raise, naming the queue item they
wait for.  The result's type and split are the reference's; values within
the reference's bounds (integer results bitwise)."""

import numpy as np
import pytest

import heat_tpu as hj
import heat_tpu_torch as ht
from torch_parity import SPLITS, both, data, same, same_outcome


@pytest.fixture(autouse=True)
def _port_on_cpu():
    ht.use_device("cpu")


@pytest.mark.parametrize("dtype", ["int32", "float32", "float64", "complex64"])
def test_matmul_every_layout_matches_reference(dtype):
    a = data(dtype, shape=(7, 5), seed=1)
    b = data(dtype, shape=(5, 6), seed=2)
    v = data(dtype, shape=(5,), seed=3)
    w = data(dtype, shape=(7,), seed=4)
    for sa in SPLITS:
        for sb in SPLITS:
            pa, ra = both(a, sa)
            pb, rb = both(b, sb)
            same(ht.matmul(pa, pb), hj.matmul(ra, rb))
            same(pa @ pb, ra @ rb)
        for sv in (None, 0):
            pv, rv = both(v, sv)
            same(ht.matmul(pa, pv), hj.matmul(ra, rv))
            pw, rw = both(w, sv)
            same(ht.matmul(pw, pa), hj.matmul(rw, ra))
            pv2, rv2 = both(data(dtype, shape=(5,), seed=5), sv)
            same(ht.matmul(pv, pv2), hj.matmul(rv, rv2))


def test_matmul_mixed_types_and_batches_match_reference():
    a = data("int32", shape=(7, 5), seed=6)
    b = data("float32", shape=(5, 3), seed=7)
    for sa in SPLITS:
        pa, ra = both(a, sa)
        pb, rb = both(b, None)
        same(ht.matmul(pa, pb), hj.matmul(ra, rb))
    batch = data("float64", shape=(3, 4, 5), seed=8)
    rhs = data("float64", shape=(5, 2), seed=9)
    for split in (None, 0, 1, 2):
        p, r = both(batch, split)
        prhs, rrhs = both(rhs, None)
        same(ht.matmul(p, prhs), hj.matmul(r, rrhs))
    with pytest.raises(ValueError):
        ht.matmul(ht.zeros((3, 4)), ht.zeros((5, 2)))



@pytest.mark.parametrize("dtype", ["int8", "int32", "int64"])
def test_integer_products_in_blocks_match_matmul(dtype, monkeypatch):
    """The card's integer product (``basics._int_mm``, called here on CPU
    tensors) with a budget of a few elements, so that rows and the inner
    axis both come in blocks: equal to torch's product, batches broadcast
    and an empty inner axis included; int8 wraps as torch's does."""
    import torch

    from heat_tpu_torch.core.linalg import basics

    monkeypatch.setattr(basics, "_INT_MM_BUDGET", 24)
    rng = np.random.default_rng(21)
    tt = getattr(torch, dtype)
    for sa, sb in (((7, 5), (5, 6)), ((3, 7, 5), (5, 2)), ((1, 4, 9), (3, 9, 5)), ((4, 0), (0, 3))):
        a = torch.from_numpy(rng.integers(-100, 100, sa)).to(tt)
        b = torch.from_numpy(rng.integers(-100, 100, sb)).to(tt)
        assert torch.equal(basics._int_mm(a, b), torch.matmul(a, b))

def test_dot_vdot_vecdot_match_reference():
    for dtype in ("float32", "float64", "complex64", "int64"):
        x = data(dtype, shape=(9,), seed=10)
        y = data(dtype, shape=(9,), seed=11)
        m = data(dtype, shape=(4, 9), seed=12)
        n = data(dtype, shape=(4, 9), seed=13)
        for s1 in (None, 0):
            for s2 in (None, 0):
                px, rx = both(x, s1)
                py, ry = both(y, s2)
                same(ht.dot(px, py), hj.dot(rx, ry))
                same(ht.vdot(px, py), hj.vdot(rx, ry))
        for split in SPLITS:
            pm, rm = both(m, split)
            pn, rn = both(n, split)
            same(ht.vdot(pm, pn), hj.vdot(rm, rn))
            same(ht.vecdot(pm, pn), hj.vecdot(rm, rn))
            same(ht.vecdot(pm, pn, axis=0), hj.vecdot(rm, rn, axis=0))
            same(ht.vecdot(pm, pn, keepdims=True), hj.vecdot(rm, rn, keepdims=True))
            pt, rt = both(data(dtype, shape=(9, 3), seed=14), None)
            same(ht.dot(pm, pt), hj.dot(rm, rt))
    po, ro = both(np.zeros((4, 3), np.float64), None)
    pm, rm = both(data("float64", shape=(4, 9), seed=15), 0)
    pt, rt = both(data("float64", shape=(9, 3), seed=16), None)
    assert ht.dot(pm, pt, out=po) is po
    # the reference writes its padded row chunks into an unsplit out; the
    # values are its dot's
    np.testing.assert_allclose(po.numpy(), hj.dot(rm, rt).numpy(), rtol=1e-12)


def test_outer_cross_projection_match_reference():
    for dtype in ("int32", "float32", "float64"):
        a = data(dtype, shape=(7,), seed=17)
        b = data(dtype, shape=(5,), seed=18)
        for sa in (None, 0):
            for sb in (None, 0):
                pa, ra = both(a, sa)
                pb, rb = both(b, sb)
                same(ht.outer(pa, pb), hj.outer(ra, rb))
                same(ht.outer(pa, pb, split=1), hj.outer(ra, rb, split=1))
        u = data(dtype, shape=(6, 3), seed=19)
        v = data(dtype, shape=(6, 3), seed=20)
        for split in (None, 0, 1):
            pu, ru = both(u, split)
            pv, rv = both(v, split)
            same(ht.cross(pu, pv), hj.cross(ru, rv))
        same(ht.cross(*both(u.T.copy(), 1)[:1], both(v.T.copy(), 1)[0], axisa=0, axisb=0, axisc=0),
             hj.cross(both(u.T.copy(), 1)[1], both(v.T.copy(), 1)[1], axisa=0, axisb=0, axisc=0))
    x = data("float64", shape=(8,), seed=21)
    y = data("float64", shape=(8,), seed=22)
    for split in (None, 0):
        px, rx = both(x, split)
        py, ry = both(y, split)
        same(ht.projection(px, py), hj.projection(rx, ry))
    with pytest.raises(RuntimeError):
        ht.projection(ht.zeros((2, 2)), ht.zeros(2))


def test_trace_matches_reference():
    for dtype in ("bool", "int32", "float32", "float64"):
        a = data(dtype, shape=(7, 5), seed=23)
        for split in SPLITS:
            p, r = both(a, split)
            for offset in (-3, -1, 0, 2, 6):
                got, want = ht.trace(p, offset), hj.trace(r, offset)
                assert type(got) is type(want)
                np.testing.assert_allclose(got, want, rtol=1e-6)
            got, want = ht.trace(p, dtype=ht.float64), hj.trace(r, dtype=hj.float64)
            assert type(got) is type(want)
            np.testing.assert_allclose(got, want, rtol=3e-5 if dtype == "float32" else 1e-12)  # summed in float32
    c = data("float64", shape=(3, 4, 5), seed=24)
    for split in (None, 0, 1, 2):
        p, r = both(c, split)
        same(ht.trace(p, 1, axis1=1, axis2=2), hj.trace(r, 1, axis1=1, axis2=2))
        same(ht.trace(p, 0, axis1=0, axis2=2), hj.trace(r, 0, axis1=0, axis2=2))


def test_transpose_matches_reference():
    c = data("float32", shape=(3, 4, 5), seed=25)
    for split in (None, 0, 1, 2):
        p, r = both(c, split)
        for axes in (None, (1, 0, 2), (2, 0, 1), (-1, -3, -2)):
            same(ht.transpose(p, axes), hj.transpose(r, axes))
        same(p.transpose((0, 2, 1)), r.transpose((0, 2, 1)))
        with pytest.raises(ValueError):
            ht.transpose(p, (0, 0, 1))
    for split in (None, 0):
        p, r = both(data("int32", shape=(6,), seed=26), split)
        same(ht.transpose(p), hj.transpose(r))


@pytest.mark.parametrize("name", ["tril", "triu"])
def test_triangles_match_reference(name):
    for shape in ((7, 5), (5, 7), (2, 6, 6)):
        for dtype in ("bool", "int32", "float32"):
            a = data(dtype, shape=shape, seed=27)
            for split in range(-1, len(shape)):
                split = None if split < 0 else split
                p, r = both(a, split)
                for k in (-8, -2, 0, 1, 3, 9):
                    same(getattr(ht, name)(p, k), getattr(hj, name)(r, k))
                same(getattr(p, name)(), getattr(r, name)())
    for split in (None, 0):
        p, r = both(data("float32", shape=(6,), seed=28), split)
        same(getattr(ht, name)(p, 1), getattr(hj, name)(r, 1))


@pytest.mark.parametrize("dtype", ["int32", "float32", "float64", "complex64"])
def test_norms_match_reference(dtype):
    a = data(dtype, shape=(7, 5), seed=29)
    for split in SPLITS:
        p, r = both(a, split)
        same(ht.norm(p), hj.norm(r))
        same(ht.norm(p, keepdims=True), hj.norm(r, keepdims=True))
        for axis in (0, 1):
            for ord in (None, 1, 0, 3, np.inf, -np.inf):
                same_outcome(lambda m, x: m.norm(x, axis=axis, ord=ord), (p,), (r,))
            same_outcome(lambda m, x: m.vector_norm(x, axis=axis, ord=2), (p,), (r,))
        for ord in (None, "fro", 1, -1, np.inf, -np.inf, 2, -2, "nuc"):
            same_outcome(lambda m, x: m.norm(x, ord=ord), (p,), (r,))
        for ord in ("fro", 1, -np.inf, 2):
            same_outcome(lambda m, x: m.matrix_norm(x, ord=ord), (p,), (r,))
            same_outcome(lambda m, x: m.matrix_norm(x, axis=(1, 0), ord=ord, keepdims=True), (p,), (r,))
        same(ht.vector_norm(p), hj.vector_norm(r))
        same(ht.vector_norm(p, keepdims=True), hj.vector_norm(r, keepdims=True))
        same(ht.vector_norm(p, axis=1, keepdims=True), hj.vector_norm(r, axis=1, keepdims=True))


def test_det_and_inv_wait_for_the_lu():
    # the LU has landed: det and inv compute under both names, as the reference's
    a = np.eye(3) * 2.0
    p, r = ht.array(a, split=0), hj.array(a, split=0)
    for det in (ht.linalg.det, ht.det):
        same(det(p), hj.linalg.det(r))
    for inv in (ht.linalg.inv, ht.inv):
        same(inv(p), hj.linalg.inv(r))
        np.testing.assert_array_equal(inv(p).numpy(), np.eye(3) / 2.0)
