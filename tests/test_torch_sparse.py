"""The port's sparse layer (heat_tpu_torch/sparse) against heat_tpu.sparse
on the same seeded inputs, in a world of one rank against the reference on
a one-device Communication (its capacity and per-rank counts depend on the
world's size).

Patterns (``indptr``, ``indices``, ``gnnz``, explicit zeros as the
reference keeps them) and the values of element-wise ops, scalar ops,
``astype``, ``T`` and the format conversions are held bitwise; the
products and sums at rtol 1e-6 in float32 and 1e-10 in float64, the
reference's own bounds (tests/test_sparse_adversarial.py:39-40, :88), and
exactly in int32.  Both SpGEMM routes are forced in both packages through
``HEAT_TPU_SPGEMM_DENSE_DENSITY``.  The world of 3 ranks is in
tests/test_torch_gloo_sparse.py."""

import jax
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import heat_tpu as hj
import heat_tpu_torch as ht
from heat_tpu_torch.interop import from_reference_sparse
from heat_tpu_torch.sparse import _planes

FORMATS = {"csr": (sp.csr_matrix, "sparse_csr_matrix", 0), "csc": (sp.csc_matrix, "sparse_csc_matrix", 1)}
RTOL = {"float32": 1e-6, "float64": 1e-10, "int32": 0.0}


@pytest.fixture(autouse=True)
def _port_on_cpu():
    ht.use_device("cpu")


@pytest.fixture(scope="module")
def ref_comm():
    return hj.Communication(jax.devices()[:1])


def _scipy(fmt, shape, density, seed, dtype):
    """A seeded scipy matrix with empty rows and columns; floats positive
    (sums without cancellation), integers of both signs."""
    rng = np.random.default_rng(seed)
    m = sp.random(*shape, density=density, random_state=rng, format="coo")
    keep = (m.row % 7 != 3) & (m.col % 5 != 2)  # empty rows and columns
    data = m.data[keep] + 0.25 if dtype != "int32" else rng.integers(1, 9, keep.sum()) * rng.choice([-1, 1], keep.sum())
    return FORMATS[fmt][0]((data.astype(dtype), (m.row[keep], m.col[keep])), shape=shape)


def _pair(obj, fmt, split, comm):
    name = FORMATS[fmt][1]
    return getattr(ht.sparse, name)(obj, split=split), getattr(hj.sparse, name)(obj, split=split, comm=comm)


def _bits(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, (what, got.dtype, want.dtype, got.shape, want.shape)
    assert got.tobytes() == want.tobytes(), what


def _same_matrix(got, want, what=""):
    """Format, shape, split, type, pattern, counts and values, bitwise."""
    assert type(got).__name__ == type(want).__name__, what
    assert got.shape == want.shape and got.split == want.split, what
    assert got.dtype.__name__ == want.dtype.__name__, (what, got.dtype, want.dtype)
    assert got.gnnz == want.gnnz and got._capacity == want._capacity, (what, got.gnnz, want.gnnz)
    assert got.counts_displs_nnz() == want.counts_displs_nnz(), what
    _bits(got.indptr.numpy(), want.indptr, what + " indptr")
    _bits(got.indices.numpy().astype(np.int32), want.indices, what + " indices")
    _bits(got.data.numpy(), want.data, what + " data")


def _close(got, want, dtype, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, (what, got.dtype, want.dtype)
    if dtype == "int32":
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL[dtype], atol=0, err_msg=what)


def _dense_result(got, want, dtype, what=""):
    assert got.shape == want.shape and got.split == want.split, (what, got.split, want.split)
    assert got.dtype.__name__ == want.dtype.__name__, what
    _close(got.numpy(), want.numpy(), dtype, what)


# each format with each split and each type; each split with each type
CASES = [("csr", None, "float32"), ("csr", 0, "float64"), ("csr", 0, "int32"), ("csc", None, "float64"),
         ("csc", None, "int32"), ("csc", 1, "float32")]


@pytest.mark.parametrize("fmt,split,dtype", CASES)
def test_layout_and_accessors_match_the_reference(fmt, split, dtype, ref_comm):
    a = _scipy(fmt, (37, 23), 0.2, 1, dtype)
    got, want = _pair(a, fmt, split, ref_comm)
    _same_matrix(got, want)
    assert got.lnnz == want.lnnz and got.lshape == want.lshape and got.nnz == want.nnz
    assert got.balanced == want.balanced and got.is_distributed() == want.is_distributed() is False
    assert got.ndim == 2 and got._comp_pad == want._comp_pad and repr(got) == repr(want)
    _bits(got.lindptr.numpy(), want.lindptr, "lindptr")
    _bits(got.gindptr.numpy(), want.gindptr, "gindptr")
    _bits(got.lindices.numpy().astype(np.int32), want.lindices, "lindices")
    _bits(got.ldata.numpy(), want.ldata, "ldata")
    local = got.larray  # torch's own CSR/CSC of the rank's chunk
    assert local.layout == (torch.sparse_csr if fmt == "csr" else torch.sparse_csc)
    np.testing.assert_array_equal(local.to_dense().numpy(), a.toarray())
    _bits(got.toarray(), want.toarray(), "toarray")
    dense = ht.sparse.to_dense(got)
    assert dense.split == want.todense().split
    out = ht.zeros(a.shape, dtype=dense.dtype, split=split)
    assert ht.sparse.to_dense(got, out=out) is out
    _bits(out.numpy(), want.toarray(), "to_dense(out=)")


@pytest.mark.parametrize("fmt,split,dtype", CASES)
def test_elementwise_scalar_astype_and_transpose_match_the_reference(fmt, split, dtype, ref_comm):
    a, b = _scipy(fmt, (37, 23), 0.2, 1, dtype), _scipy(fmt, (37, 23), 0.25, 2, dtype)
    (pa, ra), (pb, rb) = _pair(a, fmt, split, ref_comm), _pair(b, fmt, split, ref_comm)
    _same_matrix(pa + pb, ra + rb, "add")
    _same_matrix(ht.sparse.add(pa, pb), hj.sparse.add(ra, rb), "add(a, b)")
    _same_matrix(pa * pb, ra * rb, "mul")
    _same_matrix(ht.sparse.mul(pa, pb), hj.sparse.mul(ra, rb), "mul(a, b)")
    for s in (2, 2.5, -1, True):
        _same_matrix(pa * s, ra * s, f"a * {s!r}")
        _same_matrix(s * pa, s * ra, f"{s!r} * a")
        _same_matrix(pa + s, ra + s, f"a + {s!r}")
    _same_matrix(pa.astype(ht.float64), ra.astype(hj.float64), "astype")
    _same_matrix(pa.T, ra.T, "T")
    _same_matrix(pa.T.T, ra.T.T, "T.T")
    _same_matrix(ht.sparse.to_sparse_csr(pa), hj.sparse.to_sparse_csr(ra), "to_sparse_csr")
    _same_matrix(ht.sparse.to_sparse_csc(pa), hj.sparse.to_sparse_csc(ra), "to_sparse_csc")
    _same_matrix(ht.sparse.to_sparse(pa.todense()), hj.sparse.to_sparse(ra.todense()), "to_sparse(todense)")
    other_split = None if split is not None else FORMATS[fmt][2]
    pc, rc = _pair(b, fmt, other_split, ref_comm)
    _same_matrix(pa + pc, ra + rc, "add across splits")


@pytest.mark.parametrize("fmt,split,dtype", CASES)
def test_products_and_sums_match_the_reference(fmt, split, dtype, ref_comm):
    a = _scipy(fmt, (37, 23), 0.2, 1, dtype)
    pa, ra = _pair(a, fmt, split, ref_comm)
    rng = np.random.default_rng(3)
    if dtype == "int32":
        x, v, e = (rng.integers(-4, 5, s).astype(dtype) for s in ((23, 4), (23,), (5, 37)))
    else:
        x, v, e = (rng.random(s).astype(dtype) + 0.5 for s in ((23, 4), (23,), (5, 37)))
    for xsplit in (None, 0):
        _dense_result(pa @ ht.array(x, split=xsplit), ra @ hj.array(x, split=xsplit, comm=ref_comm), dtype,
                      f"A @ X split {xsplit}")
    _dense_result(pa @ ht.array(v), ra @ hj.array(v, comm=ref_comm), dtype, "A @ v")
    _dense_result(ht.sparse.matmul(pa, x), hj.sparse.matmul(ra, x), dtype, "matmul(A, numpy)")
    for esplit in (0, 1):  # E split None: the vector e below
        _dense_result(ht.array(e, split=esplit) @ pa, hj.array(e, split=esplit, comm=ref_comm) @ ra, dtype,
                      f"E @ A split {esplit}")
    _dense_result(ht.array(e[0]) @ pa, hj.array(e[0], comm=ref_comm) @ ra, dtype, "e @ A")
    for axis in (None, 0, 1, -1):
        _dense_result(pa.sum(axis=axis), ra.sum(axis=axis), dtype, f"sum axis {axis}")
    _dense_result(pa.T @ ht.array(e.T.copy()), ra.T @ hj.array(e.T.copy(), comm=ref_comm), dtype, "A.T @ E.T")


@pytest.mark.parametrize("route", ["ring", "dense"])
@pytest.mark.parametrize("fmt_a,fmt_b,split", [("csr", "csr", 0), ("csc", "csc", None), ("csr", "csc", 0),
                                               ("csc", "csr", 1)])
def test_spgemm_routes_match_the_reference(route, fmt_a, fmt_b, split, ref_comm, monkeypatch):
    """Each route forced in both packages: 1.0 never takes the dense route
    (the estimate stays below 1), 0.0 always does."""
    monkeypatch.setenv("HEAT_TPU_SPGEMM_DENSE_DENSITY", "1.0" if route == "ring" else "0.0")
    dtype = "float64" if fmt_a == fmt_b == "csc" else "float32"
    a, b = _scipy(fmt_a, (31, 19), 0.2, 4, dtype), _scipy(fmt_b, (19, 26), 0.25, 5, dtype)
    split_b = None if split is None else FORMATS[fmt_b][2]
    (pa, ra), (pb, rb) = _pair(a, fmt_a, split, ref_comm), _pair(b, fmt_b, split_b, ref_comm)
    got, want = pa @ pb, ra @ rb
    assert type(got).__name__ == type(want).__name__ and got.split == want.split
    assert got.gnnz == want.gnnz and got._capacity == want._capacity
    _bits(got.indptr.numpy(), want.indptr, "indptr")
    _bits(got.indices.numpy().astype(np.int32), want.indices, "indices")
    _close(got.data.numpy(), want.data, dtype, "data")
    np.testing.assert_allclose(got.toarray(), (a @ b).toarray(), rtol=RTOL[dtype])


def test_adversarial_cases_match_the_reference(ref_comm):
    """Empty rows, a product of patterns that never meet, a + (-a) and
    acc += m five times (tests/test_sparse_adversarial.py)."""
    m = sp.random(80, 40, density=0.05, random_state=7, format="csr", dtype=np.float32)
    pm, rm = _pair(m, "csr", 0, ref_comm)
    pacc, racc = pm, rm
    for _ in range(5):
        pacc += pm
        racc += rm
    _same_matrix(pacc, racc, "acc += m")
    assert pacc._capacity == pm._capacity
    _same_matrix(pm + pm * (-1.0), rm + rm * (-1.0), "a + (-a)")
    assert (pm + pm * (-1.0)).gnnz == pm.gnnz
    empty = np.zeros((12, 9), np.float64)
    empty[[2, 3], [4, 4]] = 1.5
    pe, re = _pair(sp.csr_matrix(empty), "csr", 0, ref_comm)
    for got, want in ((pe, re), (pe + pe, re + re), (pe * pe, re * re), (pe.T, re.T)):
        _same_matrix(got, want)
    _dense_result(pe.sum(axis=1), re.sum(axis=1), "float64")
    diag, upper = sp.csr_matrix(np.diag(np.arange(1.0, 9.0))), sp.csr_matrix(np.eye(8, k=4))
    (pd, rd), (pu, ru) = _pair(diag, "csr", 0, ref_comm), _pair(upper, "csr", 0, ref_comm)
    _same_matrix(pd * pu, rd * ru, "disjoint mul")
    assert (pd * pu).gnnz == 0
    # left's columns 0-3 meet right's rows 0-3, which are empty
    left, right = np.eye(8, k=-1), np.eye(8)
    left[:, 4:] = 0.0
    right[:4] = 0.0
    (pl, rl), (pr, rr) = _pair(sp.csr_matrix(left), "csr", 0, ref_comm), _pair(sp.csr_matrix(right), "csr", 0,
                                                                               ref_comm)
    _same_matrix(pl @ pr, rl @ rr, "all-zero product")
    assert (pl @ pr).gnnz == 0 and (pl @ pr)._capacity == 1


def test_factories_match_the_reference(ref_comm):
    rng = np.random.default_rng(6)
    dense = rng.standard_normal((11, 7)).astype(np.float32)
    dense[rng.random((11, 7)) < 0.6] = 0.0
    dense[1, 1] = -0.0
    rows, cols = np.array([0, 0, 4, 4, 4, 10]), np.array([1, 1, 3, 3, 3, 0])
    vals = np.array([1.0, 2.0, 0.5, 0.25, 0.25, -1.0], np.float32)
    coo = sp.coo_matrix((vals, (rows, cols)), shape=(11, 7))
    tcoo = torch.sparse_coo_tensor(torch.tensor(np.stack([rows, cols])), torch.tensor(vals), (11, 7))
    tcsr = torch.tensor(dense).to_sparse_csr()
    for fmt in FORMATS:
        name, split = FORMATS[fmt][1], FORMATS[fmt][2]
        for source, ref_source in ((dense, dense), (torch.tensor(dense), dense), (coo, coo), (tcoo, coo), (tcsr, tcsr),
                                   (coo.tocsc(), coo.tocsc()), (dense.tolist(), dense.tolist())):
            for s in (None, split):
                _same_matrix(getattr(ht.sparse, name)(source, split=s),
                             getattr(hj.sparse, name)(ref_source, split=s, comm=ref_comm), f"{fmt} {type(source)}")
        for dsplit in (None, 0, 1):
            for s in (None, split):
                _same_matrix(getattr(ht.sparse, name)(ht.array(dense, split=dsplit), split=s),
                             getattr(hj.sparse, name)(hj.array(dense, split=dsplit, comm=ref_comm), split=s,
                                                      comm=ref_comm), f"{fmt} DNDarray split {dsplit} -> {s}")
        _same_matrix(getattr(ht.sparse, name)(coo, dtype=ht.float64, is_split=split),
                     getattr(hj.sparse, name)(coo, dtype=hj.float64, is_split=split, comm=ref_comm), "dtype=")
        port = getattr(ht.sparse, name)(coo, split=split)
        _same_matrix(getattr(ht.sparse, name)(port), getattr(hj.sparse, name)(coo, comm=ref_comm), "sparse source")
        with pytest.raises(ValueError, match="only supports split"):
            getattr(ht.sparse, name)(coo, split=1 - split)
    with pytest.raises(ValueError, match="mutually exclusive"):
        ht.sparse.sparse_csr_matrix(coo, split=0, is_split=0)
    with pytest.raises(ValueError, match="2-dimensional"):
        ht.sparse.sparse_csr_matrix(np.zeros(3))
    with pytest.raises(TypeError):
        ht.sparse.sparse_csr_matrix(coo) + ht.sparse.sparse_csc_matrix(coo)
    with pytest.raises(ValueError):
        ht.sparse.sparse_csr_matrix(coo) + ht.sparse.sparse_csr_matrix(coo.T)
    with pytest.raises(ValueError, match="shape mismatch"):
        ht.sparse.sparse_csr_matrix(coo) @ ht.array(np.ones((3, 2)))


def test_from_reference_sparse_keeps_the_reference_matrix(ref_comm):
    """A reference result with stored zeros (a + (-a) beside a), carried
    over as its global planes: the same pattern and values, in both
    formats and splits; and dense @ sparse through the DNDarray operator."""
    m = sp.random(20, 15, density=0.2, random_state=3, format="csr", dtype=np.float32)
    rm = hj.sparse.sparse_csr_matrix(m, split=0, comm=ref_comm)
    for ref in (rm + rm * (-1.0), rm, hj.sparse.to_sparse_csc(rm)):
        fmt = "csr" if isinstance(ref, hj.sparse.DCSR_matrix) else "csc"
        for split in (None, ref.split):
            got = from_reference_sparse(np.asarray(ref.indptr), np.asarray(ref.indices), np.asarray(ref.data),
                                        ref.shape, fmt, split=split)
            assert got.split == split
            _same_matrix(got, ref if split == ref.split else
                         getattr(hj.sparse, FORMATS[fmt][1])(ref, split=split, comm=ref_comm))
    with pytest.raises(ValueError, match="format"):
        from_reference_sparse(m.indptr, m.indices, m.data, m.shape, "coo")
    e = np.random.default_rng(4).random((3, 20)).astype(np.float32)
    got = ht.array(e, split=1) @ ht.sparse.sparse_csr_matrix(m, split=0)
    want = hj.array(e, split=1, comm=ref_comm) @ rm
    _dense_result(got, want, "float32", "DNDarray @ DCSR")


def test_blocks_bound_the_products(monkeypatch):
    """With the block budget patched to 8 products, A @ X of 3 columns runs
    in blocks of 2 entries, rows cut across blocks, and gives the unblocked
    result."""
    m = sp.random(40, 30, density=0.2, random_state=8, format="csr", dtype=np.float64)
    x = np.random.default_rng(9).random((30, 3))
    whole = (ht.sparse.sparse_csr_matrix(m) @ ht.array(x)).numpy()
    calls = []
    seg = _planes.segment_sum
    monkeypatch.setattr(_planes, "BLOCK_ELEMENTS", 8)
    monkeypatch.setattr(_planes, "segment_sum", lambda d, l: calls.append(d.shape) or seg(d, l))
    got = (ht.sparse.sparse_csr_matrix(m) @ ht.array(x)).numpy()
    assert len(calls) == -(-m.nnz // 2) and max(c[0] for c in calls) == 2
    np.testing.assert_allclose(got, whole, rtol=1e-12)
    np.testing.assert_allclose(got, m @ x, rtol=1e-10)


def test_psum_scatter_in_a_world_of_one():
    comm = ht.get_comm()
    x = torch.arange(6.0).reshape(3, 2)
    assert comm.psum_scatter(x) is x and comm.psum_scatter(x, scatter_dimension=1) is x
    with pytest.raises(ValueError, match="divisible"):
        ht.Communication(size=2, rank=0).psum_scatter(x)


def test_csr_spmm_plain_version_and_its_checks():
    """The CSR SpMM kernel's plain version (what the CPU runs) against a
    dense float64 product: ragged rows (empty ones, ones cut by blocks),
    widths 1 and 5, a strided x, accumulating into out; and the operands
    its wrapper refuses."""
    rng = np.random.default_rng(12)
    lengths = rng.integers(0, 9, 40)
    lengths[::6] = 0
    ptr = torch.tensor(np.concatenate([[0], np.cumsum(lengths)]), dtype=torch.int64)
    col = torch.tensor(rng.integers(0, 13, int(ptr[-1])), dtype=torch.int32)
    w = torch.tensor(rng.standard_normal(int(ptr[-1])))
    dense = np.zeros((40, 13))
    np.add.at(dense, (np.repeat(np.arange(40), lengths), col.numpy()), w.numpy())
    for width in (1, 5):
        x = torch.tensor(rng.standard_normal((13, width + 2)))[:, :width]
        np.testing.assert_allclose(_planes.csr_spmm(ptr, col, w, x).numpy(), dense @ x.numpy(), rtol=1e-12,
                                   atol=1e-12)
        base = torch.tensor(rng.standard_normal((40, width)))
        np.testing.assert_allclose(_planes.csr_spmm(ptr, col, w, x, base.clone()).numpy(),
                                   base.numpy() + dense @ x.numpy(), rtol=1e-12, atol=1e-12)
    with pytest.raises(TypeError):
        _planes.csr_spmm(ptr, col.long(), w, torch.ones(13, 2, dtype=torch.float64))
    with pytest.raises(TypeError):
        _planes.csr_spmm(ptr, col, w, torch.ones(13, 2, dtype=torch.float32))
    with pytest.raises(ValueError):
        _planes.csr_spmm(ptr, col, w, torch.ones(13, 2, dtype=torch.float64), torch.zeros(39, 2, dtype=torch.float64))


@pytest.mark.parametrize("dtype", list(_planes.CSR_SPMM_TYPES), ids=str)
def test_csr_spmm_plain_version_takes_every_type(dtype):
    """Every value type the kernel takes, through its plain version, against
    the same product in a wide type: integers wrapped to their width and
    bool (an OR of ANDs) exactly; floats and complex values within
    (len + 4) u S of each row, S its sum of |w||x| and u the type's unit
    roundoff, the bound of a recursive sum of len products."""
    rng = np.random.default_rng(13)
    lengths = rng.integers(0, 9, 30)
    lengths[::6] = 0
    ptr = torch.tensor(np.concatenate([[0], np.cumsum(lengths)]), dtype=torch.int64)
    col = torch.tensor(rng.integers(0, 11, int(ptr[-1])), dtype=torch.int32)
    rows = np.repeat(np.arange(30), lengths)

    def draw(*shape):
        if dtype.is_floating_point or dtype.is_complex:
            return torch.tensor(rng.standard_normal(shape + (2,))).view(torch.complex128).reshape(shape).to(dtype) \
                if dtype.is_complex else torch.tensor(rng.standard_normal(shape)).to(dtype)
        return torch.tensor(rng.integers(0, 2 if dtype == torch.bool else 200, shape)).to(dtype)

    w, x, base = draw(int(ptr[-1])), draw(11, 3), draw(30, 3)
    for out in (None, base):
        got = _planes.csr_spmm(ptr, col, w, x, None if out is None else out.clone())
        assert got.dtype == dtype and got.shape == (30, 3)
        if dtype == torch.bool:
            want = np.zeros((30, 3), bool)
            np.logical_or.at(want, rows, w.numpy()[:, None] & x.numpy()[col.numpy()])
            if out is not None:
                want |= out.numpy()
            np.testing.assert_array_equal(got.numpy(), want)
        elif not (dtype.is_floating_point or dtype.is_complex):
            want = np.zeros((30, 3), np.int64)
            np.add.at(want, rows, w.numpy().astype(np.int64)[:, None] * x.numpy().astype(np.int64)[col.numpy()])
            if out is not None:
                want += out.numpy().astype(np.int64)
            np.testing.assert_array_equal(got.numpy(), torch.tensor(want).to(dtype).numpy())
        else:
            wide = torch.complex128 if dtype.is_complex else torch.float64
            wn, xn = w.to(wide).numpy(), x.to(wide).numpy()
            want, s = np.zeros((30, 3), wn.dtype), np.zeros((30, 3))
            np.add.at(want, rows, wn[:, None] * xn[col.numpy()])
            np.add.at(s, rows, np.abs(wn)[:, None] * np.abs(xn[col.numpy()]))
            if out is not None:
                want += out.to(wide).numpy()
                s += np.abs(out.to(wide).numpy())
            u = torch.finfo(torch.empty(0, dtype=dtype).real.dtype).eps / 2
            bound = (lengths[:, None] + 4) * u * s
            assert np.all(np.abs(got.to(wide).numpy() - want) <= bound)
