"""The port's sparse layer in a world of 3 CPU ranks (torch.distributed,
gloo) against heat_tpu.sparse on a 3-device Communication, all in one
spawn of the world: each rank's counts, capacity, displacements and local
pointers; the CSR SpMM's ring (P - 1 ppermutes of X's row chunks, no
all-gather of X); the CSC route's one reduce-scatter (no all-gather); sum
along both axes; the SpGEMM ring; the re-chunking between split and None;
and the calls of examples/sparse/spmm_and_redistribute.py, printing the
reference's lines.

The rank script is the one slice of a world of 3 rank processes
(tests/torch_world.py), which must finish it within 60 s; the reference
computes its results while the ranks run."""

import contextlib
import io
import os
import re

import jax
import numpy as np
import pytest
import scipy.sparse as sp

import heat_tpu as hj
from heat_tpu.sparse import _planes as ref_planes
from torch_world import REPO, WORLD, spawned

pytestmark = pytest.mark.multiprocess

EXAMPLE = REPO / "examples" / "sparse" / "spmm_and_redistribute.py"
_NUMBER = re.compile(r"[-+]?(?:\d+\.?\d*|\.\d+)(?:[eE][-+]?\d+)?")

_SPARSE_MAIN = r"""
import contextlib
import io
import os

import scipy.sparse as sp

example = str(arrays["example"])
saved = {}
calls = {}
phase = [None]
for fname in ("all_gather", "all_gather_varying", "ppermute", "psum_scatter", "psum"):
    fn = getattr(ht.Communication, fname)

    def recording(self, x, *args, _fn=fn, _name=fname, **kw):
        if phase[0] is not None:
            calls.setdefault(phase[0], []).append(_name)
        return _fn(self, x, *args, **kw)

    setattr(ht.Communication, fname, recording)


def run(name, fn):
    phase[0] = name
    calls.setdefault(name, [])
    try:
        return fn()
    finally:
        phase[0] = None


def save_matrix(name, s):
    saved[name + "/lnnz"] = np.asarray(s.lnnz)
    saved[name + "/capacity"] = np.asarray(s._capacity)
    saved[name + "/counts_displs"] = np.asarray(s.counts_displs_nnz())
    saved[name + "/lindptr"] = s.lindptr.numpy()
    saved[name + "/lindices"] = s.lindices.numpy()
    saved[name + "/ldata"] = s.ldata.numpy()
    saved[name + "/indptr"] = s.indptr.numpy()
    saved[name + "/indices"] = s.indices.numpy()
    saved[name + "/data"] = s.data.numpy()
    saved[name + "/split"] = np.asarray(-1 if s.split is None else s.split)
    saved[name + "/lshape"] = np.asarray(s.lshape)
    saved[name + "/larray"] = s.larray.to_dense().numpy()


def save_dense(name, a):
    saved[name + "/local"] = a.larray.numpy()
    saved[name + "/split"] = np.asarray(-1 if a.split is None else a.split)


a, b, x = arrays["a"], arrays["b"], arrays["x"]
A = ht.sparse.sparse_csr_matrix(sp.csr_matrix(a), split=0)
B = ht.sparse.sparse_csr_matrix(sp.csr_matrix(b), split=0)
C = ht.sparse.sparse_csc_matrix(sp.csc_matrix(a), split=1)
An = ht.sparse.sparse_csr_matrix(sp.csr_matrix(a))
X = ht.array(x, split=0)
save_matrix("A", A)
save_matrix("C", C)
save_matrix("add", run("add", lambda: A + B))
save_matrix("mul", run("mul", lambda: A * B))
save_matrix("scalar", run("scalar", lambda: A * 2.5 + 1.0))
save_dense("ring", run("ring", lambda: A @ X))
save_dense("ring_vec", run("ring_vec", lambda: A @ ht.array(x[:, 0].copy(), split=0)))
save_dense("csc", run("csc", lambda: C @ X))
save_dense("dense_sp", run("dense_sp", lambda: ht.array(arrays["e"], split=1) @ A))
save_dense("dense_csc", run("dense_csc", lambda: ht.array(arrays["e"]) @ C))
for name, m in (("A", A), ("C", C)):
    for axis in (None, 0, 1):
        save_dense(f"sum{name}{axis}", run(f"sum{name}{axis}", lambda: m.sum(axis=axis)))
os.environ["HEAT_TPU_SPGEMM_DENSE_DENSITY"] = "1.0"
S = ht.sparse.sparse_csr_matrix(sp.csr_matrix(arrays["s"]), split=0)
save_matrix("spgemm", run("spgemm", lambda: A @ S))
Sc = ht.sparse.sparse_csc_matrix(sp.csc_matrix(arrays["s"]), split=1)
save_matrix("spgemm_csc", run("spgemm_csc", lambda: C @ Sc))
os.environ["HEAT_TPU_SPGEMM_DENSE_DENSITY"] = "0.0"
save_matrix("spgemm_dense", run("spgemm_dense", lambda: A @ S))
del os.environ["HEAT_TPU_SPGEMM_DENSE_DENSITY"]
save_matrix("to_none", run("to_none", lambda: An + A))
save_matrix("to_split", run("to_split", lambda: A + An))
save_matrix("to_csc", run("to_csc", lambda: ht.sparse.to_sparse_csc(A)))
save_matrix("to_csr", run("to_csr", lambda: ht.sparse.to_sparse_csr(C)))
save_matrix("from_dense", ht.sparse.to_sparse(ht.array(a, split=0)))
save_dense("todense", A.todense())
for name in calls:
    saved["calls/" + name] = np.asarray(calls[name], dtype=str)
phase[0] = None
src = open(example).read().replace("import heat_tpu as ht", "import heat_tpu_torch as ht")
ns = {"__name__": "example"}
exec(compile(src, example, "exec"), ns)
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    ns["main"]()
saved["example"] = np.asarray(buf.getvalue())
np.savez(out, **saved)
"""


def _matrix(rng, shape, density, empty_rows=()):
    m = rng.random(shape) * (rng.random(shape) < density)
    m[list(empty_rows)] = 0.0
    return m.astype(np.float32)


def _reference(arrays, comm):
    """Every result of the rank script, by the reference on 3 devices: each
    matrix as its numpy views, each dense result as (split, array), and the
    example's printed text."""
    A = hj.sparse.sparse_csr_matrix(sp.csr_matrix(arrays["a"]), split=0, comm=comm)
    B = hj.sparse.sparse_csr_matrix(sp.csr_matrix(arrays["b"]), split=0, comm=comm)
    C = hj.sparse.sparse_csc_matrix(sp.csc_matrix(arrays["a"]), split=1, comm=comm)
    An = hj.sparse.sparse_csr_matrix(sp.csr_matrix(arrays["a"]), comm=comm)
    S = hj.sparse.sparse_csr_matrix(sp.csr_matrix(arrays["s"]), split=0, comm=comm)
    Sc = hj.sparse.sparse_csc_matrix(sp.csc_matrix(arrays["s"]), split=1, comm=comm)
    X = hj.array(arrays["x"], split=0, comm=comm)
    matrices = {"A": A, "C": C, "add": A + B, "mul": A * B, "scalar": A * 2.5 + 1.0, "to_none": An + A,
                "to_split": A + An, "to_csc": hj.sparse.to_sparse_csc(A), "to_csr": hj.sparse.to_sparse_csr(C),
                "from_dense": hj.sparse.to_sparse(hj.array(arrays["a"], split=0, comm=comm))}
    dense = {"ring": A @ X, "ring_vec": A @ hj.array(arrays["x"][:, 0].copy(), split=0, comm=comm), "csc": C @ X,
             "dense_sp": hj.array(arrays["e"], split=1, comm=comm) @ A,
             "dense_csc": hj.array(arrays["e"], comm=comm) @ C, "todense": A.todense()}
    for name, m in (("A", A), ("C", C)):
        for axis in (None, 0, 1):
            dense[f"sum{name}{axis}"] = m.sum(axis=axis)
    saved_env = os.environ.get("HEAT_TPU_SPGEMM_DENSE_DENSITY")
    try:
        os.environ["HEAT_TPU_SPGEMM_DENSE_DENSITY"] = "1.0"
        matrices.update(spgemm=A @ S, spgemm_csc=C @ Sc)
        os.environ["HEAT_TPU_SPGEMM_DENSE_DENSITY"] = "0.0"
        matrices["spgemm_dense"] = A @ S
    finally:
        os.environ.pop("HEAT_TPU_SPGEMM_DENSE_DENSITY")
        if saved_env is not None:
            os.environ["HEAT_TPU_SPGEMM_DENSE_DENSITY"] = saved_env
    want = {name: _matrix_views(m) for name, m in matrices.items()}
    want.update({name: (d.split, np.asarray(d.numpy()), d.shape) for name, d in dense.items()})
    saved_comm, state = hj.get_comm(), hj.random.get_state()
    hj.use_comm(comm)
    hj.random.seed(0)
    try:
        ns = {"__name__": "example"}
        exec(compile(EXAMPLE.read_text(), str(EXAMPLE), "exec"), ns)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            ns["main"]()
    finally:
        hj.use_comm(saved_comm)
        hj.random.set_state(state)
    want["example"] = buf.getvalue()
    want["spgemm_truth"] = arrays["a"].astype(np.float64) @ arrays["s"].astype(np.float64)
    return want


def _matrix_views(m):
    counts, displs = m.counts_displs_nnz()
    views = dict(counts=counts, displs=displs, capacity=m._capacity, split=m.split, shape=m.shape,
                 indptr=np.asarray(m.indptr), indices=np.asarray(m.indices), data=np.asarray(m.data),
                 dense=m.toarray())
    if m.split is not None:
        blocks = ref_planes.lindptr_blocks(m._comp, m._nshards, m._capacity, m._comp_pad, m._dist, m.comm)
        views["lindptr"] = np.asarray(blocks).reshape(m._nshards, m._comp_pad + 1)
    return views


def _sparse_inputs():
    """37 x 23 (rows 26-36 are rank 2's, 35-36 padding; rank 1's rows all
    empty in B), a 23 x 29 right factor, X of 23 x 4 (rank 2 holds 7 rows
    and 2 of padding)."""
    rng = np.random.default_rng(51)
    arrays = dict(a=_matrix(rng, (37, 23), 0.2, empty_rows=[5, 6, 30]),
                  b=_matrix(rng, (37, 23), 0.25, empty_rows=range(13, 26)),
                  s=_matrix(rng, (23, 29), 0.2), x=rng.random((23, 4)).astype(np.float32),
                  e=rng.random((3, 37)).astype(np.float32), example=np.asarray(str(EXAMPLE)))
    return arrays, None


_SLICES = {"sparse": (_SPARSE_MAIN, _sparse_inputs)}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every rank's results and the reference's, which it computes while
    the ranks run."""
    saved = os.environ.pop("HEAT_TPU_SPGEMM_DENSE_DENSITY", None)  # the ranks start with the default
    try:
        with spawned(tmp_path_factory.mktemp("sparse"), _SLICES) as w:
            want = _reference(w["sparse"][0], hj.Communication(jax.devices()[:WORLD]))
            ranks = w.ranks("sparse")
    finally:
        if saved is not None:
            os.environ["HEAT_TPU_SPGEMM_DENSE_DENSITY"] = saved
    return ranks, want


def _same_matrix(got, name, want, r):
    """Rank r's view of the matrix ``name`` is its view of the reference's;
    returns the reference's global data."""
    counts, displs = want["counts"], want["displs"]
    assert int(got[name + "/lnnz"]) == counts[r if want["split"] is not None else 0], name
    assert int(got[name + "/capacity"]) == want["capacity"], name
    np.testing.assert_array_equal(got[name + "/counts_displs"], np.asarray((counts, displs)), err_msg=name)
    assert int(got[name + "/split"]) == (-1 if want["split"] is None else want["split"]), name
    np.testing.assert_array_equal(got[name + "/indptr"], want["indptr"], err_msg=name)
    np.testing.assert_array_equal(got[name + "/indices"], want["indices"], err_msg=name)
    if want["split"] is not None:
        np.testing.assert_array_equal(got[name + "/lindptr"], want["lindptr"][r], err_msg=name)
        lo = displs[r]
        np.testing.assert_array_equal(got[name + "/lindices"], want["indices"][lo:lo + counts[r]], err_msg=name)
        ref_comm = hj.Communication(jax.devices()[:WORLD])
        _, lshape, sl = ref_comm.chunk(want["shape"], want["split"], rank=r)
        assert tuple(got[name + "/lshape"]) == tuple(lshape), name
        np.testing.assert_allclose(got[name + "/larray"], want["dense"][sl], rtol=1e-6, err_msg=name)
    return want["data"]


def _same_dense(got, name, want, r):
    split, full, shape = want[name]
    assert int(got[name + "/split"]) == (-1 if split is None else split), name
    if split is not None:
        full = full[hj.Communication(jax.devices()[:WORLD]).chunk(shape, split, rank=r)[2]]
    np.testing.assert_allclose(got[name + "/local"], full, rtol=1e-6, err_msg=f"rank {r} {name}")


def test_layout_and_elementwise_ops_per_rank(world):
    ranks, want = world
    for r, got in enumerate(ranks):
        for name in ("A", "C", "add", "mul", "scalar"):
            np.testing.assert_array_equal(got[name + "/data"], _same_matrix(got, name, want[name], r), err_msg=name)
        assert list(got["calls/add"]) == ["all_gather"] == list(got["calls/mul"])  # the nnz re-sync alone
        assert list(got["calls/scalar"]) == []
        _same_dense(got, "todense", want, r)


def test_products_and_sums_take_the_references_routes(world):
    """The ring sends X's chunks P - 1 times and gathers nothing; the CSC
    route and the sum along the uncompressed axis meet in one
    reduce-scatter; E @ A in one all-reduce."""
    ranks, want = world
    for r, got in enumerate(ranks):
        assert list(got["calls/ring"]) == ["ppermute"] * (WORLD - 1)
        assert list(got["calls/ring_vec"]) == ["ppermute"] * (WORLD - 1)
        assert list(got["calls/csc"]) == ["psum_scatter"]
        assert list(got["calls/dense_sp"]) == ["psum"] and list(got["calls/dense_csc"]) == []
        assert list(got["calls/sumA0"]) == ["psum_scatter"] and list(got["calls/sumC1"]) == ["psum_scatter"]
        assert list(got["calls/sumA1"]) == [] and list(got["calls/sumC0"]) == []
        for name in ("ring", "ring_vec", "csc", "dense_sp", "dense_csc") + tuple(
                f"sum{m}{axis}" for m in "AC" for axis in (None, 0, 1)):
            _same_dense(got, name, want, r)


def test_spgemm_ring_and_rechunking_per_rank(world):
    ranks, want = world
    for r, got in enumerate(ranks):
        for name in ("spgemm", "spgemm_csc", "spgemm_dense"):
            np.testing.assert_allclose(got[name + "/data"], _same_matrix(got, name, want[name], r), rtol=1e-6,
                                       err_msg=name)
        # P ring steps: each a re-sync of its partial counts, each after the
        # first a merge with its own; B's three planes sent P - 1 times
        calls = list(got["calls/spgemm"])
        assert calls.count("ppermute") == 3 * (WORLD - 1) and calls.count("all_gather") == 2 * WORLD - 1
        assert "all_gather_varying" not in calls
        for name in ("to_none", "to_split", "to_csc", "to_csr", "from_dense"):
            np.testing.assert_array_equal(got[name + "/data"], _same_matrix(got, name, want[name], r), err_msg=name)
        assert list(got["calls/to_split"]) == ["all_gather"]  # None -> split cuts locally, then the merge's re-sync
        assert "all_gather_varying" in list(got["calls/to_none"])  # split -> None gathers the triplets
    got = ranks[0]
    product = sp.csr_matrix((got["spgemm/data"], got["spgemm/indices"], got["spgemm/indptr"]), shape=(37, 29))
    np.testing.assert_allclose(product.toarray(), want["spgemm_truth"], rtol=1e-5)


def test_example_prints_the_references_lines(world):
    """examples/sparse/spmm_and_redistribute.py through the port on 3 ranks
    and through the reference on 3 devices: the same lines, every number
    within 1e-12 (the CSR/CSC difference is rounding noise of float64)."""
    ranks, want = world
    for got in ranks:
        text = str(got["example"])
        assert _NUMBER.sub("#", text) == _NUMBER.sub("#", want["example"])
        np.testing.assert_allclose([float(t) for t in _NUMBER.findall(text)],
                                   [float(t) for t in _NUMBER.findall(want["example"])], rtol=0, atol=1e-12)
