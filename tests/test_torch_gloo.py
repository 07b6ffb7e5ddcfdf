"""The port in a world of 3 CPU ranks (torch.distributed, gloo) against
heat_tpu on a 3-device Communication: the canonical layout of an uneven
split, the distributed KMeans fit and predict, hierarchical SVD and PCA
over rows (one Gram all-reduce) and over columns (the merge tree), rsvd
and the randomized PCA over uneven rows, the
FFT along a split axis (the pencil: tiled all-to-alls, no gather), and
sequence-parallel attention (the ring of ring_shift, Ulysses' all-to-alls)
and its gradients across the ranks, and DataParallel's three gradient
schedules.

The ranks are separate processes that meet through a file store under the
test's temporary directory (no TCP port).  The test waits at most 60 s for
them, then kills them and fails."""

import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import heat_tpu as hj

pytestmark = pytest.mark.multiprocess

WORLD = 3
DEADLINE_S = 60.0
REPO = Path(__file__).resolve().parents[1]

_RANK_HEAD = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist

rank, store, data, out = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
dist.init_process_group("gloo", init_method="file://" + store, world_size=3, rank=rank)
import heat_tpu_torch as ht

ht.use_device("cpu")
arrays = np.load(data)
"""

_KMEANS_MAIN = _RANK_HEAD + r"""
x = ht.array(arrays["x"], split=0)
km = ht.cluster.KMeans(n_clusters=8, init="random", random_state=0, max_iter=30).fit(x)
np.savez(
    out,
    lshape_map=x.lshape_map,
    lshape=np.asarray(x.lshape),
    centers=km.cluster_centers_.numpy(),
    labels=km.labels_.numpy(),
    inertia=np.asarray(km.inertia_),
    n_iter=np.asarray(km.n_iter_),
    predict=km.predict(ht.array(arrays["fresh"], split=0)).numpy(),
)
dist.destroy_process_group()
"""

# every eigh input is recorded: the first of a split=0 fit is the summed Gram
# matrix, which must be the same bits on every rank
_HSVD_MAIN = _RANK_HEAD + r"""
seen = []
_eigh = torch.linalg.eigh


def recording_eigh(g):
    seen.append(g.clone())
    return _eigh(g)


torch.linalg.eigh = recording_eigh
gathered = []
_all_gather = ht.Communication.all_gather


def recording_all_gather(self, x, axis=0):
    gathered.append(x.numel())
    return _all_gather(self, x, axis)


ht.Communication.all_gather = recording_all_gather
rows = ht.array(arrays["rows"], split=0)
u, s, v, err = ht.linalg.hsvd_rank(rows, 5, compute_sv=True)
gram = seen[0].numpy()
u_rt, s_rt, v_rt, err_rt = ht.linalg.hsvd_rtol(rows, 0.3, compute_sv=True)
pca = ht.decomposition.PCA(n_components=4).fit(rows)
row_gathers = len(gathered)  # a fit over rows gathers nothing
cols = ht.array(arrays["cols"], split=1)
cu, cs, cv, cerr = ht.linalg.hsvd_rank(cols, 4, compute_sv=True)
cu_rt, cs_rt, cv_rt, cerr_rt = ht.linalg.hsvd_rtol(cols, 0.3, compute_sv=True)
ht.random.seed(5)
ru, rs, rv = ht.linalg.rsvd(rows, 5, n_oversamples=2, power_iter=1)
rpca = ht.decomposition.PCA(n_components=4, svd_solver="randomized", random_state=7, n_oversamples=3).fit(rows)
np.savez(
    out,
    ru=ru.numpy(), ru_local=ru.larray.numpy(), ru_split=np.asarray(ru.split), rs=rs.numpy(), rv=rv.numpy(),
    rpca_components=rpca.components_.numpy(), rpca_s=rpca.singular_values_.numpy(),
    rpca_ev=rpca.explained_variance_.numpy(), rpca_ratio=rpca.explained_variance_ratio_.numpy(),
    rpca_tevr=np.asarray(rpca.total_explained_variance_ratio_),
    rpca_transform=rpca.transform(ht.array(arrays["fresh"], split=0)).numpy(),
    row_gathers=np.asarray(row_gathers),
    gram=gram, u=u.numpy(), u_split=np.asarray(u.split), s=s.numpy(), v=v.numpy(), err=np.asarray(float(err)),
    u_rt=u_rt.numpy(), s_rt=s_rt.numpy(), v_rt=v_rt.numpy(), err_rt=np.asarray(float(err_rt)),
    cu=cu.numpy(), cs=cs.numpy(), cv=cv.numpy(), cv_split=np.asarray(cv.split), cerr=np.asarray(float(cerr)),
    cs_rt=cs_rt.numpy(), cv_rt=cv_rt.numpy(), cerr_rt=np.asarray(float(cerr_rt)),
    components=pca.components_.numpy(), ev=pca.explained_variance_.numpy(),
    ratio=pca.explained_variance_ratio_.numpy(), tevr=np.asarray(pca.total_explained_variance_ratio_),
    transform=pca.transform(ht.array(arrays["fresh"], split=0)).numpy(),
)
dist.destroy_process_group()
"""

_FFT_MAIN = _RANK_HEAD + r"""
gathered = []
_all_gather = ht.Communication.all_gather


def recording_all_gather(self, x, axis=0):
    gathered.append(x.numel())
    return _all_gather(self, x, axis)


ht.Communication.all_gather = recording_all_gather
cube = ht.array(arrays["cube"], split=0)
spec = ht.fft.fftn(cube)
back = ht.fft.ifftn(spec)
sig = ht.array(arrays["sig"], split=0)
f1 = ht.fft.fft(sig, axis=0)
r1 = ht.fft.rfft(ht.array(arrays["cube"][:, :, 0], split=0), axis=0, norm="ortho")
lshapes = np.asarray([spec.larray_padded.shape[0], f1.larray_padded.shape[0], r1.larray_padded.shape[0]])
transform_gathers = len(gathered)  # the pencil gathers nothing
np.savez(
    out,
    gathers=np.asarray(transform_gathers), lshapes=lshapes, splits=np.asarray([spec.split, f1.split, r1.split]),
    spec=spec.numpy(), back=back.numpy(), f1=f1.numpy(), r1=r1.numpy(),
)
dist.destroy_process_group()
"""


_ATTN_MAIN = _RANK_HEAD + r"""
q, k, v = (ht.array(arrays[n], split=0) for n in ("q", "k", "v"))
ring = ht.nn.scaled_dot_product_attention(q, k, v, causal=True, method="ring")
q6, k6, v6 = (ht.array(arrays[n], split=0) for n in ("q6", "k6", "v6"))
uly = ht.nn.scaled_dot_product_attention(q6, k6, v6, causal=True, method="ulysses")
flash = ht.nn.scaled_dot_product_attention(q6, k6, v6, method="flash")
comm = ht.get_comm()
x = torch.full((2, 3), float(rank))
errors = []
try:
    ht.nn.scaled_dot_product_attention(q, k, v, method="ulysses")  # 4 heads over 3 ranks
except ValueError as e:
    errors.append(str(e))
try:
    ht.nn.ring_attention(*(torch.zeros(4 + (rank == 1), 4, 8) for _ in range(3)))  # rank 1's block is longer
except ValueError as e:
    errors.append(str(e))
np.savez(
    out, ring=ring.numpy(), ring_lshape=np.asarray(ring.larray_padded.shape), uly=uly.numpy(), flash=flash.numpy(),
    shifted=comm.ring_shift(x).numpy(), back=comm.ring_shift(x, shift=-1).numpy(),
    partial=comm.ppermute(x, [(0, 2), (2, 1)]).numpy(), errors=np.asarray(errors),
)
dist.destroy_process_group()
"""

# one world for the training path: gradients of sum(attention * g) by the
# rank's chunk of q, k and v (the cross-rank terms ride back through
# ring_shift's and all_to_all's backward) and of a psum; then three
# DataParallels, one per schedule, from the reference's initial parameters,
# two Adam steps each on batches of 12 rows (4 a rank), and the forward
_TRAIN_MAIN = _RANK_HEAD + r"""
import os
import torch.nn.functional as F
from heat_tpu_torch.interop import params_from_reference
from heat_tpu_torch.nn import data_parallel

block = arrays["q"].shape[0] // 3
rows = slice(rank * block, (rank + 1) * block)
saved = {}
for name, fn, keys, kw in (("ring", ht.nn.ring_attention, ("q", "k", "v", "g"), {}),
                           ("uly", ht.nn.ulysses_attention, ("q6", "k6", "v6", "g6"), {}),
                           ("flash", ht.nn.ulysses_attention, ("q6", "k6", "v6", "g6"), {"use_flash": True})):
    q, k, v = (torch.from_numpy(arrays[key][rows].copy()).requires_grad_() for key in keys[:3])
    res = fn(q, k, v, causal=True, n_true=int(arrays["n_true"]), **kw)
    (res * torch.from_numpy(arrays[keys[3]][rows])).sum().backward()
    for t, key in zip((q, k, v), "qkv"):
        saved[f"{name}_d{key}"] = t.grad.numpy()
comm = ht.get_comm()
x = torch.full((2,), float(rank + 1), requires_grad=True)
(comm.psum(x) * float(rank + 1)).sum().backward()  # every rank's sum weighs x by the ranks' weights: 1 + 2 + 3
saved["psum_grad"] = x.grad.numpy()
plain = torch.full((2,), float(rank + 1))
saved["psum_in_place"] = np.asarray(comm.psum(plain) is plain)

os.environ["HEAT_TPU_GRAD_BUCKET_MB"] = str(300 / 2**20)  # 300-byte buckets: several a step
start = {"params": {"Dense_0": {"kernel": arrays["k0"], "bias": arrays["b0"]},
                    "Dense_1": {"kernel": arrays["k1"], "bias": arrays["b1"]}}}
for schedule in ("implicit", "bucketed", "fused"):
    model = torch.nn.Sequential(torch.nn.Linear(4, 32), torch.nn.ReLU(), torch.nn.Linear(32, 2))
    dp = ht.nn.DataParallel(model, optimizer=ht.optim.Adam(model.parameters(), lr=1e-2), grad_reduction=schedule)
    dp.set_params(params_from_reference(start, model))
    before = data_parallel.GRAD_BUCKETS
    losses = [dp.step(lambda p, t: F.cross_entropy(p, t.long()), ht.array(arrays["x"][s], split=0),
                      ht.array(arrays["y"][s], split=0)) for s in range(2)]
    saved[schedule + "_buckets"] = np.asarray(data_parallel.GRAD_BUCKETS - before)
    saved[schedule + "_losses"] = np.asarray(losses)
    for name, p in dp.params.items():
        saved[f"{schedule}_{name}"] = p.numpy()
split_out = dp(ht.array(arrays["x"][0], split=0))  # each rank its rows, the result split the same way
saved["forward_split"] = np.asarray(split_out.split)
saved["forward_local"] = split_out.larray.numpy()
saved["forward_whole"] = dp(torch.from_numpy(arrays["x"][0])).detach().numpy()  # a tensor: whole on every rank
np.savez(out, **saved)
dist.destroy_process_group()
"""


def _blobs(n, f, k, seed):
    rng = np.random.default_rng(seed)
    centres = rng.standard_normal((k, f)) * 6.0
    return (centres[rng.integers(0, k, n)] + rng.standard_normal((n, f))).astype(np.float32)


def _run_world(tmp_path, script, **arrays):
    data = tmp_path / "data.npz"
    np.savez(data, **arrays)
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": str(REPO)}
    procs = []
    for r in range(WORLD):
        cmd = [sys.executable, "-c", script, str(r), str(tmp_path / "store"), str(data), str(tmp_path / f"rank{r}.npz")]
        log = open(tmp_path / f"rank{r}.log", "w")
        procs.append((subprocess.Popen(cmd, cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT), log))
    deadline = time.monotonic() + DEADLINE_S
    try:
        for p, _ in procs:
            p.wait(timeout=max(0.1, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        for p, _ in procs:
            p.kill()
        pytest.fail(f"the gloo world of {WORLD} did not finish within {DEADLINE_S} s")
    finally:
        for p, log in procs:
            p.wait()
            log.close()
    for r, (p, _) in enumerate(procs):
        assert p.returncode == 0, (tmp_path / f"rank{r}.log").read_text()
    return [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(WORLD)]


def test_kmeans_in_a_gloo_world_of_three(tmp_path):
    x = _blobs(1003, 16, 8, 0)  # 1003 = 3 * 335 - 2: rank 2 holds padding
    fresh = _blobs(301, 16, 8, 9)
    ranks = _run_world(tmp_path, _KMEANS_MAIN, x=x, fresh=fresh)

    ref_comm = hj.Communication(jax.devices()[:WORLD])
    ref_x = hj.array(x, split=0, comm=ref_comm)
    ref = hj.cluster.KMeans(n_clusters=8, init="random", random_state=0, max_iter=30).fit(ref_x)
    want_predict = ref.predict(hj.array(fresh, split=0, comm=ref_comm)).numpy()
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got["lshape_map"], ref_x.lshape_map)
        assert tuple(got["lshape"]) == tuple(ref_comm.chunk(x.shape, 0, rank=r)[1])
        assert int(got["n_iter"]) == ref.n_iter_
        np.testing.assert_allclose(got["centers"], ref.cluster_centers_.numpy(), atol=5e-5)
        np.testing.assert_array_equal(got["labels"], ref.labels_.numpy())
        np.testing.assert_allclose(float(got["inertia"]), ref.inertia_, rtol=1e-4)
        np.testing.assert_array_equal(got["predict"], want_predict)


def _signed_like(got, want):
    """got's columns flipped to agree in sign with want's."""
    signs = np.sign(np.sum(got * want, axis=0))
    signs[signs == 0] = 1
    return got * signs


def _lowrank(m, n, rank, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((m, rank)) @ (rng.standard_normal((rank, n)) * np.linspace(3.0, 1.0, rank)[:, None])
    return (a + 0.05 * rng.standard_normal((m, n)) + 2.0).astype(np.float32)


@pytest.fixture(scope="module")
def hsvd_world(tmp_path_factory):
    """The inputs, the reference's 3-device Communication and every rank's
    results of _HSVD_MAIN."""
    rows = _lowrank(1003, 12, 6, 1)  # 1003 = 3 * 335 - 2: rank 2 holds padding
    cols = _lowrank(60, 37, 8, 2)  # 37 columns over 3 ranks: leaves of 13, 13 and 11
    fresh = _lowrank(29, 12, 6, 3)
    ranks = _run_world(tmp_path_factory.mktemp("hsvd"), _HSVD_MAIN, rows=rows, cols=cols, fresh=fresh)
    return (rows, cols, fresh), hj.Communication(jax.devices()[:WORLD]), ranks


def test_hsvd_and_pca_in_a_gloo_world_of_three(hsvd_world):
    (rows, cols, fresh), ref_comm, ranks = hsvd_world
    assert all(int(got["row_gathers"]) == 0 for got in ranks)
    # replicated decisions: the same bits of G, V and the rtol rank everywhere
    for got in ranks[1:]:
        for key in ("gram", "s", "v", "s_rt", "v_rt", "cs", "cv", "cs_rt", "cv_rt", "components"):
            np.testing.assert_array_equal(got[key], ranks[0][key], err_msg=key)

    ref_rows = hj.array(rows, split=0, comm=ref_comm)
    ref_cols = hj.array(cols, split=1, comm=ref_comm)
    want = hj.linalg.hsvd_rank(ref_rows, 5, compute_sv=True)
    want_rt = hj.linalg.hsvd_rtol(ref_rows, 0.3, compute_sv=True)
    want_c = hj.linalg.hsvd_rank(ref_cols, 4, compute_sv=True)
    want_crt = hj.linalg.hsvd_rtol(ref_cols, 0.3, compute_sv=True)
    pca = hj.decomposition.PCA(n_components=4).fit(ref_rows)
    want_t = pca.transform(hj.array(fresh, split=0, comm=ref_comm)).numpy()
    got = ranks[0]
    np.testing.assert_allclose(got["gram"], rows.astype(np.float64).T @ rows.astype(np.float64), rtol=1e-5)
    assert int(got["u_split"]) == 0 and int(got["cv_split"]) == 1
    for (u, s, v, e), (wu, ws, wv, we) in (
        ((got["u"], got["s"], got["v"], got["err"]), want),
        ((got["u_rt"], got["s_rt"], got["v_rt"], got["err_rt"]), want_rt),
        ((got["cu"], got["cs"], got["cv"], got["cerr"]), want_c),
        ((None, got["cs_rt"], got["cv_rt"], got["cerr_rt"]), want_crt),
    ):
        assert s.shape == ws.shape  # the same rank, fixed or chosen by rtol
        np.testing.assert_allclose(s, ws.numpy(), rtol=1e-4)
        np.testing.assert_allclose(_signed_like(v, wv.numpy()), wv.numpy(), atol=1e-4)
        if u is not None:
            np.testing.assert_allclose(_signed_like(u, wu.numpy()), wu.numpy(), atol=1e-4)
        np.testing.assert_allclose(float(e), float(we), atol=1e-5)
    wc = pca.components_.numpy()
    signs = np.sign(np.sum(got["components"] * wc, axis=1))
    np.testing.assert_allclose(got["components"] * signs[:, None], wc, atol=1e-4)
    np.testing.assert_allclose(got["ev"], pca.explained_variance_.numpy(), rtol=1e-4)
    np.testing.assert_allclose(got["ratio"], pca.explained_variance_ratio_.numpy(), rtol=1e-4)
    np.testing.assert_allclose(float(got["tevr"]), pca.total_explained_variance_ratio_, atol=1e-5)
    for r, rk in enumerate(ranks):
        np.testing.assert_allclose(rk["transform"] * signs[None, :], want_t, atol=1e-4, err_msg=f"rank {r}")


def test_rsvd_and_randomized_pca_in_a_gloo_world_of_three(hsvd_world):
    """rsvd of the rows (split 0, uneven) and the randomized PCA against the
    reference on 3 devices, seeded alike: the tolerances of
    tests/test_torch_rsvd.py.  Every rank computes the same factors from
    the gathered matrix and keeps its own rows of U."""
    (rows, _, fresh), ref_comm, ranks = hsvd_world
    ref_rows = hj.array(rows, split=0, comm=ref_comm)
    hj.random.seed(5)
    wu, ws, wv = (w.numpy() for w in hj.linalg.rsvd(ref_rows, 5, n_oversamples=2, power_iter=1))
    pca = hj.decomposition.PCA(n_components=4, svd_solver="randomized", random_state=7, n_oversamples=3).fit(ref_rows)
    wc = pca.components_.numpy()
    want_t = pca.transform(hj.array(fresh, split=0, comm=ref_comm)).numpy()
    for key in ("rs", "rv", "rpca_components", "rpca_s"):
        for got in ranks[1:]:
            np.testing.assert_array_equal(got[key], ranks[0][key], err_msg=key)
    for r, got in enumerate(ranks):
        assert int(got["ru_split"]) == 0
        lo, lshape, _ = ref_comm.chunk(rows.shape, 0, rank=r)
        np.testing.assert_array_equal(got["ru_local"], got["ru"][lo:lo + lshape[0]])
        np.testing.assert_allclose(got["rs"], ws, rtol=1e-4)
        np.testing.assert_allclose(_signed_like(got["ru"], wu), wu, atol=1e-3)
        np.testing.assert_allclose(_signed_like(got["rv"], wv), wv, atol=1e-3)
        np.testing.assert_allclose(got["ru"] @ np.diag(got["rs"]) @ got["rv"].T, wu @ np.diag(ws) @ wv.T,
                                   rtol=1e-3, atol=1e-3)
        signs = np.sign(np.sum(got["rpca_components"] * wc, axis=1))
        np.testing.assert_allclose(got["rpca_components"] * signs[:, None], wc, atol=1e-4)
        np.testing.assert_allclose(got["rpca_s"], pca.singular_values_.numpy(), rtol=1e-4)
        np.testing.assert_allclose(got["rpca_ev"], pca.explained_variance_.numpy(), rtol=1e-4)
        np.testing.assert_allclose(got["rpca_ratio"], pca.explained_variance_ratio_.numpy(), rtol=1e-4)
        np.testing.assert_allclose(float(got["rpca_tevr"]), pca.total_explained_variance_ratio_, atol=1e-5)
        np.testing.assert_allclose(got["rpca_transform"] * signs[None, :], want_t, atol=1e-4, err_msg=f"rank {r}")


def test_fft_along_the_split_axis_in_a_gloo_world_of_three(tmp_path, monkeypatch):
    rng = np.random.default_rng(4)
    cube = rng.standard_normal((10, 7, 8)).astype(np.float32)  # 10 rows over 3 ranks; no partner divides by 3
    sig = (rng.standard_normal((7, 12)) + 1j * rng.standard_normal((7, 12))).astype(np.complex64)
    ranks = _run_world(tmp_path, _FFT_MAIN, cube=cube, sig=sig)

    monkeypatch.setenv("HEAT_TPU_PLANAR", "1")
    ref_comm = hj.Communication(jax.devices()[:WORLD])
    want_spec = hj.fft.fftn(hj.array(cube, split=0, comm=ref_comm)).numpy()
    want_f1 = hj.fft.fft(hj.array(sig, split=0, comm=ref_comm), axis=0).numpy()
    want_r1 = hj.fft.rfft(hj.array(cube[:, :, 0], split=0, comm=ref_comm), axis=0, norm="ortho").numpy()
    truth = {"spec": np.fft.fftn(cube.astype(np.float64)), "f1": np.fft.fft(sig.astype(np.complex128), axis=0),
             "r1": np.fft.rfft(cube[:, :, 0].astype(np.float64), axis=0, norm="ortho")}

    def rel(a, b):
        return np.abs(a - b).max() / np.abs(b).max()

    for r, got in enumerate(ranks):
        assert int(got["gathers"]) == 0
        np.testing.assert_array_equal(got["splits"], [0, 0, 0])
        np.testing.assert_array_equal(got["lshapes"], [4, 3, 2])  # ceil(10/3), ceil(7/3), ceil(6/3)
        for key, want in (("spec", want_spec), ("f1", want_f1), ("r1", want_r1)):
            assert rel(got[key], want) < 5e-4, (r, key)
            assert rel(got[key], truth[key]) < 5e-4, (r, key)
        assert rel(got["back"], cube) < 5e-4


def test_attention_in_a_gloo_world_of_three(tmp_path):
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal((10, 4, 8)).astype(np.float32) for _ in range(3))  # 10 over 3: padded to 12
    q6, k6, v6 = (rng.standard_normal((11, 6, 4)).astype(np.float32) for _ in range(3))
    ranks = _run_world(tmp_path, _ATTN_MAIN, q=q, k=k, v=v, q6=q6, k6=k6, v6=v6)

    ref_comm = hj.Communication(jax.devices()[:WORLD])

    def ref(arrays, **kw):
        return hj.nn.scaled_dot_product_attention(*(hj.array(a, split=0, comm=ref_comm) for a in arrays), **kw).numpy()

    want = {"ring": ref((q, k, v), causal=True, method="ring"),
            "uly": ref((q6, k6, v6), causal=True, method="ulysses"),
            "flash": ref((q6, k6, v6), method="flash")}
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got["ring_lshape"], [4, 4, 8])
        for key, w in want.items():
            np.testing.assert_allclose(got[key], w, atol=1e-5, rtol=0, err_msg=f"rank {r} {key}")
        np.testing.assert_array_equal(got["shifted"], np.full((2, 3), (r - 1) % WORLD, np.float32))
        np.testing.assert_array_equal(got["back"], np.full((2, 3), (r + 1) % WORLD, np.float32))
        np.testing.assert_array_equal(got["partial"], np.full((2, 3), {0: 0.0, 1: 2.0, 2: 0.0}[r], np.float32))
        assert list(got["errors"]) == ["ulysses needs heads (4) divisible by the mesh size (3)",
                                      "padded sequence 13 must divide the mesh size 3"]


def _mlp():
    import flax.linen as lnn

    class MLP(lnn.Module):
        @lnn.compact
        def __call__(self, x):
            x = lnn.relu(lnn.Dense(32)(x))
            return lnn.Dense(2)(x)

    return MLP()


@pytest.fixture(scope="module")
def training_world(tmp_path_factory):
    """The inputs, the reference's initial DataParallel (3 devices) and
    every rank's results of _TRAIN_MAIN."""
    import optax

    rng = np.random.default_rng(6)
    n_true = 10  # 12 rows over 3 ranks: the last two are padding
    q, k, v, g = (rng.standard_normal((12, 4, 8)).astype(np.float32) for _ in range(4))
    q6, k6, v6, g6 = (rng.standard_normal((12, 6, 4)).astype(np.float32) for _ in range(4))
    g[n_true:] = g6[n_true:] = 0.0
    x = rng.standard_normal((2, 12, 4)).astype(np.float32)
    y = (x @ np.array([1.0, -2.0, 0.5, 3.0], np.float32) > 0).astype(np.int32)
    ref_comm = hj.Communication(jax.devices()[:WORLD])
    dp = hj.nn.DataParallel(_mlp(), comm=ref_comm, optimizer=optax.adam(1e-2))
    dp.init(jax.random.PRNGKey(0), jnp.asarray(x[0]))
    tree = jax.tree_util.tree_map(np.asarray, dp.params)["params"]
    arrays = dict(q=q, k=k, v=v, g=g, q6=q6, k6=k6, v6=v6, g6=g6, n_true=np.asarray(n_true), x=x, y=y,
                  k0=tree["Dense_0"]["kernel"], b0=tree["Dense_0"]["bias"], k1=tree["Dense_1"]["kernel"],
                  b1=tree["Dense_1"]["bias"])
    ranks = _run_world(tmp_path_factory.mktemp("train"), _TRAIN_MAIN, **arrays)
    return arrays, ref_comm, dp, ranks


def test_attention_gradients_in_a_gloo_world_of_three(training_world):
    """dQ, dK and dV of ring_attention and ulysses_attention (einsum and
    flash) on each rank's chunk against jax.grad of the JAX package's
    functions on a 3-device Communication, and psum's gradient.  A zero
    cotangent on the padded rows: the reference's Ulysses on the CPU masks
    padded keys only, the flash path isolates the padded tail
    (tests/test_torch_flash_bwd.py)."""
    arrays, ref_comm, _, ranks = training_world
    n_true = int(arrays["n_true"])

    def ref_grads(fn, names, cot, **kw):
        def loss(a, b, c):
            return jnp.sum(fn(a, b, c, comm=ref_comm, causal=True, n_true=n_true, **kw) * jnp.asarray(arrays[cot]))

        return [np.asarray(x) for x in jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(arrays[n]) for n in names))]

    want = {"ring": ref_grads(hj.nn.ring_attention, ("q", "k", "v"), "g"),
            "uly": ref_grads(hj.nn.ulysses_attention, ("q6", "k6", "v6"), "g6"),
            "flash": ref_grads(hj.nn.ulysses_attention, ("q6", "k6", "v6"), "g6", use_flash=True)}
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got["psum_grad"], [6.0, 6.0])
        assert bool(got["psum_in_place"])
        rows = slice(4 * r, 4 * r + 4)
        for name, grads in want.items():
            for key, w in zip("qkv", grads):
                np.testing.assert_allclose(got[f"{name}_d{key}"], w[rows], atol=1e-5, rtol=0,
                                           err_msg=f"rank {r} {name} d{key}")


def test_data_parallel_schedules_in_a_gloo_world_of_three(training_world):
    """The three gradient schedules give bitwise equal parameters after two
    Adam steps, and match the JAX package's DataParallel on 3 devices, as
    does the forward of each rank's rows."""
    import optax

    arrays, ref_comm, dp, ranks = training_world
    x, y = arrays["x"], arrays["y"]

    def loss_fn(pred, target):
        return optax.softmax_cross_entropy_with_integer_labels(pred, target).mean()

    want_losses = [dp.step(loss_fn, hj.array(x[s], split=0, comm=ref_comm), hj.array(y[s], split=0, comm=ref_comm))
                   for s in range(2)]
    final = jax.tree_util.tree_map(np.asarray, dp.params)["params"]
    want_forward = np.asarray(dp(jnp.asarray(x[0])))
    want = {"0.weight": final["Dense_0"]["kernel"].T, "0.bias": final["Dense_0"]["bias"],
            "2.weight": final["Dense_1"]["kernel"].T, "2.bias": final["Dense_1"]["bias"]}
    for r, got in enumerate(ranks):
        assert int(got["implicit_buckets"]) == 0 and int(got["fused_buckets"]) == 2  # one a step
        assert int(got["bucketed_buckets"]) > int(got["fused_buckets"])
        for name, w in want.items():
            for schedule in ("bucketed", "fused"):
                np.testing.assert_array_equal(got[f"{schedule}_{name}"], got[f"implicit_{name}"],
                                              err_msg=f"rank {r} {schedule} {name}")
            np.testing.assert_array_equal(got[f"implicit_{name}"], ranks[0][f"implicit_{name}"])
            np.testing.assert_allclose(got[f"implicit_{name}"], w, atol=1e-5, rtol=0, err_msg=f"rank {r} {name}")
        np.testing.assert_allclose(got["implicit_losses"], want_losses, rtol=1e-5)
        assert int(got["forward_split"]) == 0
        np.testing.assert_allclose(got["forward_local"], want_forward[4 * r:4 * r + 4], atol=1e-5, rtol=0)
        np.testing.assert_allclose(got["forward_whole"], want_forward, atol=1e-5, rtol=0)
