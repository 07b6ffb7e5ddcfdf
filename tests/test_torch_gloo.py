"""The port in a world of 3 CPU ranks (torch.distributed, gloo) against
heat_tpu on a 3-device Communication: the canonical layout of an uneven
split, the distributed KMeans fit and predict, hierarchical SVD and PCA
over rows (one Gram all-reduce) and over columns (the merge tree), rsvd
and the randomized PCA over uneven rows, the
FFT along a split axis (the pencil: tiled all-to-alls, no gather), and
sequence-parallel attention (the ring of ring_shift, Ulysses' all-to-alls)
and its gradients across the ranks, DataParallel's three gradient
schedules, and the telemetry of a world (each rank's collective
accounting, the observatory's K1 ledger, snapshots gathered by
``all_gather_object``).

One world of 3 rank processes (tests/torch_world.py) runs every slice of
the file in turn (one rank script a slice, each in a fresh namespace, the
state a slice patches put back after it), and each test checks its own
slice's arrays as soon as that slice is done.  Slice i must be done 60
(i + 1) s after the world starts, or the world is killed and the test
fails."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import heat_tpu as hj
from torch_world import WORLD, spawned

pytestmark = pytest.mark.multiprocess

# numpy's print options as a fresh process has them, the state of the gloo
# ranks: the reference's set_printoptions mirrors its options into numpy's
# and leaves them there, so a test run earlier in this process can change
# how the reference prints
_NP_PRINT_FRESH = np.get_printoptions()

_KMEANS_MAIN = r"""
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
"""

# every eigh input is recorded: the first of a split=0 fit is the summed Gram
# matrix, which must be the same bits on every rank
_HSVD_MAIN = r"""
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
"""

_FFT_MAIN = r"""
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
"""


_ATTN_MAIN = r"""
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
"""

# one world for the seeded sampling path: kmeans++ inits for seeds 0-5 (all
# gathers recorded: there must be none) and one fit, permutations split over
# the uneven rows, and the prefix sums of per-rank values
_SAMPLING_MAIN = r"""
gathered = []
_all_gather = ht.Communication.all_gather


def recording_all_gather(self, x, axis=0):
    gathered.append(tuple(x.shape))
    return _all_gather(self, x, axis)


ht.Communication.all_gather = recording_all_gather
saved = {}
x = ht.array(arrays["x"], split=0)
for seed in range(6):
    km = ht.cluster.KMeans(n_clusters=8, init="kmeans++", random_state=seed)
    km._initialize_cluster_centers(x)
    saved[f"init{seed}"] = km.cluster_centers_.larray.numpy()
    saved[f"state{seed}"] = np.asarray(ht.random.get_state()[2])
saved["init_gathers"] = np.asarray(len(gathered))
km = ht.cluster.KMeans(n_clusters=8, init="kmeans++", random_state=4, max_iter=30).fit(x)
saved.update(centers=km.cluster_centers_.numpy(), labels=km.labels_.numpy(), inertia=np.asarray(km.inertia_),
             n_iter=np.asarray(km.n_iter_), predict=km.predict(ht.array(arrays["fresh"], split=0)).numpy())
ht.random.seed(9)
perm = ht.random.permutation(1003, split=0)
rows = ht.random.permutation(x)
saved.update(perm=perm.larray.numpy(), perm_split=np.asarray(perm.split), rows=rows.larray.numpy(),
             rows_split=np.asarray(rows.split), rows_lshape_map=rows.lshape_map, state=np.asarray(ht.random.get_state()[2]))
comm = ht.get_comm()
v = torch.tensor([1.5 * (rank + 1), -float(rank * rank), 0.25])
counts = torch.tensor([(rank * 7) % 5 + 1], dtype=torch.int64)
saved.update(pscan=comm.pscan(v).numpy(), exscan=comm.exscan(v).numpy(), ipscan=comm.pscan(counts).numpy(),
             iexscan=comm.exscan(counts).numpy())
np.savez(out, **saved)
"""

# one world for the training path: gradients of sum(attention * g) by the
# rank's chunk of q, k and v (the cross-rank terms ride back through
# ring_shift's and all_to_all's backward) and of a psum; then three
# DataParallels, one per schedule, from the reference's initial parameters,
# two Adam steps each on batches of 12 rows (4 a rank), and the forward
_TRAIN_MAIN = r"""
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
"""


def _blobs(n, f, k, seed):
    rng = np.random.default_rng(seed)
    centres = rng.standard_normal((k, f)) * 6.0
    return (centres[rng.integers(0, k, n)] + rng.standard_normal((n, f))).astype(np.float32)


def _kmeans_inputs():
    return dict(x=_blobs(1003, 16, 8, 0), fresh=_blobs(301, 16, 8, 9)), None  # 1003 = 3 * 335 - 2: rank 2 holds padding


def test_kmeans_in_a_gloo_world_of_three(world):
    arrays, _ = world["kmeans"]
    x, fresh = arrays["x"], arrays["fresh"]
    ranks = world.ranks("kmeans")

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


def _hsvd_inputs():
    rows = _lowrank(1003, 12, 6, 1)  # 1003 = 3 * 335 - 2: rank 2 holds padding
    cols = _lowrank(60, 37, 8, 2)  # 37 columns over 3 ranks: leaves of 13, 13 and 11
    return dict(rows=rows, cols=cols, fresh=_lowrank(29, 12, 6, 3)), None


@pytest.fixture(scope="module")
def hsvd_world(world):
    """The inputs, the reference's 3-device Communication and every rank's
    results of _HSVD_MAIN."""
    arrays = world["hsvd"][0]
    return ((arrays["rows"], arrays["cols"], arrays["fresh"]), hj.Communication(jax.devices()[:WORLD]),
            world.ranks("hsvd"))


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


def _fft_inputs():
    rng = np.random.default_rng(4)
    cube = rng.standard_normal((10, 7, 8)).astype(np.float32)  # 10 rows over 3 ranks; no partner divides by 3
    sig = (rng.standard_normal((7, 12)) + 1j * rng.standard_normal((7, 12))).astype(np.complex64)
    return dict(cube=cube, sig=sig), None


def test_fft_along_the_split_axis_in_a_gloo_world_of_three(world, monkeypatch):
    arrays = world["fft"][0]
    cube, sig = arrays["cube"], arrays["sig"]
    ranks = world.ranks("fft")

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


def _attention_inputs():
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal((10, 4, 8)).astype(np.float32) for _ in range(3))  # 10 over 3: padded to 12
    q6, k6, v6 = (rng.standard_normal((11, 6, 4)).astype(np.float32) for _ in range(3))
    return dict(q=q, k=k, v=v, q6=q6, k6=k6, v6=v6), None


def test_attention_in_a_gloo_world_of_three(world):
    arrays = world["attention"][0]
    q, k, v, q6, k6, v6 = (arrays[n] for n in ("q", "k", "v", "q6", "k6", "v6"))
    ranks = world.ranks("attention")

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


def _training_inputs():
    """The inputs and the reference's initial DataParallel (3 devices)."""
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
    return arrays, (ref_comm, dp)


@pytest.fixture(scope="module")
def training_world(world):
    """The inputs, the reference's initial DataParallel (3 devices) and
    every rank's results of _TRAIN_MAIN."""
    arrays, (ref_comm, dp) = world["training"]
    return arrays, ref_comm, dp, world.ranks("training")


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


def _sampling_inputs():
    return dict(x=_blobs(1003, 16, 8, 5), fresh=_blobs(301, 16, 8, 6)), None  # 1003 = 3 * 335 - 2: rank 2 holds padding


@pytest.fixture(scope="module")
def sampling_world(world):
    """The points, the reference's 3-device Communication and every rank's
    results of _SAMPLING_MAIN."""
    arrays = world["sampling"][0]
    return (arrays["x"], arrays["fresh"]), hj.Communication(jax.devices()[:WORLD]), world.ranks("sampling")


def test_kmeanspp_and_permutation_in_a_gloo_world_of_three(sampling_world):
    """kmeans++ over uneven rows picks the reference's rows for seeds 0-5
    without gathering the points (psum, exscan, pmin and the row fetch), and
    fits as the reference does; a split permutation keeps each rank's chunk
    of the reference's draw."""
    (x, fresh), ref_comm, ranks = sampling_world
    ref_x = hj.array(x, split=0, comm=ref_comm)
    for seed in range(6):
        ref = hj.cluster.KMeans(n_clusters=8, init="kmeans++", random_state=seed)
        ref._initialize_cluster_centers(ref_x)
        for got in ranks:
            np.testing.assert_array_equal(got[f"init{seed}"], ref._cluster_centers.numpy(), err_msg=f"seed {seed}")
            assert int(got[f"state{seed}"]) == hj.random.get_state()[2] == 8
    ref = hj.cluster.KMeans(n_clusters=8, init="kmeans++", random_state=4, max_iter=30).fit(ref_x)
    want_predict = ref.predict(hj.array(fresh, split=0, comm=ref_comm)).numpy()
    hj.random.seed(9)
    want_perm = hj.random.permutation(1003, split=0, comm=ref_comm)
    want_rows = hj.random.permutation(ref_x)
    for r, got in enumerate(ranks):
        assert int(got["init_gathers"]) == 0
        assert int(got["n_iter"]) == ref.n_iter_
        np.testing.assert_allclose(got["centers"], ref.cluster_centers_.numpy(), atol=5e-5)
        np.testing.assert_array_equal(got["labels"], ref.labels_.numpy())
        np.testing.assert_allclose(float(got["inertia"]), ref.inertia_, rtol=1e-4)
        np.testing.assert_array_equal(got["predict"], want_predict)
        lo, lshape, _ = ref_comm.chunk((1003,), 0, rank=r)
        assert int(got["perm_split"]) == int(got["rows_split"]) == 0
        np.testing.assert_array_equal(got["perm"], want_perm.numpy()[lo:lo + lshape[0]])
        np.testing.assert_array_equal(got["rows"], want_rows.numpy()[lo:lo + lshape[0]])
        np.testing.assert_array_equal(got["rows_lshape_map"], want_rows.lshape_map)
        assert int(got["state"]) == hj.random.get_state()[2]


def test_prefix_sums_in_a_gloo_world_of_three(sampling_world):
    """pscan and exscan against the reference's Communication.pscan/exscan
    on 3 devices (log2 rounds of ppermute; zero at rank 0 when exclusive)."""
    from jax.sharding import PartitionSpec as P

    from heat_tpu.core._compat import shard_map

    _, ref_comm, ranks = sampling_world
    values = np.concatenate([[1.5 * (r + 1), -float(r * r), 0.25] for r in range(WORLD)]).astype(np.float32)
    counts = np.asarray([(r * 7) % 5 + 1 for r in range(WORLD)], dtype=np.int64)
    spec = P(ref_comm.axis_name)
    for arr, inclusive, key in ((values, True, "pscan"), (values, False, "exscan"), (counts, True, "ipscan"),
                                (counts, False, "iexscan")):
        scan = jax.jit(shard_map(lambda v, inc=inclusive: ref_comm.pscan(v, inclusive=inc), mesh=ref_comm.mesh,
                                 in_specs=(spec,), out_specs=spec))
        want = np.asarray(scan(jnp.asarray(arr))).reshape(WORLD, -1)
        for r, got in enumerate(ranks):
            assert got[key].dtype == want.dtype
            np.testing.assert_array_equal(got[key], want[r], err_msg=f"{key} on rank {r}")


# the array runtime over uneven rows and columns (10 x 7 over 3 ranks: 4, 4,
# 2 rows, 3, 3, 1 columns): resplits between every pair of splits, stepped,
# reversed, masked and index-array keys on the split axis, writes across
# ranks, halos, allclose, factories' chunks, nonzero and printing; every
# gather recorded during the basic keys
_RUNTIME_MAIN = r"""
saved = {}


def save(name, a):
    saved[name + "/local"] = a.larray.numpy() if a.dtype is not ht.bfloat16 else a.larray.float().numpy()
    saved[name + "/split"] = np.asarray(-1 if a.split is None else a.split)
    saved[name + "/lmap"] = a.lshape_map
    saved[name + "/cd"] = np.asarray(a.counts_displs() if a.split is not None else ((), ()))


base = arrays["base"]
for s in (None, 0, 1):
    for t in (None, 0, 1):
        save(f"resplit{s}{t}", ht.array(base, split=s).resplit(t))
    a = ht.array(base, split=s)
    a.resplit_(1 if s != 1 else 0)
    save(f"resplit_{s}", a)

gathers = []
for name in ("all_gather", "all_gather_varying"):
    fn = getattr(ht.Communication, name)

    def recording(self, x, *args, _fn=fn, **kw):
        gathers.append(int(x.numel()))
        return _fn(self, x, *args, **kw)

    setattr(ht.Communication, name, recording)
for split in (0, 1):
    a = ht.array(base, split=split)
    for i, key in enumerate(BASIC):
        save(f"basic{split}_{i}", a[key])
saved["basic_gathered"] = np.asarray(sum(gathers))
for split in (0, 1):
    a = ht.array(base, split=split)
    for i, key in enumerate(ADVANCED):
        save(f"adv{split}_{i}", a[key])
    mask = ht.array(base[:, 0] > 0, split=0)
    save(f"dmask{split}", a[mask])
    for i, (key, value) in enumerate(SETS):
        b = ht.array(base, split=split)
        b[key] = value
        save(f"set{split}_{i}", b)
    b = ht.array(base, split=split)
    b[1:9:3] = ht.array(np.full((3, 7), -1.0, np.float32), split=0)
    save(f"setd{split}", b)

h = ht.array(base, split=0)
h.get_halo(2)
saved["halo_prev"] = h.halo_prev.numpy() if h.halo_prev is not None else np.zeros((0,))
saved["halo_next"] = h.halo_next.numpy() if h.halo_next is not None else np.zeros((0,))
saved["with_halos"] = h.array_with_halos.numpy()
a = ht.array(base, split=0)
saved["close"] = np.asarray([ht.allclose(a, a), ht.allclose(a, a + 1e-3), ht.allclose(a, ht.array(base, split=1)),
                             ht.allclose(a, base), bool(ht.all(a > -100)), bool(ht.any(a > 100))])
save("arange", ht.arange(10, split=0))
save("linspace", ht.linspace(-1.0, 2.0, 10, split=0))
save("eye0", ht.eye((10, 7), split=0))
save("eye1", ht.eye((10, 7), split=1))
save("full", ht.full((10, 7), 2.5, split=1))
save("fromfunction", ht.fromfunction(lambda i, j: i * 7 + j, (10, 7), split=1))
save("chunks", ht.array(np.arange(2 + rank, dtype=np.int64) + 10 * rank, is_split=0))
for split in (0, 1):
    save(f"nonzero{split}", ht.nonzero(ht.array(base > 0.5, split=split)))
saved["str"] = np.asarray(str(ht.array(arrays["big"], split=0)))
saved["str_small"] = np.asarray(str(ht.array(base, split=1)))
x = ht.array(arrays["x64"], split=0)
km = ht.cluster.KMeans(n_clusters=8, init="random", random_state=0, max_iter=30).fit(x)
saved.update(centers=km.cluster_centers_.numpy(), labels=km.labels_.numpy(), inertia=np.asarray(km.inertia_),
             n_iter=np.asarray(km.n_iter_), centers_dtype=np.asarray(km.cluster_centers_.dtype.__name__))
np.savez(out, **saved)
"""

_RUNTIME_KEYS = r"""
BASIC = [slice(1, 9, 3), slice(None, None, -1), slice(8, 0, -3), 5, -1, (slice(None), 2), (Ellipsis, slice(6, 0, -2)),
         (None, slice(2, 7)), (slice(3, 3),), (slice(None), None, 1), (2, slice(None, None, 2))]
ADVANCED = [np.array([9, 0, 4, 4, 7]), np.arange(10) % 3 == 1, (slice(None), np.array([6, 0, 3])),
            (np.array([[1, 8], [3, 3]]), slice(1, 5)), (np.array([2, 5, 9]), np.array([0, 6, 3])),
            (slice(None), np.arange(7) % 2 == 0), (0, slice(None), None)]
SETS = [(slice(1, 9, 3), 7.5), (np.array([9, 0, 4]), -3.0), (np.arange(10) % 4 == 0, 1.25),
        ((slice(None), slice(6, 0, -2)), 0.5), ((5, slice(None)), np.arange(7, dtype=np.float32)),
        ((slice(None), 3), np.arange(10, dtype=np.float32))]
"""


def _runtime_inputs():
    rng = np.random.default_rng(13)
    return dict(base=rng.standard_normal((10, 7)).astype(np.float32),
                big=rng.standard_normal((1001, 5)).astype(np.float32),
                x64=_blobs(1003, 16, 8, 3).astype(np.float64)), None


@pytest.fixture(scope="module")
def runtime_world(world):
    ns = {"np": np}
    exec(_RUNTIME_KEYS, ns)
    return world["runtime"][0], ns, hj.Communication(jax.devices()[:WORLD]), world.ranks("runtime")


def _same_layout(got, r, name, want, comm):
    """Rank r's saved chunk of ``name`` is its chunk of the reference's."""
    split = want.split
    assert int(got[name + "/split"]) == (-1 if split is None else split), name
    np.testing.assert_array_equal(got[name + "/lmap"], want.lshape_map, err_msg=name)
    full = np.asarray(want.numpy())
    if split is not None:
        assert tuple(got[name + "/cd"][0]) == want.counts_displs()[0], name
        full = full[comm.chunk(want.shape, split, rank=r)[2]]
    assert got[name + "/local"].dtype == full.dtype, name
    np.testing.assert_array_equal(got[name + "/local"], full, err_msg=name)


def test_resplit_and_indexing_in_a_gloo_world_of_three(runtime_world):
    """resplit between every pair of splits, the keys on the split axis and
    the writes across ranks: each rank's chunk, lshape_map and counts_displs
    are the reference's on 3 devices; the basic keys gathered nothing."""
    arrays, ns, comm, ranks = runtime_world
    base = arrays["base"]
    for r, got in enumerate(ranks):
        for s in (None, 0, 1):
            for t in (None, 0, 1):
                _same_layout(got, r, f"resplit{s}{t}", hj.array(base, split=s, comm=comm).resplit(t), comm)
            _same_layout(got, r, f"resplit_{s}", hj.array(base, split=s, comm=comm).resplit(1 if s != 1 else 0), comm)
        assert int(got["basic_gathered"]) == 0
        for split in (0, 1):
            ref = hj.array(base, split=split, comm=comm)
            for i, key in enumerate(ns["BASIC"]):
                _same_layout(got, r, f"basic{split}_{i}", ref[key], comm)
            for i, key in enumerate(ns["ADVANCED"]):
                _same_layout(got, r, f"adv{split}_{i}", ref[key], comm)
            _same_layout(got, r, f"dmask{split}", ref[hj.array(base[:, 0] > 0, split=0, comm=comm)], comm)
            for i, (key, value) in enumerate(ns["SETS"]):
                b = hj.array(base, split=split, comm=comm)
                b[key] = value
                _same_layout(got, r, f"set{split}_{i}", b, comm)
            b = hj.array(base, split=split, comm=comm)
            b[1:9:3] = hj.array(np.full((3, 7), -1.0, np.float32), split=0, comm=comm)
            _same_layout(got, r, f"setd{split}", b, comm)


def test_halos_allclose_factories_and_printing_in_a_gloo_world_of_three(runtime_world):
    arrays, _, comm, ranks = runtime_world
    base = arrays["base"]
    ref = hj.array(base, split=0, comm=comm)
    lo = [comm.chunk(base.shape, 0, rank=r)[0] for r in range(WORLD)] + [10]
    for r, got in enumerate(ranks):
        want_prev = base[lo[r] - 2:lo[r]] if r > 0 else np.zeros((0,))
        want_next = base[lo[r + 1]:lo[r + 1] + 2] if lo[r + 1] < 10 else np.zeros((0,))
        np.testing.assert_array_equal(got["halo_prev"], want_prev)
        np.testing.assert_array_equal(got["halo_next"], want_next)
        np.testing.assert_array_equal(got["with_halos"], base[max(lo[r] - 2, 0):min(lo[r + 1] + 2, 10)])
        assert got["close"].tolist() == [hj.allclose(ref, ref), hj.allclose(ref, ref + 1e-3),
                                         hj.allclose(ref, hj.array(base, split=1, comm=comm)), hj.allclose(ref, base),
                                         bool(hj.all(ref > -100)), bool(hj.any(ref > 100))]
        _same_layout(got, r, "arange", hj.arange(10, split=0, comm=comm), comm)
        _same_layout(got, r, "linspace", hj.linspace(-1.0, 2.0, 10, split=0, comm=comm), comm)
        _same_layout(got, r, "eye0", hj.eye((10, 7), split=0, comm=comm), comm)
        _same_layout(got, r, "eye1", hj.eye((10, 7), split=1, comm=comm), comm)
        _same_layout(got, r, "full", hj.full((10, 7), 2.5, split=1, comm=comm), comm)
        _same_layout(got, r, "fromfunction", hj.fromfunction(lambda i, j: i * 7 + j, (10, 7), split=1, comm=comm),
                     comm)
        chunks = np.concatenate([np.arange(2 + q, dtype=np.int64) + 10 * q for q in range(WORLD)])
        _same_layout(got, r, "chunks", hj.array(chunks, split=0, comm=comm), comm)
        for split in (0, 1):
            _same_layout(got, r, f"nonzero{split}", hj.nonzero(hj.array(base > 0.5, split=split, comm=comm)), comm)
        with np.printoptions(**_NP_PRINT_FRESH):
            assert str(got["str"]) == str(hj.array(arrays["big"], split=0, comm=comm))
            assert str(got["str_small"]) == str(hj.array(base, split=1, comm=comm))


def test_float64_kmeans_in_a_gloo_world_of_three(runtime_world):
    """A float64 fit over uneven rows: the reference's XLA step on 3
    devices; labels bitwise, centres atol 1e-12, inertia rtol 1e-12."""
    arrays, _, comm, ranks = runtime_world
    ref = hj.cluster.KMeans(n_clusters=8, init="random", random_state=0, max_iter=30).fit(
        hj.array(arrays["x64"], split=0, comm=comm))
    for got in ranks:
        assert str(got["centers_dtype"]) == "float64" and int(got["n_iter"]) == ref.n_iter_
        np.testing.assert_allclose(got["centers"], ref.cluster_centers_.numpy(), rtol=0, atol=1e-12)
        np.testing.assert_array_equal(got["labels"], ref.labels_.numpy())
        np.testing.assert_allclose(float(got["inertia"]), ref.inertia_, rtol=1e-12)


# the ops over uneven rows and columns (10 x 7 over 3 ranks): scans and
# differences along the split axis, arg-reductions with ties and NaN on
# different ranks, var, histogram, bincount, cov, matmul of split 1 by split
# 0, and the ragged layer (a skewed target, __partitioned__, the round trip
# through from_partition_dict, an op and a reduction on the ragged array);
# every gather recorded while the ops run
_OPS_MAIN = r"""
saved = {}
gathered = {}
phase = [None]


def save(name, a):
    saved[name + "/local"] = a.larray.numpy()
    saved[name + "/split"] = np.asarray(-1 if a.split is None else a.split)
    saved[name + "/lmap"] = a.lshape_map
    saved[name + "/cd"] = np.asarray(a.counts_displs() if a.split is not None else ((), ()))


for fname in ("all_gather", "all_gather_varying"):
    fn = getattr(ht.Communication, fname)

    def recording(self, x, *args, _fn=fn, **kw):
        if phase[0] is not None:
            gathered[phase[0]] = gathered.get(phase[0], 0) + int(x.numel())
        return _fn(self, x, *args, **kw)

    setattr(ht.Communication, fname, recording)


def run(name, fn):
    phase[0] = name
    gathered.setdefault(name, 0)
    try:
        return fn()
    finally:
        phase[0] = None


base, ties, labels, weights = arrays["base"], arrays["ties"], arrays["labels"], arrays["weights"]
for split in (0, 1):
    a = ht.array(base, split=split)
    save(f"cumsum{split}", run(f"cumsum{split}", lambda: ht.cumsum(a, split)))
    save(f"cumprod{split}", run(f"cumprod{split}", lambda: ht.cumprod(a, split)))
    save(f"diff{split}", run(f"diff{split}", lambda: ht.diff(a, axis=split)))
    save(f"diff3_{split}", run(f"diff3_{split}", lambda: ht.diff(a, n=3, axis=split)))
    save(f"var{split}", run(f"var{split}", lambda: ht.var(a, axis=split)))
    save(f"varall{split}", run(f"varall{split}", lambda: ht.var(a)))
    save(f"unwrap{split}", run(f"unwrap{split}", lambda: ht.unwrap(a, axis=split)))
    save(f"gradient{split}", run(f"gradient{split}", lambda: ht.gradient(a, axis=split)))
    t = ht.array(ties, split=split)
    for name in ("argmax", "argmin"):
        save(f"{name}{split}", run(f"{name}{split}", lambda: getattr(ht, name)(t, axis=split)))
        save(f"{name}all{split}", run(f"{name}all{split}", lambda: getattr(ht, name)(t)))
    h, e = run(f"histogram{split}", lambda: ht.histogram(a, bins=5))
    save(f"histogram{split}", h)
    save(f"edges{split}", e)
    save(f"cov{split}", run(f"cov{split}", lambda: ht.cov(a, rowvar=False)))
    save(f"covrows{split}", run(f"covrows{split}", lambda: ht.cov(a)))
x = ht.array(labels, split=0)
w = ht.array(weights, split=0)
save("bincount", run("bincount", lambda: ht.bincount(x)))
save("bincount_w", run("bincount_w", lambda: ht.bincount(x, weights=w)))
A = ht.array(base, split=1)
B = ht.array(arrays["rhs"], split=0)
save("matmul10", run("matmul10", lambda: A @ B))

# the ragged layer
target = np.array([[1, 7], [7, 7], [2, 7]], np.int64)
r = ht.array(base, split=0)
r.redistribute_(target_map=target)
saved["ragged_lmap"] = r.lshape_map
saved["ragged_cd"] = np.asarray(r.counts_displs())
parts = run("partitioned", lambda: r.__partitioned__)
mine = parts["partitions"][(rank, 0)]
saved["part_data"] = np.asarray(parts["get"](mine["data"]))
saved["part_start"] = np.asarray(mine["start"])
saved["part_shape"] = np.asarray(mine["shape"])
saved["others_none"] = np.asarray(all(p["data"] is None for k, p in parts["partitions"].items() if k[0] != rank))
rebuilt = run("rebuilt", lambda: ht.from_partition_dict(parts))
save("rebuilt", rebuilt)
shifted = r + 1.0
saved["op_lmap"] = shifted.lshape_map
saved["op_rows"] = run("op_rows", lambda: shifted._ragged_layout[1]).numpy()
total = ht.sum(r, axis=0)
saved["reduced_balanced"] = np.asarray(total.is_balanced())
save("reduced", total)
r[0, 0] = -5.0  # a write: the placed rows are placed again
saved["written_rows"] = r._ragged_layout[1].numpy()
r.balance_()
saved["balanced_again"] = np.asarray(r.is_balanced())
saved["gathered_names"] = np.asarray(list(gathered))
saved["gathered_counts"] = np.asarray([gathered[k] for k in gathered])
np.savez(out, **saved)
"""


def _ops_inputs():
    rng = np.random.default_rng(21)
    base = rng.standard_normal((10, 7)).astype(np.float32) * 2
    ties = np.round(rng.standard_normal((10, 7)), 0).astype(np.float32)
    ties[[1, 6], 2] = 9.0  # the largest twice, on ranks 0 and 1
    ties[[3, 8], 4] = -9.0  # the smallest twice, on ranks 0 and 2
    ties[7, 5] = ties[9, 5] = np.nan  # NaN on rank 1 and on rank 2
    ties[2, 6] = np.nan
    arrays = dict(base=base, ties=ties, labels=rng.integers(0, 6, 41).astype(np.int64),
                  weights=rng.standard_normal(41).astype(np.float32), rhs=rng.standard_normal((7, 5)).astype(np.float32))
    return arrays, None


@pytest.fixture(scope="module")
def ops_world(world):
    return world["ops"][0], hj.Communication(jax.devices()[:WORLD]), world.ranks("ops")


def _close_layout(got, r, name, want, comm, rtol=3e-5, atol=1e-6):
    """Rank r's saved chunk of ``name`` is its chunk of the reference's
    (same split, lshape_map and counts), the values within the bounds."""
    split = want.split
    assert int(got[name + "/split"]) == (-1 if split is None else split), name
    np.testing.assert_array_equal(got[name + "/lmap"], want.lshape_map, err_msg=name)
    full = np.asarray(want.numpy())
    if split is not None:
        assert tuple(got[name + "/cd"][0]) == want.counts_displs()[0], name
        full = full[comm.chunk(want.shape, split, rank=r)[2]]
    assert got[name + "/local"].dtype == full.dtype, name
    np.testing.assert_allclose(got[name + "/local"], full, rtol=rtol, atol=atol, err_msg=name)


def test_ops_along_the_split_axis_in_a_gloo_world_of_three(ops_world):
    """Scans, differences, var, the arg-reductions (ties and NaN across
    ranks), histogram, bincount, cov and split-1-by-split-0 matmul on 3
    ranks: each rank's chunk is its chunk of the reference's on 3 devices,
    and nothing gathered the data (an arg-reduction gathers only the
    ranks' (value, index) pairs of its result)."""
    arrays, comm, ranks = ops_world
    base, ties = arrays["base"], arrays["ties"]
    for r, got in enumerate(ranks):
        gathered = dict(zip(got["gathered_names"].tolist(), got["gathered_counts"].tolist()))
        for split in (0, 1):
            a = hj.array(base, split=split, comm=comm)
            _close_layout(got, r, f"cumsum{split}", hj.cumsum(a, split), comm)
            _close_layout(got, r, f"cumprod{split}", hj.cumprod(a, split), comm, rtol=1e-4)
            _close_layout(got, r, f"diff{split}", hj.diff(a, axis=split), comm)
            _close_layout(got, r, f"diff3_{split}", hj.diff(a, n=3, axis=split), comm)
            _close_layout(got, r, f"var{split}", hj.var(a, axis=split), comm)
            _close_layout(got, r, f"varall{split}", hj.var(a), comm)
            _close_layout(got, r, f"unwrap{split}", hj.unwrap(a, axis=split), comm)
            _close_layout(got, r, f"gradient{split}", hj.gradient(a, axis=split), comm)
            t = hj.array(ties, split=split, comm=comm)
            for name in ("argmax", "argmin"):
                _same_layout(got, r, f"{name}{split}", getattr(hj, name)(t, axis=split), comm)
                _same_layout(got, r, f"{name}all{split}", getattr(hj, name)(t), comm)
                # each rank offers the bytes of one (value, index, valid)
                # triple per position of the result, and receives them from
                # the 3 ranks: the collective's result, no rows
                n_out = ties.shape[1 - split]
                assert gathered[f"{name}{split}"] == n_out * (4 + 8 + 1)
                assert gathered[f"{name}all{split}"] == 4 + 8 + 1
            want_h, want_e = hj.histogram(a, bins=5)
            _close_layout(got, r, f"edges{split}", want_e, comm)
            np.testing.assert_array_equal(got[f"histogram{split}/local"],
                                          hj.histogram(a, bins=got[f"edges{split}/local"])[0].numpy())
            _close_layout(got, r, f"cov{split}", hj.cov(a, rowvar=False), comm)
            _close_layout(got, r, f"covrows{split}", hj.cov(a), comm)
        x = hj.array(arrays["labels"], split=0, comm=comm)
        _same_layout(got, r, "bincount", hj.bincount(x), comm)
        _close_layout(got, r, "bincount_w", hj.bincount(x, weights=hj.array(arrays["weights"], split=0, comm=comm)),
                      comm)
        _close_layout(got, r, "matmul10", hj.matmul(hj.array(base, split=1, comm=comm),
                                                    hj.array(arrays["rhs"], split=0, comm=comm)), comm)
        for name, count in gathered.items():
            if not name.startswith("arg") and name != "rebuilt":
                assert count == 0, f"{name} gathered {count} elements on rank {r}"
        assert gathered["rebuilt"] == 2  # from_partition_dict: each rank's local shape, no rows


def test_ragged_layer_in_a_gloo_world_of_three(ops_world):
    """redistribute_ to a skewed map (1, 7, 2 rows), then __partitioned__:
    each rank receives its target rows (one exchange, no gather), the other
    partitions carry no data on it; from_partition_dict rebuilds the
    balanced array; an op keeps the ragged layout and its rows, a reduction
    comes back balanced, a write places the rows again."""
    arrays, comm, ranks = ops_world
    base = arrays["base"]
    starts = [0, 1, 8, 10]
    for r, got in enumerate(ranks):
        assert got["ragged_lmap"][:, 0].tolist() == [1, 7, 2]
        assert got["ragged_cd"].tolist() == [[1, 7, 2], [0, 1, 8]]
        np.testing.assert_array_equal(got["part_data"], base[starts[r]:starts[r + 1]])
        assert tuple(got["part_start"]) == (starts[r], 0) and tuple(got["part_shape"]) == (starts[r + 1] - starts[r], 7)
        assert bool(got["others_none"])
        _same_layout(got, r, "rebuilt", hj.array(base, split=0, comm=comm), comm)
        assert got["op_lmap"][:, 0].tolist() == [1, 7, 2]
        np.testing.assert_array_equal(got["op_rows"], base[starts[r]:starts[r + 1]] + 1.0)
        assert bool(got["reduced_balanced"])
        _close_layout(got, r, "reduced", hj.sum(hj.array(base, split=0, comm=comm), axis=0), comm)
        want_written = base[starts[r]:starts[r + 1]].copy()
        if r == 0:
            want_written[0, 0] = -5.0
        np.testing.assert_array_equal(got["written_rows"], want_written)
        assert bool(got["balanced_again"])
        gathered = dict(zip(got["gathered_names"].tolist(), got["gathered_counts"].tolist()))
        assert gathered["partitioned"] == 0 and gathered["op_rows"] == 0


_DISTANCES_MAIN = r"""
saved = {}
gathered = {}
phase = [None]


def save(name, a):
    saved[name + "/local"] = a.larray.numpy()
    saved[name + "/split"] = np.asarray(-1 if a.split is None else a.split)
    saved[name + "/lmap"] = a.lshape_map
    saved[name + "/cd"] = np.asarray(a.counts_displs() if a.split is not None else ((), ()))


for fname in ("all_gather", "all_gather_varying"):
    fn = getattr(ht.Communication, fname)

    def recording(self, x, *args, _fn=fn, **kw):
        if phase[0] is not None:
            gathered[phase[0]] = gathered.get(phase[0], 0) + int(x.numel())
        return _fn(self, x, *args, **kw)

    setattr(ht.Communication, fname, recording)


def run(name, fn):
    phase[0] = name
    gathered.setdefault(name, 0)
    try:
        return fn()
    finally:
        phase[0] = None


X, Y = ht.array(arrays["x"], split=0), ht.array(arrays["y"], split=0)
Xi = ht.array(arrays["xi"], split=0)
save("cdist", run("cdist", lambda: ht.spatial.cdist(X, Y)))
save("cdist_expanded", run("cdist_expanded", lambda: ht.spatial.cdist(X, Y, quadratic_expansion=True)))
save("cdist_self", run("cdist_self", lambda: ht.spatial.cdist(X)))
save("cdist_int", run("cdist_int", lambda: ht.spatial.cdist(Xi, ht.array(arrays["yi"], split=0))))
save("manhattan", run("manhattan", lambda: ht.spatial.manhattan(X, Y)))
save("manhattan_self", run("manhattan_self", lambda: ht.spatial.manhattan(X)))
save("rbf", run("rbf", lambda: ht.spatial.rbf(X, Y, sigma=1.5)))
save("rbf_self", run("rbf_self", lambda: ht.spatial.rbf(X, sigma=1.5)))
v, i = run("topk", lambda: ht.spatial.cdist_topk(X, Y, 4))
save("topk_vals", v)
save("topk_idx", i)
T = ht.array(arrays["train"], split=0)
knn = ht.classification.KNeighborsClassifier(n_neighbors=5).fit(T, ht.array(arrays["train_labels"], split=0))
save("knn", run("knn", lambda: knn.predict(ht.array(arrays["queries"], split=0))))
P = ht.array(arrays["pts"], split=0)
for name in ("KMedians", "KMedoids"):
    init = "kmedians++" if name == "KMedians" else "kmedoids++"
    est = run(name, lambda: getattr(ht.cluster, name)(n_clusters=3, init=init, random_state=1).fit(P))
    saved[name + "/centers"] = est.cluster_centers_.larray.numpy()
    saved[name + "/n_iter"] = np.asarray(est.n_iter_)
    saved[name + "/inertia"] = np.asarray(est.inertia_)
    save(name + "/labels", est.labels_)
lap = ht.graph.Laplacian(lambda z: ht.spatial.rbf(z, sigma=1.0), definition="norm_sym")
save("laplacian", run("laplacian", lambda: lap.construct(ht.array(arrays["pts"][:20], split=0))))
saved["gathered_names"] = np.asarray(list(gathered))
saved["gathered_counts"] = np.asarray([gathered[k] for k in gathered])
np.savez(out, **saved)
"""


def _distances_inputs():
    """Uneven rows (37 of X, 29 of Y: rank 2 holds padding of both), Y
    rows repeated in another rank's block (the ring's tie order), KNN
    blobs, and the 3 blobs of tests/test_ml.py cut to 119 rows."""
    rng = np.random.default_rng(31)
    x = rng.standard_normal((37, 5)).astype(np.float32)
    y = rng.standard_normal((29, 5)).astype(np.float32)
    y[[12, 25]] = y[3]  # the same row in each rank's block
    train = _blobs(301, 6, 4, 32)
    labels = np.argmin(((train[:, None, :] - train[None, :4, :]) ** 2).sum(-1), 1)  # any labelling
    c = np.array([[0.0, 0.0], [6.0, 6.0], [0.0, 7.0]], dtype=np.float32)
    pts_rng = np.random.default_rng(0)
    pts = np.concatenate([pts_rng.normal(c[i], 0.4, size=(40, 2)) for i in range(3)]).astype(np.float32)
    pts = pts[pts_rng.permutation(len(pts))][:119]
    arrays = dict(x=x, y=y, xi=rng.integers(-9, 10, (37, 5)).astype(np.int32),
                  yi=rng.integers(-9, 10, (29, 5)).astype(np.int32), train=train, train_labels=labels.astype(np.int64),
                  queries=_blobs(53, 6, 4, 33), pts=pts)
    return arrays, None


@pytest.fixture(scope="module")
def distances_world(world):
    return world["distances"][0], hj.Communication(jax.devices()[:WORLD]), world.ranks("distances")


def test_distances_and_their_estimators_in_a_gloo_world_of_three(distances_world):
    """The ring's cdist (both forms, Y split 0 and Y None, int32 input),
    manhattan and rbf, the ring-fused cdist_topk (indices equal, ties in
    the ring's visit order), KNN predict and the KMedians and KMedoids fits
    on 3 ranks: each rank's chunk is its chunk of the reference's on 3
    devices, and none gathers a row of X, Y, the labels or the points; the
    Laplacian gathers only its degree vector."""
    arrays, comm, ranks = distances_world
    X, Y = hj.array(arrays["x"], split=0, comm=comm), hj.array(arrays["y"], split=0, comm=comm)
    want = {
        "cdist": hj.spatial.cdist(X, Y),
        "cdist_expanded": hj.spatial.cdist(X, Y, quadratic_expansion=True),
        "cdist_self": hj.spatial.cdist(X),
        "cdist_int": hj.spatial.cdist(hj.array(arrays["xi"], split=0, comm=comm),
                                      hj.array(arrays["yi"], split=0, comm=comm)),
        "manhattan": hj.spatial.manhattan(X, Y),
        "manhattan_self": hj.spatial.manhattan(X),
        "rbf": hj.spatial.rbf(X, Y, sigma=1.5),
        "rbf_self": hj.spatial.rbf(X, sigma=1.5),
    }
    vals, idx = hj.spatial.cdist_topk(X, Y, 4)
    knn = hj.classification.KNeighborsClassifier(n_neighbors=5).fit(
        hj.array(arrays["train"], split=0, comm=comm), hj.array(arrays["train_labels"], split=0, comm=comm))
    predicted = knn.predict(hj.array(arrays["queries"], split=0, comm=comm))
    P = hj.array(arrays["pts"], split=0, comm=comm)
    fits = {"KMedians": hj.cluster.KMedians(n_clusters=3, init="kmedians++", random_state=1).fit(P),
            "KMedoids": hj.cluster.KMedoids(n_clusters=3, init="kmedoids++", random_state=1).fit(P)}
    lap = hj.graph.Laplacian(lambda z: hj.spatial.rbf(z, sigma=1.0), definition="norm_sym").construct(
        hj.array(arrays["pts"][:20], split=0, comm=comm))
    assert len(np.unique(idx.numpy()[:, 0])) < idx.shape[0]  # some rows tie between ranks' blocks
    for r, got in enumerate(ranks):
        gathered = dict(zip(got["gathered_names"].tolist(), got["gathered_counts"].tolist()))
        for name, w in want.items():
            rtol, atol = (1e-5, 1e-9) if name in ("cdist", "cdist_self") else (1e-4, 1e-4)
            _close_layout(got, r, name, w, comm, rtol=rtol, atol=atol)
        _close_layout(got, r, "topk_vals", vals, comm, rtol=1e-4, atol=1e-4)
        _same_layout(got, r, "topk_idx", idx, comm)
        _same_layout(got, r, "knn", predicted, comm)
        for name, fit in fits.items():
            assert int(got[name + "/n_iter"]) == fit.n_iter_
            np.testing.assert_array_equal(got[name + "/centers"], fit.cluster_centers_.numpy())
            np.testing.assert_allclose(float(got[name + "/inertia"]), fit.inertia_, rtol=1e-5)
            _same_layout(got, r, name + "/labels", fit.labels_, comm)
        # the rbf under it rounds its cross term otherwise than XLA's dot (up
        # to 1.2e-6 apart here): held to the reference test's 1e-5
        _close_layout(got, r, "laplacian", lap, comm, rtol=0, atol=1e-5)
        assert gathered.pop("laplacian") == 7  # this rank's degrees (20 rows padded to 21)
        assert all(count == 0 for count in gathered.values()), gathered


_LINALG_MAIN = r"""
saved = {}
largest = {}
phase = [None]


def save(name, a):
    saved[name + "/local"] = a.larray.numpy()
    saved[name + "/split"] = np.asarray(-1 if a.split is None else a.split)
    saved[name + "/lmap"] = a.lshape_map
    saved[name + "/cd"] = np.asarray(a.counts_displs() if a.split is not None else ((), ()))


# the largest tensor any collective of a phase hands a rank: a gather's
# result, a sum's or a broadcast's operand
for fname, factor in (("all_gather", 3), ("all_gather_varying", 3), ("psum", 1), ("bcast", 1)):
    fn = getattr(ht.Communication, fname)

    def recording(self, x, *args, _fn=fn, _factor=factor, **kw):
        if phase[0] is not None:
            largest[phase[0]] = max(largest.get(phase[0], 0), _factor * int(x.numel()))
        return _fn(self, x, *args, **kw)

    setattr(ht.Communication, fname, recording)


def run(name, fn):
    phase[0] = name
    largest.setdefault(name, 0)
    try:
        return fn()
    finally:
        phase[0] = None


for name in ("tall", "tall32"):
    q, r = run("tsqr_" + name, lambda: ht.linalg.qr(ht.array(arrays[name], split=0)))
    save("tsqr_" + name + "/Q", q)
    saved["tsqr_" + name + "/R"] = r.numpy()
for name in ("wide", "narrow"):
    q, r = run("bgs_" + name, lambda: ht.linalg.qr(ht.array(arrays[name], split=1)))
    save("bgs_" + name + "/Q", q)
    save("bgs_" + name + "/R", r)
u, s, v = run("svd", lambda: ht.linalg.svd(ht.array(arrays["tall"], split=0)))
save("svd/U", u)
saved["svd/S"], saved["svd/V"] = s.numpy(), v.numpy()
x, resid, rank, sv = run("lstsq", lambda: ht.linalg.lstsq(ht.array(arrays["tall"], split=0),
                                                          ht.array(arrays["rhs"], split=0)))
saved["lstsq/x"] = x.numpy()
saved["lstsq/rank"] = np.asarray(int(rank))
pca = run("pca", lambda: ht.decomposition.PCA(n_components=3, svd_solver="full").fit(ht.array(arrays["tall"], split=0)))
saved["pca/components"] = pca.components_.numpy()
saved["pca/sv"] = pca.singular_values_.numpy()
for n in (7, 10):
    for split in (0, 1):
        key = f"{n}_{split}"
        spd = ht.array(arrays[f"spd{n}"], split=split)
        save("chol" + key, run("chol" + key, lambda: ht.linalg.cholesky(spd)))
        g = ht.array(arrays[f"gen{n}"], split=split)
        saved["det" + key] = np.asarray(float(run("det" + key, lambda: ht.linalg.det(g))))
        save("inv" + key, run("inv" + key, lambda: ht.linalg.inv(g)))
        save("solve" + key, run("solve" + key, lambda: ht.linalg.solve(g, ht.array(arrays[f"b{n}"], split=0))))
        save("solvev" + key, run("solvev" + key, lambda: ht.linalg.solve(g, ht.array(arrays[f"b{n}"][:, 0]))))
    saved[f"det_swapped{n}"] = np.asarray(float(ht.linalg.det(ht.array(arrays[f"swapped{n}"], split=0))))
    saved[f"det_zero_row{n}"] = np.asarray(float(ht.linalg.det(ht.array(arrays[f"zero_row{n}"], split=0))))
saved["det_ties"] = np.asarray(float(ht.linalg.det(ht.array(arrays["ties"], split=0))))
saved["largest_names"] = np.asarray(list(largest))
saved["largest_sizes"] = np.asarray([largest[k] for k in largest])
np.savez(out, **saved)
"""


def _linalg_inputs():
    """Ragged extents on 3 ranks: TS-QR of 37 x 5 (rank 2 holds 2 padding
    rows), block Gram-Schmidt of 23 x 10 and 13 x 4 (rank 2 holds padding
    columns, of 13 x 4 nothing else), the factorizations at n = 7 and 10
    (n_pad 9 and 12: the identity on the padded diagonal)."""
    rng = np.random.default_rng(41)
    arrays = dict(tall=rng.standard_normal((37, 5)), tall32=rng.standard_normal((64, 8)).astype(np.float32),
                  wide=rng.standard_normal((23, 10)), narrow=rng.standard_normal((13, 4)),
                  rhs=rng.standard_normal(37))
    for n in (7, 10):
        a = rng.standard_normal((n, n))
        arrays[f"spd{n}"] = a @ a.T + n * np.eye(n)
        arrays[f"gen{n}"] = rng.standard_normal((n, n)) + 2 * np.eye(n)
        arrays[f"b{n}"] = rng.standard_normal((n, 3))
        arrays[f"swapped{n}"] = arrays[f"gen{n}"][[1, 0] + list(range(2, n))]
        arrays[f"zero_row{n}"] = arrays[f"gen{n}"].copy()
        arrays[f"zero_row{n}"][n - 2] = 0.0
    # equal pivot candidates in every panel column: the first maximal row wins
    arrays["ties"] = np.array([[1, 2, 0, 1, 3, 0, 1], [-1, 0, 3, 2, 1, 1, 0], [1, -2, 1, 0, 2, 2, 1],
                               [-1, 1, 2, 5, 0, 1, 1], [1, 2, -3, 1, 1, 0, 2], [-1, 0, 1, 1, 3, 1, 1],
                               [1, 1, 1, -2, 1, 3, 0]], dtype=np.float64)
    return arrays, None


@pytest.fixture(scope="module")
def linalg_world(world):
    return world["linalg"][0], hj.Communication(jax.devices()[:WORLD]), world.ranks("linalg")


_TELEMETRY_MAIN = r"""
from heat_tpu_torch import telemetry as tel
from heat_tpu_torch.core import kernels
from heat_tpu_torch.telemetry import observatory

tel.reset_all()
observatory.set_sync_every(1)


def counts():
    snap = tel.snapshot()
    return snap.get("comm.calls.psum", 0), snap.get("comm.bytes.psum", 0)


x = ht.array(arrays["x"], split=0)
km = ht.cluster.KMeans(n_clusters=4, init="random", random_state=0, max_iter=10).fit(x)
fit = counts()
rows = [r for r in observatory.ledger_report() if "(kernel, lloyd_step," in r["key"]]
kernels.lloyd_update(x, km.cluster_centers_.larray)
step = counts()
ht.get_comm().psum(torch.arange(6, dtype=torch.float32) + rank)
one = counts()
snaps = tel.gather_snapshots()
merged = tel.merge_snapshots(snaps, publish=False)["merged"]["comm.calls.psum"]["per_worker"]
np.savez(out, fit=np.asarray(fit), step=np.asarray(step), one=np.asarray(one), n_iter=np.asarray(km.n_iter_),
         ledger=np.asarray([len(rows), rows[0]["calls"], rows[0]["sync_samples"]]),
         gathered=np.asarray([s["process_index"] for s in snaps]),
         gathered_calls=np.asarray([s["metrics"]["comm.calls.psum"] for s in snaps]),
         merged=np.asarray([merged[str(i)] for i in range(len(snaps))]))
"""


def _telemetry_inputs():
    return dict(x=_blobs(301, 6, 4, 5)), None


def test_telemetry_of_a_gloo_world_of_three(world):
    """Every rank counts the same psums (the Lloyd step's packed partial
    sums, k f + k + 1 float64 values x 3 participants, one a K1 launch),
    notes each Lloyd step's K1 launch in its ledger, and gathers every rank's snapshot
    in rank order by one all_gather_object."""
    ranks = world.ranks("telemetry")
    k, f = 4, 6
    lloyd_bytes = (k * f + k + 1) * 8 * WORLD
    for got in ranks:
        n_iter = int(got["n_iter"])
        assert got["ledger"].tolist() == [1, n_iter, n_iter]
        assert got["fit"][0] >= n_iter + 1 and got["fit"][1] >= (n_iter + 1) * lloyd_bytes
        assert (got["step"] - got["fit"]).tolist() == [1, lloyd_bytes]
        assert (got["one"] - got["step"]).tolist() == [1, 6 * 4 * WORLD]
        assert got["gathered"].tolist() == list(range(WORLD))
        assert got["gathered_calls"].tolist() == [got["one"][0]] * WORLD == got["merged"].tolist()
    assert len({tuple(got["one"].tolist()) for got in ranks}) == 1


# each slice: its rank script and the function that makes its inputs (and
# the reference's objects its tests go on with)
_SLICES = {
    "kmeans": (_KMEANS_MAIN, _kmeans_inputs),
    "hsvd": (_HSVD_MAIN, _hsvd_inputs),
    "fft": (_FFT_MAIN, _fft_inputs),
    "attention": (_ATTN_MAIN, _attention_inputs),
    "training": (_TRAIN_MAIN, _training_inputs),
    "sampling": (_SAMPLING_MAIN, _sampling_inputs),
    "runtime": (_RUNTIME_KEYS + _RUNTIME_MAIN, _runtime_inputs),
    "ops": (_OPS_MAIN, _ops_inputs),
    "distances": (_DISTANCES_MAIN, _distances_inputs),
    "linalg": (_LINALG_MAIN, _linalg_inputs),
    "telemetry": (_TELEMETRY_MAIN, _telemetry_inputs),
}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """One world for the module, its slices run in turn: each slice's
    inputs, the reference's objects made with them and every rank's
    results, through :class:`torch_world.World`."""
    with spawned(tmp_path_factory.mktemp("world"), _SLICES) as w:
        yield w


def _gathered_local(ranks, name):
    return np.concatenate([got[name + "/local"] for got in ranks], axis=int(ranks[0][name + "/split"]))


def test_linalg_in_a_gloo_world_of_three(linalg_world):
    """TS-QR, block Gram-Schmidt, the TS-QR svd, lstsq and full PCA, and
    the distributed Cholesky, LU determinant (a row swap, a zero row,
    pivot ties), inverse and solve at ragged extents on 3 ranks, against the
    reference on 3 devices: each rank's chunk is its chunk of the
    reference's (split and lshape_map), the values within the reference
    tests' float64 bounds (QR 1e-10, factorizations rtol 1e-8), and no
    collective hands a rank a tensor as large as the matrix."""
    arrays, comm, ranks = linalg_world
    for name, tol in (("tall", 1e-10), ("tall32", 1e-4)):
        a = arrays[name]
        want = hj.qr(hj.array(a, split=0, comm=comm))
        q = _gathered_local(ranks, f"tsqr_{name}/Q")
        for got in ranks:
            _same_layout_meta(got, f"tsqr_{name}/Q", want.Q)
            np.testing.assert_allclose(np.abs(got[f"tsqr_{name}/R"]), np.abs(want.R.numpy()), rtol=tol, atol=tol)
        np.testing.assert_allclose(q @ ranks[0][f"tsqr_{name}/R"], a, rtol=tol, atol=tol)
        np.testing.assert_allclose(q.T @ q, np.eye(a.shape[1]), atol=tol)
    for name in ("wide", "narrow"):
        a = arrays[name]
        want = hj.qr(hj.array(a, split=1, comm=comm))
        q, r = _gathered_local(ranks, f"bgs_{name}/Q"), _gathered_local(ranks, f"bgs_{name}/R")
        for got in ranks:
            _same_layout_meta(got, f"bgs_{name}/Q", want.Q)
            _same_layout_meta(got, f"bgs_{name}/R", want.R)
        np.testing.assert_allclose(q @ r, a, atol=1e-10)
        np.testing.assert_allclose(q.T @ q, np.eye(a.shape[1]), atol=1e-10)
        np.testing.assert_allclose(np.tril(r, -1), 0.0, atol=1e-10)
        np.testing.assert_allclose(np.abs(r), np.abs(want.R.numpy()), atol=1e-10)
    tall = hj.array(arrays["tall"], split=0, comm=comm)
    ws = hj.svd(tall)
    u = _gathered_local(ranks, "svd/U")
    np.testing.assert_allclose(u @ np.diag(ranks[0]["svd/S"]) @ ranks[0]["svd/V"].T, arrays["tall"], atol=1e-10)
    np.testing.assert_allclose(ranks[0]["svd/S"], ws.S.numpy(), rtol=1e-10)
    wx = hj.linalg.lstsq(tall, hj.array(arrays["rhs"], split=0, comm=comm))
    wp = hj.decomposition.PCA(n_components=3, svd_solver="full").fit(tall)
    for got in ranks:
        np.testing.assert_allclose(got["lstsq/x"], wx[0].numpy(), rtol=1e-8)
        assert int(got["lstsq/rank"]) == 5
        np.testing.assert_allclose(got["pca/sv"], wp.singular_values_.numpy(), rtol=1e-10)
        np.testing.assert_allclose(np.abs(got["pca/components"]), np.abs(wp.components_.numpy()), atol=1e-10)
    for n in (7, 10):
        for split in (0, 1):
            key = f"{n}_{split}"
            spd = hj.array(arrays[f"spd{n}"], split=split, comm=comm)
            g = hj.array(arrays[f"gen{n}"], split=split, comm=comm)
            b = hj.array(arrays[f"b{n}"], split=0, comm=comm)
            for r, got in enumerate(ranks):
                _close_layout(got, r, "chol" + key, hj.linalg.cholesky(spd), comm, rtol=1e-8, atol=1e-8)
                np.testing.assert_allclose(float(got["det" + key]), float(hj.linalg.det(g)), rtol=1e-8)
                _close_layout(got, r, "inv" + key, hj.linalg.inv(g), comm, rtol=1e-8, atol=1e-9)
                _close_layout(got, r, "solve" + key, hj.linalg.solve(g, b), comm, rtol=1e-8, atol=1e-9)
            np.testing.assert_allclose(_gathered_local(ranks, "chol" + key), np.linalg.cholesky(arrays[f"spd{n}"]),
                                       rtol=1e-8, atol=1e-8)
            xv = np.concatenate([got["solvev" + key + "/local"] for got in ranks])
            np.testing.assert_allclose(xv, np.linalg.solve(arrays[f"gen{n}"], arrays[f"b{n}"][:, 0]), rtol=1e-8,
                                       atol=1e-9)
        want_det = np.linalg.det(arrays[f"gen{n}"])
        for got in ranks:
            np.testing.assert_allclose(float(got[f"det_swapped{n}"]), -want_det, rtol=1e-8)
            assert float(got[f"det_zero_row{n}"]) == 0.0
    want_ties = float(hj.linalg.det(hj.array(arrays["ties"], split=0, comm=comm)))
    for got in ranks:
        assert np.sign(float(got["det_ties"])) == np.sign(want_ties) == np.sign(np.linalg.det(arrays["ties"]))
        np.testing.assert_allclose(float(got["det_ties"]), want_ties, rtol=1e-10)
        sizes = dict(zip(got["largest_names"].tolist(), got["largest_sizes"].tolist()))
        for name, size in sizes.items():
            n = re.fullmatch(r"[a-z]+(\d+)_[01]", name)
            whole = int(n.group(1)) ** 2 if n is not None else {"tsqr_tall": 37 * 5, "tsqr_tall32": 64 * 8, "bgs_wide": 23 * 10,
                                                   "bgs_narrow": 13 * 4, "svd": 37 * 5, "lstsq": 37 * 5,
                                                   "pca": 37 * 5}[name]
            assert size < whole, f"{name} handed a rank {size} elements of a {whole}-element matrix"


def _same_layout_meta(got, name, want):
    assert int(got[name + "/split"]) == (-1 if want.split is None else want.split), name
    np.testing.assert_array_equal(got[name + "/lmap"], want.lshape_map, err_msg=name)
