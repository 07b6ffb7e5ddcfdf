"""The port's batch-parallel clusterers, GaussianNB, Lasso, Spectral, the
``is_*`` predicates, ``convolve`` with a split kernel and every napi call
of tests/torch_napi_cases.py in a world of 3 CPU ranks (torch.distributed,
gloo) against heat_tpu on a 3-device Communication.

BatchParallelKMeans/KMedians cluster p = 3 batches (centres within atol
5e-5, labels bitwise); GaussianNB and Lasso fit uneven split=0 chunks (301
rows: 101, 101, 99) with one all-reduce per sum; Spectral's labels are the
reference's; ``convolve`` streams a split kernel one rank's chunk a round;
each napi result has the reference's split and each rank the reference's
chunk of it.  Every all-gather is recorded: amax, amin, ptp and
count_nonzero gather nothing (a reduction of each rank's rows and one
all-reduce), the other napi calls gather the dense view as the reference
reads it.

Each napi case is a test of its own (``test_napi_call_splits_and_chunks_as_the_reference``).
The rank script is the one slice of a world of 3 rank processes
(tests/torch_world.py), which must finish it within 90 s."""

import jax
import numpy as np
import pytest

import heat_tpu as hj
from torch_napi_cases import ONE
from torch_world import WORLD, spawned

pytestmark = pytest.mark.multiprocess

DEADLINE_S = 90.0
ROW_LOCAL = ("amax", "amin", "ptp", "count_nonzero")

_MAIN = r"""
from torch_napi_cases import ONE

arrays = dict(arrays)
saved, gathered, phase = {}, {}, [None]
for fname in ("all_gather", "all_gather_varying"):
    _fn = getattr(ht.Communication, fname)

    def recording(self, x, *args, _fn=_fn, **kw):
        if phase[0] is not None:
            gathered[phase[0]] = gathered.get(phase[0], 0) + int(x.numel()) * x.element_size()
        return _fn(self, x, *args, **kw)

    setattr(ht.Communication, fname, recording)


def keep(name, res):
    if isinstance(res, (tuple, list)):
        for i, r in enumerate(res):
            keep(f"{name}/{i}", r)
        return
    if not isinstance(res, ht.DNDarray):
        saved[name] = np.asarray(res)
        saved[name + "/split"] = np.asarray(-2)
        return
    saved[name] = res.numpy()
    saved[name + "/split"] = np.asarray(-1 if res.split is None else res.split)
    saved[name + "/local"] = res.larray.numpy()


def run(name, fn):
    phase[0] = name
    gathered[name] = 0
    try:
        res = fn()
    except Exception as e:
        saved[name + "/raises"] = np.asarray(type(e).__name__)
        return
    finally:
        phase[0] = None
    keep(name, res)


for key in [k for k in arrays if k.startswith("napi_")]:
    for split in ((0, 1) if key == "napi_float32" else (0,)):
        x = ht.array(arrays[key], split=split)
        for name, call in ((n, c) for n, c in ONE.items() if key == "napi_float32" or n.startswith("nan")):
            run(f"{name}|{key}|{split}", lambda: call(ht, x))

for mode in ("full", "same", "valid"):
    for ssplit in (None, 0):
        sig, ker = ht.array(arrays["signal"], split=ssplit), ht.array(arrays["kernel"], split=0)
        run(f"convolve|{mode}|{ssplit}", lambda: ht.convolve(sig, ker, mode=mode))
run("convolve|int", lambda: ht.convolve(ht.array(arrays["isignal"], split=0), ht.array(arrays["ikernel"], split=0),
                                        mode="same"))

pts = ht.array(arrays["blobs"], split=0)
for cls in ("BatchParallelKMeans", "BatchParallelKMedians"):
    est = getattr(ht.cluster, cls)(n_clusters=3, random_state=7).fit(pts)
    keep(cls + "/centres", est.cluster_centers_)
    keep(cls + "/labels", est.labels_)

x, y = ht.array(arrays["nb_x"], split=0), ht.array(arrays["nb_y"], split=0)
nb = ht.naive_bayes.GaussianNB().fit(x, y)
for attr in ("theta_", "var_", "class_count_", "classes_"):
    keep("nb/" + attr, getattr(nb, attr))
keep("nb/predict", nb.predict(x))
keep("nb/proba", nb.predict_proba(x))
nb.partial_fit(ht.array(arrays["nb_x"][:50], split=0), ht.array(arrays["nb_y"][:50], split=0))
keep("nb/partial_var", nb.var_)

lasso = ht.regression.Lasso(lam=0.5, max_iter=40).fit(ht.array(arrays["l_x"], split=0),
                                                      ht.array(arrays["l_y"], split=0))
keep("lasso/theta", lasso.theta)
saved["lasso/n_iter"] = np.asarray(lasso.n_iter)
keep("lasso/predict", lasso.predict(ht.array(arrays["l_x"], split=0)))

ht.random.seed(0)
sp = ht.cluster.Spectral(n_clusters=3, gamma=0.5, n_lanczos=30)
keep("spectral/labels", sp.fit_predict(ht.array(arrays["sp_x"], split=0)))
saved["predicates"] = np.asarray([getattr(ht, p)(e) for e in (sp, nb, lasso, ht.preprocessing.StandardScaler())
                                  for p in ("is_classifier", "is_estimator", "is_clusterer", "is_regressor",
                                            "is_transformer")])

saved["gather_names"] = np.asarray(list(gathered))
saved["gather_bytes"] = np.asarray([gathered[k] for k in gathered])
np.savez(out, **saved)
"""


def _napi_input(dtype, nans):
    a = (np.random.default_rng(70).standard_normal((7, 5)) * 2).astype(dtype)
    a[3] = a[1]
    if nans:
        a[0, 1] = a[4, 3] = np.nan
    return a


def _names(key):
    """Every case on float32 values (split 0 and 1), the NaN family also on
    float64 values with NaNs (split 0): the values of every type are the
    world of one's to check (tests/test_torch_napi.py)."""
    return [n for n in ONE if key == "napi_float32" or n.startswith("nan")]


def _inputs():
    rng = np.random.default_rng(71)
    arrays = {"napi_float32": _napi_input("float32", False),
              "napi_nan64": _napi_input("float64", True)}
    arrays["signal"] = rng.standard_normal(31).astype(np.float32)
    arrays["kernel"] = rng.standard_normal(7).astype(np.float32)
    arrays["isignal"] = rng.integers(-5, 6, 20).astype(np.int32)
    arrays["ikernel"] = rng.integers(-3, 4, 5).astype(np.int32)
    centres = rng.standard_normal((3, 4)) * 6.0
    arrays["blobs"] = (centres[rng.integers(0, 3, 1000)] + rng.standard_normal((1000, 4))).astype(np.float32)
    labels = rng.integers(0, 3, 301)
    arrays["nb_x"] = (rng.standard_normal((301, 5)) * 0.5 + labels[:, None]).astype(np.float32)
    arrays["nb_y"] = labels.astype(np.int32)
    w = rng.standard_normal(6)
    w[2] = 0.0
    arrays["l_x"] = rng.standard_normal((301, 6)).astype(np.float32)
    arrays["l_y"] = (arrays["l_x"] @ w + 0.5).astype(np.float32)
    blobs = np.concatenate([rng.normal(-4, 0.6, (40, 2)), rng.normal(0, 0.6, (40, 2)),
                            rng.normal(4, 0.6, (40, 2))]).astype(np.float32)
    arrays["sp_x"] = rng.permutation(blobs)
    return arrays, None


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The inputs, the reference's 3-device Communication and every rank's
    results."""
    with spawned(tmp_path_factory.mktemp("ml_napi"), {"ml_napi": (_MAIN, _inputs)}, DEADLINE_S) as w:
        ranks = w.ranks("ml_napi")
    return w["ml_napi"][0], hj.Communication(jax.devices()[:WORLD]), ranks


def _gathered(ranks, name):
    axis = int(ranks[0][name + "/split"])
    if axis < 0:
        for got in ranks:
            np.testing.assert_array_equal(got[name + "/local"], got[name])
        return ranks[0][name]
    return np.concatenate([got[name + "/local"] for got in ranks], axis=axis)


def _same(ranks, name, want, rtol=None, atol=None):
    """Every rank's result is the reference's: its split, its own chunk of
    the reference's layout, its values (bitwise for integers and bools,
    else within rtol and atol, by default the dtype's bounds); sequences
    element by element."""
    if isinstance(want, (tuple, list)):
        for i, w in enumerate(want):
            _same(ranks, f"{name}/{i}", w, rtol, atol)
        return
    if not isinstance(want, hj.DNDarray):
        for got in ranks:
            np.testing.assert_allclose(got[name], np.asarray(want), rtol=rtol or 1e-6, err_msg=name)
        return
    wsplit = -1 if want.split is None else want.split
    w = np.asarray(want.numpy())
    for r, got in enumerate(ranks):
        assert int(got[name + "/split"]) == wsplit, (name, int(got[name + "/split"]), wsplit)
        assert got[name].dtype == w.dtype and got[name].shape == w.shape, (name, got[name].dtype, w.dtype)
        if wsplit >= 0:
            assert got[name + "/local"].shape[wsplit] == want.lshape_map[r][wsplit], name
    whole = _gathered(ranks, name)
    if w.dtype.kind in "biu":
        np.testing.assert_array_equal(whole, w, err_msg=name)
    else:
        r, a = (1e-12, 1e-12) if w.dtype in (np.float64, np.complex128) else (3e-5, 1e-6)
        np.testing.assert_allclose(whole, w, rtol=rtol if rtol is not None else r,
                                   atol=atol if atol is not None else a, err_msg=name)


#: every napi case of tests/torch_napi_cases.py as ``name|key|split``
CASES = [f"{name}|{key}|{split}" for key in ("napi_float32", "napi_nan64")
         for split in ((0, 1) if key == "napi_float32" else (0,)) for name in _names(key)]


@pytest.mark.parametrize("tag", CASES)
def test_napi_call_splits_and_chunks_as_the_reference(world, tag):
    arrays, comm, ranks = world
    name, key, split = tag.split("|")
    x = hj.array(arrays[key], split=int(split), comm=comm)
    try:
        want = ONE[name](hj, x)
    except Exception as e:
        for got in ranks:
            assert str(got[tag + "/raises"]) == type(e).__name__, tag
        return
    products = name.split("_")[0] in ("corrcoef", "inner", "tensordot", "einsum")
    kw = {"rtol": 1e-10, "atol": 1e-10} if products and key == "napi_nan64" else {}
    _same(ranks, tag, want, **kw)


def test_every_napi_call_splits_and_chunks_as_the_reference(world):
    """Every case ran on every rank (each is held against the reference by
    test_napi_call_splits_and_chunks_as_the_reference), and more than 200
    of them gave a result."""
    _, _, ranks = world
    for got in ranks:
        assert all(tag in got or tag + "/0" in got or tag + "/raises" in got for tag in CASES)
    assert sum(tag + "/raises" not in ranks[0] for tag in CASES) > 200


def test_row_local_calls_gather_nothing_and_the_rest_gather(world):
    _, _, ranks = world
    for got in ranks:
        sizes = dict(zip(got["gather_names"].tolist(), got["gather_bytes"].tolist()))
        for tag, size in sizes.items():
            name, key, split = tag.split("|") if tag.count("|") == 2 else (tag, "", "")
            if name.split("_")[0] in ("amax", "amin") or name.startswith(ROW_LOCAL):
                assert size == 0, f"{tag} gathered {size} bytes"
        for name in ("argsort", "nanmedian_axis", "quantile_axis", "kron", "correlate", "histogramdd"):
            assert sizes[f"{name}|napi_float32|0"] > 0, name


def test_convolve_streams_a_split_kernel_as_the_reference(world):
    arrays, comm, ranks = world
    ker = hj.array(arrays["kernel"], split=0, comm=comm)
    for mode in ("full", "same", "valid"):
        for ssplit in (None, 0):
            want = hj.convolve(hj.array(arrays["signal"], split=ssplit, comm=comm), ker, mode=mode)
            _same(ranks, f"convolve|{mode}|{ssplit}", want, rtol=1e-6, atol=1e-6)
    want = hj.convolve(hj.array(arrays["isignal"], split=0, comm=comm),
                       hj.array(arrays["ikernel"], split=0, comm=comm), mode="same")
    _same(ranks, "convolve|int", want)


def test_estimators_match_the_reference_on_three_devices(world):
    arrays, comm, ranks = world
    pts = hj.array(arrays["blobs"], split=0, comm=comm)
    for cls in ("BatchParallelKMeans", "BatchParallelKMedians"):
        est = getattr(hj.cluster, cls)(n_clusters=3, random_state=7).fit(pts)
        _same(ranks, cls + "/centres", est.cluster_centers_, rtol=0, atol=5e-5)
        _same(ranks, cls + "/labels", est.labels_)
    x, y = hj.array(arrays["nb_x"], split=0, comm=comm), hj.array(arrays["nb_y"], split=0, comm=comm)
    nb = hj.naive_bayes.GaussianNB().fit(x, y)
    for attr in ("theta_", "var_"):  # atol: means near 0 of values of scale 1
        _same(ranks, "nb/" + attr, getattr(nb, attr), rtol=1e-5, atol=1e-6)
    _same(ranks, "nb/class_count_", nb.class_count_, rtol=0, atol=0)
    _same(ranks, "nb/classes_", nb.classes_)
    _same(ranks, "nb/predict", nb.predict(x))
    _same(ranks, "nb/proba", nb.predict_proba(x), atol=1e-5)
    nb.partial_fit(hj.array(arrays["nb_x"][:50], split=0, comm=comm), hj.array(arrays["nb_y"][:50], split=0,
                                                                             comm=comm))
    _same(ranks, "nb/partial_var", nb.var_, rtol=1e-5, atol=1e-6)
    lx = hj.array(arrays["l_x"], split=0, comm=comm)
    lasso = hj.regression.Lasso(lam=0.5, max_iter=40).fit(lx, hj.array(arrays["l_y"], split=0, comm=comm))
    _same(ranks, "lasso/theta", lasso.theta, rtol=0, atol=1e-5)
    assert all(int(got["lasso/n_iter"]) == lasso.n_iter for got in ranks)
    _same(ranks, "lasso/predict", lasso.predict(lx), rtol=1e-5, atol=1e-5)
    hj.random.seed(0)
    sp = hj.cluster.Spectral(n_clusters=3, gamma=0.5, n_lanczos=30)
    _same(ranks, "spectral/labels", sp.fit_predict(hj.array(arrays["sp_x"], split=0, comm=comm)))
    want = [getattr(hj, p)(e) for e in (sp, nb, lasso, hj.preprocessing.StandardScaler())
            for p in ("is_classifier", "is_estimator", "is_clusterer", "is_regressor", "is_transformer")]
    for got in ranks:
        np.testing.assert_array_equal(got["predicates"], want)
