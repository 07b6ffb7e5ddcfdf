"""The port's resumable fits (core/base.py::resumable_fit_loop and the
estimators on it: KMeans, KMedians, KMedoids, Lasso, and PCA's stage
checkpoints with the hierarchical and the full solver) against themselves
and against the JAX package's, in one process (a world of one; the
reference on the suite's 8 devices).

Bitwise within the port: the chunked fit equals the plain fit, and a fit
stopped at a chunk boundary by a fault plan, or by the preemption gate, then
resumed from its checkpoint equals the uninterrupted fit (centres, labels,
theta, components, n_iter, inertia).  Against the reference, each
estimator's existing parity tolerance: KMeans centres atol 5e-5, labels
equal, inertia rtol 1e-4 (tests/test_torch_kmeans.py); KMedians and
KMedoids centres and labels equal, inertia rtol 1e-5
(tests/test_torch_kmedians_knn.py); Lasso theta atol 1e-5
(tests/test_torch_naive_bayes_lasso.py); PCA components atol 1e-4 up to a
sign per component, singular values rtol 1e-4 (tests/test_torch_pca.py);
n_iter equal everywhere.  The same tolerances hold a fit the port resumed
from a step the JAX package wrote part-way."""

import os

import numpy as np
import pytest
import torch

import heat_tpu as hj
import heat_tpu_torch as ht
from heat_tpu import resilience as hrz
from heat_tpu.core import base as ref_base
from heat_tpu_torch import resilience as rz
from heat_tpu_torch.core import base, preempt
from heat_tpu_torch.telemetry import metrics


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    ht.use_device("cpu")
    monkeypatch.setenv("HEAT_TPU_RETRY_NO_SLEEP", "1")


def _blobs(n=300, f=5, k=4, seed=7, spread=2.0):
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((k, f)) * spread
    return (c[rng.integers(0, k, n)] + rng.standard_normal((n, f))).astype(np.float32)


def _small_blobs():
    """tests/test_ml.py's blobs."""
    rng = np.random.default_rng(0)
    c = np.array([[0.0, 0.0], [6.0, 6.0], [0.0, 7.0]], dtype=np.float32)
    pts = np.concatenate([rng.normal(c[i], 0.4, size=(40, 2)) for i in range(3)]).astype(np.float32)
    return pts[rng.permutation(len(pts))]


def _regression(n=200, f=6, seed=0):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal(f)
    w[[1, 4]] = 0.0
    x = rng.standard_normal((n, f))
    y = x @ w + 0.5 + 0.01 * rng.standard_normal(n)
    return x.astype(np.float32), y.astype(np.float32)


def _pca_data():
    rng = np.random.default_rng(3)
    basis = rng.standard_normal((3, 10)).astype(np.float32)
    coef = rng.standard_normal((200, 3)).astype(np.float32)
    return (coef @ basis + 0.01 * rng.standard_normal((200, 10))).astype(np.float32)


def _clusterer(name, params):
    def fit(m, **kw):
        return getattr(m.cluster, name)(**params, **kw).fit(m.array(DATA[name], split=0))

    return fit


DATA = {"KMeans": _blobs(), "KMedians": _small_blobs(), "KMedoids": _small_blobs()}
X_REG, Y_REG = _regression()
X_PCA = _pca_data()

#: name -> (fit(package, **resume kwargs), its fault site, checkpoint_every, the boundary a fault stops it at)
CASES = {
    "kmeans": (_clusterer("KMeans", dict(n_clusters=4, init="random", max_iter=40, tol=1e-5, random_state=3)),
               "kmeans.iter", 2, 2),
    "kmedians": (_clusterer("KMedians", dict(n_clusters=3, init="random", random_state=1)), "kmedians.iter", 2, 1),
    "kmedoids": (_clusterer("KMedoids", dict(n_clusters=3, init="random", random_state=3)), "kmedoids.iter", 2, 1),
    "lasso": (lambda m, **kw: m.regression.Lasso(lam=1.0, max_iter=50, **kw).fit(
        m.array(X_REG, split=0), m.array(Y_REG, split=0)), "lasso.iter", 2, 1),
    "pca_hierarchical": (lambda m, **kw: m.decomposition.PCA(n_components=3, svd_solver="hierarchical", **kw).fit(
        m.array(X_PCA, split=0)), "pca.stage", 1, 1),
    "pca_full": (lambda m, **kw: m.decomposition.PCA(n_components=3, svd_solver="full", **kw).fit(
        m.array(X_PCA, split=0)), "pca.stage", 1, 1),
}


def _result(est):
    """The fitted arrays and scalars of an estimator of either package."""
    if hasattr(est, "cluster_centers_"):
        return {"centers": est.cluster_centers_.numpy(), "labels": est.labels_.numpy(),
                "inertia": float(est.inertia_), "n_iter": int(est.n_iter_)}
    if hasattr(est, "theta"):
        return {"theta": np.asarray(est.theta.numpy()), "n_iter": int(est.n_iter)}
    return {"components": np.asarray(est.components_.numpy()), "singular": np.asarray(est.singular_values_.numpy()),
            "mean": np.asarray(est.mean_.numpy()), "tevr": float(est.total_explained_variance_ratio_),
            "n": int(est.n_components_)}


def _bitwise(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert np.asarray(a[k]).tobytes() == np.asarray(b[k]).tobytes(), k


def _parity(mine, theirs):
    if "centers" in mine:
        assert mine["n_iter"] == theirs["n_iter"]
        np.testing.assert_array_equal(mine["labels"], theirs["labels"])
        if mine["centers"].shape[0] == 4:  # KMeans
            np.testing.assert_allclose(mine["centers"], theirs["centers"], atol=5e-5)
            np.testing.assert_allclose(mine["inertia"], theirs["inertia"], rtol=1e-4)
        else:
            np.testing.assert_array_equal(mine["centers"], theirs["centers"])
            np.testing.assert_allclose(mine["inertia"], theirs["inertia"], rtol=1e-5)
    elif "theta" in mine:
        assert mine["n_iter"] == theirs["n_iter"]
        np.testing.assert_allclose(mine["theta"], theirs["theta"], atol=1e-5)
    else:
        assert mine["n"] == theirs["n"]
        s = np.sign(np.sum(mine["components"] * theirs["components"], axis=1))
        np.testing.assert_allclose(mine["components"] * s[:, None], theirs["components"], atol=1e-4)
        np.testing.assert_allclose(mine["singular"], theirs["singular"], rtol=1e-4)
        np.testing.assert_allclose(mine["mean"], theirs["mean"], atol=1e-6)


@pytest.mark.parametrize("name", list(CASES))
def test_chunked_faulted_and_resumed_fits(name, tmp_path):
    """Bitwise in the port: plain == chunked == stopped at a boundary and
    resumed; against the JAX package's chunked fit within its tolerance."""
    fit, site, every, stop_at = CASES[name]
    plain = _result(fit(ht))
    chunked = _result(fit(ht, checkpoint_every=every, checkpoint_dir=str(tmp_path / "a")))
    _bitwise(chunked, plain)
    d = str(tmp_path / "b")
    with rz.fault_plan({site: [{"at": stop_at, "kind": "permanent"}]}) as inj:
        with pytest.raises(rz.PermanentFault):
            fit(ht, checkpoint_every=every, checkpoint_dir=d)
    assert inj.injected[site] == [(stop_at, "permanent")] and os.listdir(d)
    resumed = _result(fit(ht, checkpoint_every=every, checkpoint_dir=d, resume_from=d))
    _bitwise(resumed, plain)
    _parity(chunked, _result(fit(hj, checkpoint_every=every, checkpoint_dir=str(tmp_path / "ref"))))


@pytest.mark.parametrize("name", list(CASES))
def test_the_port_resumes_a_fit_the_jax_package_stopped(name, tmp_path):
    """The reference's fit stopped by the same plan part-way writes its
    checkpoints; the port resumes them to the reference's uninterrupted
    result within its tolerance."""
    fit, site, every, stop_at = CASES[name]
    d = str(tmp_path / "ref")
    with hrz.fault_plan({site: [{"at": stop_at, "kind": "permanent"}]}):
        with pytest.raises(hrz.PermanentFault):
            fit(hj, checkpoint_every=every, checkpoint_dir=d)
    resumed = _result(fit(ht, checkpoint_every=every, checkpoint_dir=d, resume_from=d))
    _parity(resumed, _result(fit(hj)))


def test_preemption_resumes_bitwise_and_is_ignored_without_a_checkpointer(tmp_path):
    fit = CASES["kmeans"][0]
    plain = _result(fit(ht))
    gate = preempt.preemption_gate()
    d = str(tmp_path / "ck")
    ignored = metrics.counter("qos.preempt_ignored").value
    gate.request("test spike")
    try:
        with pytest.raises(rz.PreemptedError) as e:
            fit(ht, checkpoint_every=2, checkpoint_dir=d)
        assert e.value.iteration == 2 and e.value.checkpoint_dir == d and e.value.reason == "test spike"
        # a loop that cannot pause durably (chunks, no checkpoint directory)
        # is not preempted: each refusal is counted, as in the reference
        state, total = base.resumable_fit_loop(lambda s, n: (s + n, n, 1.0), lambda: 0, 7, 0.0, checkpoint_every=2)
        assert (state, total) == (7, 7) and metrics.counter("qos.preempt_ignored").value == ignored + 4
    finally:
        gate.clear()
    _bitwise(_result(fit(ht, checkpoint_every=2, checkpoint_dir=d, resume_from=d)), plain)


def _diverging(pkg_np):
    """A run_chunk whose third chunk turns the iterate non-finite."""
    def run_chunk(state, n):
        state = pkg_np(state) + 1.0
        return (state if float(np.asarray(state)[0]) < 2.5 else state * np.inf), n, 1.0

    return run_chunk


def test_divergence_carries_the_last_good_iterate(tmp_path):
    errors = []
    for loop, err, conv in ((base.resumable_fit_loop, rz.DivergenceError, torch.as_tensor),
                            (ref_base.resumable_fit_loop, hrz.DivergenceError, np.asarray)):
        with pytest.raises(err) as e:
            loop(_diverging(conv), lambda: conv(np.zeros(3, np.float32)), 10, 0.0, checkpoint_every=1,
                 checkpoint_dir=str(tmp_path / str(len(errors))), what="theta")
        errors.append(e.value)
    for e in errors:
        assert (e.iteration, e.last_good_iteration) == (3, 2) and np.array_equal(e.last_good, np.full(3, 2.0))
        assert "last finite theta is at iteration 2" in str(e)
    x = DATA["KMeans"].copy()
    x[5] = np.nan
    with pytest.raises(rz.DivergenceError) as e:
        ht.cluster.KMeans(n_clusters=4, random_state=3, checkpoint_every=1,
                          checkpoint_dir=str(tmp_path / "nan")).fit(ht.array(x, split=0))
    assert e.value.iteration == 1 and e.value.last_good_iteration == 0
    assert e.value.last_good.shape == (4, 5) and np.isfinite(e.value.last_good).all()


@pytest.mark.parametrize("args", [(0, "d", None), (1.5, "d", None), (2, None, None), (-1, None, "r")])
def test_validate_resume_params_raises_the_references_messages(args):
    with pytest.raises(ValueError) as mine:
        base.validate_resume_params(*args)
    with pytest.raises(ValueError) as theirs:
        ref_base.validate_resume_params(*args)
    assert str(mine.value) == str(theirs.value)
    base.validate_resume_params(None, "d", None)
    base.validate_resume_params(3, None, "r")


def test_the_heartbeat_file_is_touched_at_every_boundary(tmp_path, monkeypatch):
    hb = tmp_path / "beat"
    monkeypatch.setenv("HEAT_TPU_HEARTBEAT_FILE", str(hb))
    ht.telemetry.clear_spans()
    CASES["kmeans"][0](ht, checkpoint_every=3, checkpoint_dir=str(tmp_path / "ck"))
    assert hb.exists() and metrics.gauge("fit.heartbeat_ts").value >= os.path.getmtime(hb) - 1
    spans = [s for s in ht.telemetry.get_spans() if s.name == "fit.chunk"]
    assert len(spans) == 4 and spans[-1].attrs["total"] == 10 and metrics.gauge("fit.iter_rate").value > 0
