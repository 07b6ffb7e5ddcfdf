"""The port's GaussianNB and Lasso, RegressionMixin and the ``is_*``
predicates against heat_tpu's on a world of one.

GaussianNB: fit over float32, float64 and int32 points with int32 and
float labels, split None, 0 and 1, with priors and sample weights, and a
partial fit in two halves: ``theta_``/``var_`` within rtol 1e-5,
``class_count_`` exact (sums of sample weights within rtol 1e-6),
``classes_`` bitwise, predictions bitwise, ``predict_log_proba``,
``epsilon_`` and ``sigma_``.  ``predict_proba`` from the same fitted state
(the reference's, carried over) within atol 1e-6 plus one float32 ulp of
the largest joint log likelihood: the expanded quadratic form of order 100
is rounded in each package's own order of additions, and a probability
moves by at most half its log likelihood's error (1.85e-6 measured at
|jll| 184, whose ulp is 1.5e-5).  From each package's own fit the fits'
roundings add to that (theta a few 1e-7 apart: up to 2.2e-6 measured),
held within atol 1e-5.  Lasso: several ``lam`` (some coefficients driven to zero),
``theta`` within atol 1e-5, ``n_iter`` equal, ``predict`` within rtol 1e-5,
``coef_``, ``intercept_``, ``soft_threshold``, ``rmse``; the resumable
parameters raise."""

import jax
import numpy as np
import pytest

import heat_tpu as hj
import heat_tpu_torch as ht
from heat_tpu_torch.regression import lasso as port_lasso


@pytest.fixture(autouse=True)
def world_of_one():
    ht.use_device("cpu")
    saved = hj.get_comm()
    hj.use_comm(hj.Communication(jax.devices()[:1]))
    try:
        yield
    finally:
        hj.use_comm(saved)


def _classes(n=301, f=5, c=3, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, c, n)
    x = rng.standard_normal((n, f)) * (1 + y[:, None]) + 2.0 * y[:, None]
    return (np.round(x * 3) if np.dtype(dtype).kind == "i" else x).astype(dtype), y.astype(np.int32)


def _same_nb(mine, theirs, x_port, x_ref, weighted=False):
    for attr in ("theta_", "var_", "sigma_"):
        np.testing.assert_allclose(getattr(mine, attr).numpy(), np.asarray(getattr(theirs, attr).numpy()), rtol=1e-5)
    for attr in ("class_count_", "classes_"):
        g, w = getattr(mine, attr).numpy(), np.asarray(getattr(theirs, attr).numpy())
        assert g.dtype == w.dtype
        if weighted and attr == "class_count_":
            np.testing.assert_allclose(g, w, rtol=1e-6)
        else:
            np.testing.assert_array_equal(g, w)
    np.testing.assert_allclose(mine.class_prior_.numpy(), np.asarray(theirs.class_prior_.numpy()), rtol=1e-6)
    assert mine.epsilon_ == pytest.approx(theirs.epsilon_, rel=1e-5)
    pred, want = mine.predict(x_port), theirs.predict(x_ref)
    assert pred.split == want.split and pred.dtype.__name__ == want.dtype.__name__
    np.testing.assert_array_equal(pred.numpy(), np.asarray(want.numpy()))
    proba, want = mine.predict_proba(x_port), theirs.predict_proba(x_ref)
    assert proba.split == want.split and proba.shape == want.shape
    np.testing.assert_allclose(proba.numpy(), np.asarray(want.numpy()), atol=1e-5)
    state = {a: np.asarray(getattr(theirs, a).numpy()) for a in ("classes_", "theta_", "var_", "class_count_",
                                                                 "class_prior_")}
    carried = ht.interop.from_reference_state({"kind": "GaussianNB", "params": theirs.get_params(),
                                                "state": {**state, "epsilon_": theirs.epsilon_}})
    ulp = np.spacing(np.abs(np.asarray(theirs.predict_log_proba(x_ref).numpy())).max().astype(np.float32))
    np.testing.assert_allclose(carried.predict_proba(x_port).numpy(), np.asarray(want.numpy()), atol=1e-6 + ulp)
    np.testing.assert_array_equal(carried.predict(x_port).numpy(), np.asarray(theirs.predict(x_ref).numpy()))
    np.testing.assert_allclose(mine.predict_log_proba(x_port).numpy(),
                               np.asarray(theirs.predict_log_proba(x_ref).numpy()), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int32])
@pytest.mark.parametrize("split", [None, 0, 1])
def test_gaussian_nb_fit_matches_reference(dtype, split):
    x, y = _classes(dtype=dtype)
    ysplit = 0 if split == 0 else None
    for labels in (y, y.astype(np.float64) * 0.5):
        mine = ht.naive_bayes.GaussianNB().fit(ht.array(x, split=split), ht.array(labels, split=ysplit))
        theirs = hj.naive_bayes.GaussianNB().fit(hj.array(x, split=split), hj.array(labels, split=ysplit))
        _same_nb(mine, theirs, ht.array(x, split=split if split != 1 else 0),
                 hj.array(x, split=split if split != 1 else 0))


@pytest.mark.parametrize("split", [None, 0])
def test_gaussian_nb_partial_fit_priors_and_weights(split):
    x, y = _classes(seed=1)
    fresh, _ = _classes(n=57, seed=2)
    xp, xr = ht.array(fresh, split=split), hj.array(fresh, split=split)
    halves = (slice(0, 140), slice(140, None))
    mine, theirs = ht.naive_bayes.GaussianNB(), hj.naive_bayes.GaussianNB()
    for h in halves:
        mine.partial_fit(ht.array(x[h], split=split), ht.array(y[h], split=split), classes=[0, 1, 2])
        theirs.partial_fit(hj.array(x[h], split=split), hj.array(y[h], split=split), classes=[0, 1, 2])
    _same_nb(mine, theirs, xp, xr)
    w = np.random.default_rng(3).uniform(0.2, 2.0, x.shape[0]).astype(np.float32)
    pri = np.array([0.2, 0.5, 0.3], np.float32)
    mine = ht.naive_bayes.GaussianNB(priors=ht.array(pri), var_smoothing=1e-3).fit(
        ht.array(x, split=split), ht.array(y, split=split), sample_weight=ht.array(w, split=split))
    theirs = hj.naive_bayes.GaussianNB(priors=hj.array(pri), var_smoothing=1e-3).fit(
        hj.array(x, split=split), hj.array(y, split=split), sample_weight=hj.array(w, split=split))
    _same_nb(mine, theirs, xp, xr, weighted=True)
    # a class absent from a batch keeps its moments
    mine.partial_fit(ht.array(x[y != 1], split=split), ht.array(y[y != 1], split=split))
    theirs.partial_fit(hj.array(x[y != 1], split=split), hj.array(y[y != 1], split=split))
    _same_nb(mine, theirs, xp, xr, weighted=True)


def test_gaussian_nb_refusals_match_reference():
    x, y = _classes(n=20)
    for m in (ht, hj):
        with pytest.raises(TypeError):
            m.naive_bayes.GaussianNB().fit(x, m.array(y))
        with pytest.raises(ValueError):
            m.naive_bayes.GaussianNB().fit(m.array(x[:, 0]), m.array(y))
        with pytest.raises(RuntimeError):
            m.naive_bayes.GaussianNB().predict(m.array(x))
        with pytest.raises(ValueError):  # a 1-D result cannot be split along axis 1
            m.naive_bayes.GaussianNB().fit(m.array(x), m.array(y)).predict(m.array(x, split=1))
    assert ht.naive_bayes.GaussianNB(var_smoothing=0.5).get_params() == hj.naive_bayes.GaussianNB(
        var_smoothing=0.5).get_params()


def _regression(n=200, f=6, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal(f)
    w[[1, 4]] = 0.0
    x = rng.standard_normal((n, f))
    y = x @ w + 0.5 + 0.01 * rng.standard_normal(n)
    return (np.round(x * 4) if np.dtype(dtype).kind == "i" else x).astype(dtype), y.astype(np.float32)


@pytest.mark.parametrize("lam", [0.1, 1.0, 10.0, 100.0])
@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int32])
def test_lasso_matches_reference(lam, dtype):
    x, y = _regression(dtype=dtype)
    for split in (None, 0, 1):
        mine = ht.regression.Lasso(lam=lam, max_iter=50).fit(ht.array(x, split=split), ht.array(y, split=0))
        theirs = hj.regression.Lasso(lam=lam, max_iter=50).fit(hj.array(x, split=split), hj.array(y, split=0))
        assert mine.theta.shape == theirs.theta.shape == (x.shape[1] + 1, 1)
        np.testing.assert_allclose(mine.theta.numpy(), np.asarray(theirs.theta.numpy()), atol=1e-5)
        assert mine.n_iter == theirs.n_iter and isinstance(mine.n_iter, int)
        assert port_lasso.STOP_TEST_READS == min(mine.n_iter, 49)
        np.testing.assert_allclose(mine.coef_.numpy(), np.asarray(theirs.coef_.numpy()), atol=1e-5)
        np.testing.assert_allclose(mine.intercept_.numpy(), np.asarray(theirs.intercept_.numpy()), atol=1e-5)
        pred, want = mine.predict(ht.array(x, split=split)), theirs.predict(hj.array(x, split=split))
        assert pred.split == want.split and pred.shape == want.shape
        np.testing.assert_allclose(pred.numpy(), np.asarray(want.numpy()), rtol=1e-5, atol=1e-5)
        assert mine.rmse(ht.array(y), pred) == pytest.approx(theirs.rmse(hj.array(y), want), rel=1e-5)


def test_lasso_stop_rules_helpers_and_refusals():
    x, y = _regression(seed=4)
    for max_iter, tol in ((1, 1e-6), (3, 0.0), (100, 1e-2)):
        mine = ht.regression.Lasso(lam=0.5, max_iter=max_iter, tol=tol).fit(ht.array(x), ht.array(y))
        theirs = hj.regression.Lasso(lam=0.5, max_iter=max_iter, tol=tol).fit(hj.array(x), hj.array(y))
        assert mine.n_iter == theirs.n_iter
        np.testing.assert_allclose(mine.theta.numpy(), np.asarray(theirs.theta.numpy()), atol=1e-5)
    mine, theirs = ht.regression.Lasso(lam=0.7), hj.regression.Lasso(lam=0.7)
    assert mine.get_params() == theirs.get_params() and mine.theta is None and mine.coef_ is None
    rho = x[:5] * 2
    np.testing.assert_array_equal(mine.soft_threshold(ht.array(rho, split=0)).numpy(),
                                  np.asarray(theirs.soft_threshold(hj.array(rho, split=0)).numpy()))
    np.testing.assert_array_equal(mine.soft_threshold(rho[0]).numpy(), np.asarray(theirs.soft_threshold(rho[0])))
    mine.lam = theirs.lam = 3.0
    assert mine.lam == 3.0 and mine.get_params() == theirs.get_params()
    with pytest.raises(RuntimeError):
        mine.predict(ht.array(x))
    for m in (ht, hj):
        with pytest.raises(TypeError):
            m.regression.Lasso().fit(x, m.array(y))
        with pytest.raises(ValueError):
            m.regression.Lasso().fit(m.array(x[:, 0]), m.array(y))
    for resumable in ({"checkpoint_every": 2, "checkpoint_dir": "ckpt"}, {"resume_from": "ckpt"},
                      {"checkpoint_dir": "ckpt"}):
        assert ht.regression.Lasso(**resumable).get_params()["resume_from"] == resumable.get("resume_from")
    for m in (ht, hj):
        with pytest.raises(ValueError, match="requires checkpoint_dir"):
            m.regression.Lasso(checkpoint_every=2)


def test_regression_mixin_and_predicates_match_reference():
    x, y = _regression(n=40)
    got = ht.regression.Lasso(lam=0.1).fit_predict(ht.array(x), ht.array(y))
    want = hj.regression.Lasso(lam=0.1).fit_predict(hj.array(x), hj.array(y))
    np.testing.assert_allclose(got.numpy(), np.asarray(want.numpy()), rtol=1e-5, atol=1e-5)
    names = [("cluster", "KMeans"), ("cluster", "KMedians"), ("cluster", "Spectral"),
             ("cluster", "BatchParallelKMeans"), ("naive_bayes", "GaussianNB"), ("regression", "Lasso"),
             ("classification", "KNeighborsClassifier"), ("decomposition", "PCA"),
             ("preprocessing", "StandardScaler")]
    for pkg, name in names:
        mine, theirs = getattr(getattr(ht, pkg), name)(), getattr(getattr(hj, pkg), name)()
        for pred in ("is_classifier", "is_estimator", "is_clusterer", "is_regressor", "is_transformer"):
            assert getattr(ht, pred)(mine) == getattr(hj, pred)(theirs), (name, pred)
    for pred in ("is_classifier", "is_estimator", "is_clusterer", "is_regressor", "is_transformer"):
        assert not getattr(ht, pred)(object())
    with pytest.raises(NotImplementedError):
        ht.RegressionMixin().fit(None, None)
    with pytest.raises(NotImplementedError):
        ht.RegressionMixin().predict(None)
