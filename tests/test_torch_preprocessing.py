"""The port's five scalers against heat_tpu's on a world of one: fit,
transform, fit_transform and inverse_transform over float32, float64 and
int32 inputs (integers scaled in float32, as the reference) and the splits
None, 0 and 1, the fitted statistics and the results within the
reference's bounds, RobustScaler's median and quantiles on the sort's
route; the refusals of bad parameters; and each fitted scaler carried over
by ``interop.from_reference_state``, transforming as the reference's."""

import jax
import numpy as np
import pytest

import heat_tpu as hj
import heat_tpu_torch as ht
from torch_parity import SPLITS, data, same, same_outcome


@pytest.fixture(autouse=True)
def world_of_one():
    ht.use_device("cpu")
    saved = hj.get_comm()
    hj.use_comm(hj.Communication(jax.devices()[:1]))
    try:
        yield
    finally:
        hj.use_comm(saved)


SCALERS = {
    "StandardScaler": ({}, ("mean_", "var_")),
    "StandardScaler_no_mean": ({"with_mean": False}, ("var_",)),
    "MinMaxScaler": ({"feature_range": (-1.0, 2.0)}, ("data_min_", "data_max_", "scale_", "min_")),
    "MinMaxScaler_clip": ({"clip": True}, ("scale_", "min_")),
    "Normalizer": ({}, ()),
    "Normalizer_l1": ({"norm": "l1"}, ()),
    "Normalizer_max": ({"norm": "max"}, ()),
    "MaxAbsScaler": ({}, ("max_abs_", "scale_")),
    "RobustScaler": ({}, ("center_", "iqr_")),
    "RobustScaler_range": ({"quantile_range": (10.0, 60.0), "with_centering": False}, ("iqr_",)),
}


def _inputs(dtype):
    a = data(dtype, shape=(23, 5), seed=30)
    a[:, 3] = 2  # a constant feature (its mean exact, its variance 0): unit scale
    if dtype != "int32":
        a[4, 1] = 0.0
    return a


@pytest.mark.parametrize("name", sorted(SCALERS))
@pytest.mark.parametrize("dtype", ["float32", "float64", "int32"])
def test_scaler_matches_reference(name, dtype):
    kind = name.split("_")[0]
    params, attrs = SCALERS[name]
    a, fresh = _inputs(dtype), data(dtype, shape=(6, 5), seed=31)
    for split in SPLITS:
        p, r = ht.array(a, split=split), hj.array(a, split=split)
        mine = getattr(ht.preprocessing, kind)(**params)
        theirs = getattr(hj.preprocessing, kind)(**params)
        same(mine.fit_transform(p), theirs.fit_transform(r))
        for attr in attrs:
            same(getattr(mine, attr), getattr(theirs, attr))
        pf, rf = ht.array(fresh, split=split), hj.array(fresh, split=split)
        same(mine.transform(pf), theirs.transform(rf))
        if hasattr(theirs, "inverse_transform"):
            same(mine.inverse_transform(mine.transform(pf)), theirs.inverse_transform(theirs.transform(rf)))
        assert mine.get_params() == theirs.get_params()


def test_bad_parameters_raise_as_in_the_reference():
    x = data("float32", shape=(5, 2))
    for call in (lambda m, v: m.preprocessing.MinMaxScaler(feature_range=(1.0, 0.0)),
                 lambda m, v: m.preprocessing.Normalizer(norm="l3"),
                 lambda m, v: m.preprocessing.RobustScaler(quantile_range=(80.0, 20.0)),
                 lambda m, v: m.preprocessing.RobustScaler(unit_variance=True),
                 lambda m, v: m.preprocessing.StandardScaler().fit(v, sample_weight=v),
                 lambda m, v: m.preprocessing.StandardScaler().fit(np.zeros((2, 2)))):
        same_outcome(call, [ht.array(x)], [hj.array(x)])


@pytest.mark.parametrize("name", ["StandardScaler", "MinMaxScaler", "Normalizer", "MaxAbsScaler", "RobustScaler"])
def test_fitted_scaler_carries_over(name):
    a, fresh = _inputs("float32"), data("float32", shape=(6, 5), seed=32)
    ref = getattr(hj.preprocessing, name)().fit(hj.array(a, split=0))
    attrs = [k for k in ("mean_", "var_", "data_min_", "data_max_", "scale_", "min_", "max_abs_", "center_", "iqr_")
             if getattr(ref, k, None) is not None]
    doc = {"kind": name, "params": ref.get_params(), "state": {k: getattr(ref, k).numpy() for k in attrs}}
    est = ht.interop.from_reference_state(doc)
    assert isinstance(est, getattr(ht.preprocessing, name))
    same(est.transform(ht.array(fresh, split=0)), ref.transform(hj.array(fresh, split=0)))
