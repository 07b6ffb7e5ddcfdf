"""heat_tpu_torch/core/dispatch.py, the dispatch layer's surface, against the
JAX package's heat_tpu/core/dispatch.py: ``batch_bucket`` bitwise, the
counters' names, the reference's repeated-sequence contract (a second pass
of the same ops misses nothing), the external dispatches of a KMeans fit
(one per Lloyd step in the port), the ``dispatch.compile`` fault site, cost
accounting (2mnk flops for a product) and the registered locks."""

import warnings

import numpy as np
import pytest

import heat_tpu as hj
import heat_tpu_torch as ht
from heat_tpu.core import dispatch as ref_dispatch
from heat_tpu_torch.analysis import concurrency
from heat_tpu_torch.core import dispatch, kernels
from heat_tpu_torch.resilience import faults
from heat_tpu_torch.resilience.errors import PermanentFault


@pytest.fixture(autouse=True)
def _on_cpu():
    ht.use_device("cpu")


CAPS = [None, 1, 2, 3, 7, 64, 100, 1000, 4096]


@pytest.mark.parametrize("cap", CAPS)
def test_batch_bucket_is_the_reference_bitwise(cap):
    for n in [-3, 0] + list(range(1, 4097)):
        outcomes = []
        for fn in (dispatch.batch_bucket, ref_dispatch.batch_bucket):
            try:
                outcomes.append(("value", fn(n, cap)))
            except ValueError as e:
                outcomes.append(("ValueError", str(e)))
        assert outcomes[0] == outcomes[1], (n, cap)


def test_cache_stats_keys_are_a_superset_of_the_reference():
    assert set(dispatch.cache_stats()) >= set(ref_dispatch.cache_stats())
    assert set(dispatch.__all__) >= set(ref_dispatch.__all__) - {
        "PendingExpr", "chain_apply", "make_node", "materialize"}
    assert dispatch.fusion_enabled() is False


def _inputs(pkg, n=64):
    rng = np.random.default_rng(42)
    return [pkg.array(rng.standard_normal(n).astype(np.float32), split=0) for _ in range(3)]


def _sequence(pkg, a, b, c):
    """tests/test_dispatch_cache.py::_sequence: an element-wise chain, a
    scalar broadcast, a unary op, a reduction and a scan."""
    r1 = ((a * b + c) / 2.0 - b).sum()
    r2 = pkg.exp(a * 0.5).mean()
    r3 = pkg.cumsum(a + b, 0)
    return float(r1), float(r2), r3.numpy()


@pytest.mark.parametrize("pkg,mod", [(hj, ref_dispatch), (ht, dispatch)], ids=["reference", "port"])
def test_second_pass_misses_nothing(pkg, mod):
    a, b, c = _inputs(pkg)
    first = _sequence(pkg, a, b, c)
    mod.reset_stats()
    second = _sequence(pkg, a, b, c)
    stats = mod.cache_stats()
    assert first[:2] == second[:2]
    np.testing.assert_array_equal(first[2], second[2])
    assert stats["misses"] == 0, stats
    assert stats["hits"] > 0 and stats["hit_rate"] == 1.0


def test_the_sequence_agrees_with_the_reference():
    got = _sequence(ht, *_inputs(ht))
    want = _sequence(hj, *_inputs(hj))
    np.testing.assert_allclose(got[:2], want[:2], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-5, atol=1e-5)


def test_first_pass_counts_a_miss_per_new_key_and_a_dispatch_per_application():
    dispatch.clear_cache()
    a = ht.array(np.arange(12, dtype=np.float32), split=0)
    (a + a).sum()
    s = dispatch.cache_stats()
    assert (s["misses"], s["hits"], s["dispatches"], s["cache_size"]) == (2, 0, 2, 2)
    (a + a).sum()
    s = dispatch.cache_stats()
    assert (s["misses"], s["hits"], s["dispatches"]) == (2, 2, 4)
    ht.array(np.arange(13, dtype=np.float32), split=0) + a[:1]  # a new shape: a new key
    assert dispatch.cache_stats()["misses"] == 3
    assert any("add" in k for k in dispatch.cache_keys())


def test_a_disabled_cache_counts_nothing(monkeypatch):
    dispatch.clear_cache()
    monkeypatch.setattr(dispatch, "_CACHE_ENABLED", False)
    a = ht.array(np.arange(6, dtype=np.float32), split=0)
    np.testing.assert_array_equal(((a * 2.0) + 1.0).numpy(), np.arange(6) * 2.0 + 1.0)
    assert dispatch.cache_stats()["dispatches"] == 0 and dispatch.cache_stats()["cache_size"] == 0


def test_a_kmeans_fit_counts_one_external_dispatch_per_lloyd_step(monkeypatch):
    rng = np.random.default_rng(3)
    centres = rng.standard_normal((4, 5)) * 8
    pts = (centres[rng.integers(0, 4, 400)] + rng.standard_normal((400, 5))).astype(np.float32)
    steps = []
    update = kernels.lloyd_update

    def counted(*args, **kwargs):
        steps.append(1)
        return update(*args, **kwargs)

    monkeypatch.setattr(kernels, "lloyd_update", counted)
    dispatch.reset_stats()
    km = ht.cluster.KMeans(n_clusters=4, init="random", random_state=1, max_iter=20).fit(ht.array(pts, split=0))
    ext = dispatch.cache_stats()["external_dispatches"]
    assert ext == len(steps) == km.n_iter_ + 1
    # the reference: one dispatch for its whole on-device fit loop and one
    # for the final assignment, however many iterations
    ref_dispatch.reset_stats()
    hj.cluster.KMeans(n_clusters=4, init="random", random_state=1, max_iter=20).fit(hj.array(pts, split=0))
    assert ref_dispatch.cache_stats()["external_dispatches"] <= 3


def test_lasso_counts_its_sweeps_and_routes_its_ops():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((64, 3)).astype(np.float32)
    y = (x @ np.array([1.0, -2.0, 0.5], np.float32) + 0.3).reshape(-1, 1)
    dispatch.clear_cache()
    est = ht.regression.Lasso(lam=0.01, max_iter=30).fit(ht.array(x, split=0), ht.array(y, split=0))
    assert dispatch.cache_stats()["external_dispatches"] == est.n_iter
    before = dispatch.cache_stats()["dispatches"]
    pred = est.predict(ht.array(x, split=0))
    st = est.soft_threshold(ht.array(np.array([-1.0, 0.005, 2.0], np.float32)))
    assert dispatch.cache_stats()["dispatches"] == before + 2
    np.testing.assert_allclose(st.numpy(), [-0.99, 0.0, 1.99], rtol=1e-6)
    ref = hj.regression.Lasso(lam=0.01, max_iter=30).fit(hj.array(x, split=0), hj.array(y, split=0))
    np.testing.assert_allclose(pred.numpy(), ref.predict(hj.array(x, split=0)).numpy(), rtol=1e-5, atol=1e-5)


def test_argmin_argmax_go_through_the_layer():
    x = ht.array(np.random.default_rng(0).standard_normal((10, 4)).astype(np.float32), split=0)
    dispatch.clear_cache()
    ht.argmax(x, axis=1)
    ht.argmin(x, axis=1)
    ht.argmax(x, axis=1)
    s = dispatch.cache_stats()
    assert (s["misses"], s["hits"]) == (2, 1)
    assert any("argmax" in k for k in dispatch.cache_keys())


def test_an_injected_compile_fault_falls_back_and_a_permanent_one_raises():
    a = ht.array(np.arange(8, dtype=np.float32), split=0)
    dispatch.clear_cache()
    with faults.fault_plan({"dispatch.compile": [{"at": 0, "kind": "transient"}]}):
        with pytest.warns(RuntimeWarning, match="falling back to eager execution"):
            got = a * 3.0
    np.testing.assert_array_equal(got.numpy(), np.arange(8) * 3.0)
    s = dispatch.cache_stats()
    assert s["compile_fallbacks"] == 1 and s["cache_size"] == 0  # the key is not kept
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        a * 3.0  # the next application misses again, now without a fault
    assert dispatch.cache_stats()["misses"] == 2
    dispatch.clear_cache()
    with faults.fault_plan({"dispatch.compile": [{"at": 0, "kind": "permanent"}]}):
        with pytest.raises(PermanentFault):
            a * 3.0
    assert dispatch.cache_stats()["compile_fallbacks"] == 0


@pytest.mark.parametrize("m,k,n", [(64, 16, 16), (33, 7, 5), (8, 128, 1)])
def test_cost_accounting_counts_2mnk_for_a_product(m, k, n):
    rng = np.random.default_rng(m)
    x = ht.array(rng.standard_normal((m, k)).astype(np.float32), split=0)
    w = ht.array(rng.standard_normal((k, n)).astype(np.float32))
    prev = dispatch.set_cost_accounting(True)
    try:
        dispatch.clear_cache()
        with dispatch.meter_costs() as meter:
            x @ w
            x @ w  # a hit: metered from the record its miss made
        summary = dispatch.cost_summary()
    finally:
        dispatch.set_cost_accounting(prev)
    assert meter.flops == 2 * 2 * m * k * n and meter.calls == 2 and meter.unmetered_calls == 0
    assert meter.bytes_accessed == 2 * 4 * (m * k + k * n + m * n)
    assert summary["enabled"] and summary["executables"] == 1 and summary["flops_total"] == 2 * m * k * n
    (rec,) = summary["per_key"].values()
    assert set(rec) == {"flops", "bytes_accessed", "transcendentals"}


def test_unmetered_dispatches_are_counted_as_such():
    prev = dispatch.set_cost_accounting(False)
    try:
        dispatch.clear_cache()
        a = ht.array(np.ones(4, np.float32))
        with dispatch.meter_costs() as meter:
            a + a
        assert (meter.calls, meter.unmetered_calls, meter.flops) == (0, 1, 0.0)
    finally:
        dispatch.set_cost_accounting(prev)


def test_in_place_writes_count_as_donations_and_out_stores_do_not():
    dispatch.reset_stats()
    a = ht.array(np.zeros((4, 4), np.float32), split=0)
    a[1] = 5.0
    a.fill_diagonal(2.0)
    assert dispatch.cache_stats()["donations"] == 2
    ht.add(a, 1.0, out=a)
    assert dispatch.cache_stats()["donations"] == 2


def test_finalize_and_reshape_clear_the_keys():
    a = ht.array(np.arange(4, dtype=np.float32))
    a + a
    assert dispatch.cache_stats()["cache_size"] > 0
    ht.parallel.finalize()
    assert dispatch.cache_stats()["cache_size"] == 0
    a + a
    ht.get_comm().reshape(1)
    assert dispatch.cache_stats()["cache_size"] == 0


def test_the_locks_are_registered_and_the_counters_in_the_registry():
    for name, structure in (("dispatch.cache", "dispatch.cache"), ("dispatch.aot", "dispatch.aot.state")):
        assert concurrency.lock_for_structure(structure) == name
    snap = ht.telemetry.snapshot()
    for n in ("hits", "misses", "dispatches", "fused_ops", "donations", "external_dispatches",
              "compile_fallbacks", "compile_ms", "flops_total", "cost_bytes_total", "cache_size", "hit_rate"):
        assert f"dispatch.{n}" in snap
    dispatch.record_external_dispatch(3)
    ht.telemetry.reset_all("dispatch")
    assert dispatch.cache_stats()["external_dispatches"] == 0
