"""The port's elastic layer: ``comm.reshape``, ``DNDarray.reshard_``,
``ht.array(x, comm=new)``, ``HierarchicalCommunication.reshape`` and a
cross-world checkpoint restore in one world of 3 CPU ranks (torch.distributed,
gloo; tests/torch_world.py), an ``ElasticSupervisor`` in that world driven by
a scripted ``WorkerLostError``, the ``HeartbeatMonitor`` in process, and one
``ProcessSupervisor`` run: a gloo world of 3 killed at a chunk boundary
(``kind: "kill"``) and relaunched at 2.

Held against the JAX package: after ``reshape(2)`` each array's
``lshape_map`` and ``counts_displs`` are the reference's on a 2-device
Communication and every rank's chunk is bitwise its canonical slice; the
supervised fits meet the reference's contract of
tests/test_elastic.py::test_kill_at_p_resume_at_q_converges (n_iter equal
to the reference's uninterrupted fit, centres within atol 1e-4: the smaller
world adds its partial sums in another order)."""

import json
import sys

import jax
import numpy as np
import pytest

import heat_tpu as hj
import heat_tpu_torch as ht
from heat_tpu.elastic import HeartbeatMonitor as RefMonitor
from heat_tpu_torch import resilience as rz
from heat_tpu_torch.elastic import (ElasticSupervisor, HeartbeatMonitor, ProcessSupervisor, WorkerLostError,
                                    elastic_state, kmeans_worker_source)
from heat_tpu_torch.telemetry import metrics
from heat_tpu_torch.utils.checkpoint import Checkpointer
from torch_world import WORLD, spawned

pytestmark = pytest.mark.multiprocess

A0 = np.arange(11 * 4, dtype=np.float32).reshape(11, 4) * 0.5  # 11 rows: 4, 4, 3 on 3 ranks; 6, 5 on 2
A1 = np.arange(3 * 7, dtype=np.float64).reshape(3, 7) - 9.0  # 7 columns
KW = dict(n_clusters=4, init="random", max_iter=40, tol=1e-4, random_state=3)

_RESHAPE_MAIN = r"""
saved = {}
w = ht.get_comm()
xs = {"x0": ht.array(arrays["a0"], split=0), "x1": ht.array(arrays["a1"], split=1), "xn": ht.array(arrays["a0"])}
new = w.reshape(2)
saved["member"], saved["retired"], saved["size"] = np.asarray(new.is_member), np.asarray(w.retired), np.asarray(new.size)
for name, x in xs.items():
    x.reshard_(new)
    saved[name + "/local"] = x.larray.numpy()
    saved[name + "/lshape_map"] = np.asarray(x.lshape_map)
    if x.split is not None:
        saved[name + "/counts_displs"] = np.asarray(x.counts_displs())
y = ht.array(ht.array(arrays["a0"], split=0), comm=new)  # a row exchange over the old world: every rank
saved["y/local"] = y.larray.numpy()
if new.is_member:
    saved["x0/sum"] = np.asarray(float(xs["x0"].sum()))
h = ht.parallel.HierarchicalCommunication()
h2 = h.reshape(2)
saved["h2/grid"] = np.asarray([h2.num_nodes, h2.node_size, int(h2.is_member), int(h.retired)])
if h2.is_member:
    saved["h2/psum"] = h2.psum(torch.tensor([rank + 1.0])).numpy()
    saved["h2/node_psum"] = h2.psum(torch.tensor([rank + 1.0]), axis="node").numpy()
ck = ht.utils.checkpoint.Checkpointer(str(arrays["dir"]))
ck.save(3, {"x": ht.array(arrays["a0"], split=0), "n": 3})
saved["written_world"] = np.asarray(ck.world_size())
before = ht.telemetry.snapshot()["checkpoint.crossworld_restores"]
if new.is_member:
    st = ck.restore(comm=new)
    saved["restored/local"] = st["x"].larray.numpy()
    saved["restored/n"] = np.asarray(st["n"])
    saved["restored/counted"] = np.asarray(ht.telemetry.snapshot()["checkpoint.crossworld_restores"] - before)
np.savez(out, **saved)
"""

_ELASTIC_MAIN = r"""
from heat_tpu_torch import resilience as rz
from heat_tpu_torch.elastic import ElasticSupervisor, WorkerLostError, elastic_state

pts, d = arrays["pts"], str(arrays["dir"])
kw = dict(n_clusters=4, init="random", max_iter=40, tol=1e-4, random_state=3)
live = ht.array(arrays["pts"], split=0)
seen = []


def fit_fn(comm, resume_from):
    x = ht.array(pts, split=0, comm=comm)
    km = ht.cluster.KMeans(**kw, checkpoint_every=2, checkpoint_dir=d, resume_from=resume_from)
    if resume_from is None:
        try:  # the scripted loss: every rank stops at the second boundary
            with rz.fault_plan({"kmeans.iter": [{"at": 1, "kind": "transient"}]}):
                return km.fit(x)
        except rz.TransientFault:
            raise WorkerLostError("scripted loss of one rank", lost=1)
    assert live.comm is comm  # on_world_change moved it before the resume
    return km.fit(x)


sup = ElasticSupervisor(fit_fn, d, on_world_change=lambda c: (seen.append(c.size), live.reshard_(c)))
km = sup.run()
saved = {"recoveries": np.asarray(sup.recoveries), "world": np.asarray(sup.world.size),
         "member": np.asarray(sup.world.is_member), "seen": np.asarray(seen),
         "state": np.asarray([elastic_state()["world_size"], elastic_state()["worker_losses"],
                              elastic_state()["reshapes"]]),
         "live": live.larray.numpy()}
if km is not None:
    saved["n_iter"] = np.asarray(km.n_iter_)
    saved["centers"] = km.cluster_centers_.numpy()
    saved["labels"] = km.labels_.larray.numpy()
np.savez(out, **saved)
"""


def _pts():
    rng = np.random.default_rng(13)
    c = rng.standard_normal((4, 6)) * 2.0
    return (c[rng.integers(0, 4, 240)] + rng.standard_normal((240, 6))).astype(np.float32)


_SLICES = {
    "reshape": (_RESHAPE_MAIN, lambda: (dict(a0=A0, a1=A1, dir=np.asarray("")), None)),
    "elastic": (_ELASTIC_MAIN, lambda: (dict(pts=_pts(), dir=np.asarray("")), None)),
}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every rank's results of each slice; the reference's meanwhile."""
    tmp = tmp_path_factory.mktemp("elastic")
    slices = {name: (script, (lambda make, name=name: lambda: _with_dir(make(), tmp / name))(make))
              for name, (script, make) in _SLICES.items()}
    with spawned(tmp, slices) as w:
        two = hj.Communication(jax.devices()[:2])
        want = {
            "x0": hj.array(A0, split=0, comm=two), "x1": hj.array(A1, split=1, comm=two),
            "plain": hj.cluster.KMeans(**KW).fit(hj.array(_pts(), split=0)),
            "hier": hj.parallel.HierarchicalCommunication(devices=jax.devices()[:3]).reshape(2),
        }
        got = {name: w.ranks(name) for name in _SLICES}
    return got, want


def _with_dir(made, d):
    arrays, extra = made
    return {**arrays, "dir": np.asarray(str(d))}, extra


def test_reshape_and_reshard_give_the_references_layout(world):
    got, want = world
    ranks = got["reshape"]
    two = hj.Communication(jax.devices()[:2])
    for r, g in enumerate(ranks):
        assert bool(g["member"]) == (r < 2) and bool(g["retired"]) and int(g["size"]) == 2
        for name, a in (("x0", A0), ("x1", A1)):
            ref = want[name]
            np.testing.assert_array_equal(g[name + "/lshape_map"], np.asarray(ref.lshape_map))
            np.testing.assert_array_equal(g[name + "/counts_displs"], np.asarray(ref.counts_displs()))
            if r < 2:
                sl = two.chunk(a.shape, ref.split, rank=r)[2]
                assert g[name + "/local"].tobytes() == a[sl].tobytes()  # bitwise
            else:  # the rank that left handed its rows over
                assert g[name + "/local"].size == 0
        np.testing.assert_array_equal(g["xn/local"], A0)  # unsplit: whole on every rank
        if r < 2:
            assert float(g["x0/sum"]) == float(A0.sum())
            assert g["y/local"].tobytes() == A0[two.chunk(A0.shape, 0, rank=r)[2]].tobytes()
        else:
            assert g["y/local"].size == 0


def test_hierarchical_reshape_and_the_crossworld_restore(world):
    got, want = world
    ref = want["hier"]
    for r, g in enumerate(got["reshape"]):
        assert list(g["h2/grid"]) == [ref.num_nodes, ref.node_size, int(r < 2), 1]
        assert int(g["written_world"]) == WORLD
        if r < 2:
            assert float(g["h2/psum"][0]) == 3.0 and float(g["h2/node_psum"][0]) == 3.0
            two = hj.Communication(jax.devices()[:2])
            assert g["restored/local"].tobytes() == A0[two.chunk(A0.shape, 0, rank=r)[2]].tobytes()
            assert int(g["restored/n"]) == 3 and int(g["restored/counted"]) == 1


def test_the_elastic_supervisor_shrinks_the_world_and_resumes(world):
    got, want = world
    plain = want["plain"]
    for r, g in enumerate(got["elastic"]):
        assert int(g["recoveries"]) == 1 and int(g["world"]) == WORLD - 1 and list(g["seen"]) == [WORLD - 1]
        assert bool(g["member"]) == (r < WORLD - 1)
        world_size, losses, reshapes = g["state"]
        assert world_size == WORLD - 1 and losses >= 1 and reshapes >= 1
        if r < WORLD - 1:
            assert int(g["n_iter"]) == plain.n_iter_
            np.testing.assert_allclose(g["centers"], np.asarray(plain.cluster_centers_.numpy()), atol=1e-4)
            two = hj.Communication(jax.devices()[:2])
            assert g["labels"].shape == (two.chunk((240,), 0, rank=r)[1][0],)
            assert g["live"].tobytes() == _pts()[two.chunk((240, 6), 0, rank=r)[2]].tobytes()
        else:
            assert "n_iter" not in g and g["live"].size == 0


def test_heartbeat_monitor_matches_the_reference(tmp_path):
    """The gauge source with a pinned clock, a file source, arming before
    the first beat and the elastic.detect site, against the reference's
    monitor."""
    beat = metrics.gauge("fit.heartbeat_ts")
    from heat_tpu.telemetry import metrics as ref_metrics

    ref_beat = ref_metrics.gauge("fit.heartbeat_ts")
    prev = beat.value, ref_beat.value
    try:
        for mon_cls, g, err in ((HeartbeatMonitor, beat, WorkerLostError),
                                (RefMonitor, ref_beat, hj.resilience.WorkerLostError)):
            clock = {"t": 1000.0}
            mon = mon_cls(timeout_s=5.0, clock=lambda: clock["t"])
            g.set(1000.0)
            clock["t"] = 1003.0
            mon.check()
            clock["t"] = 1006.5
            with pytest.raises(err) as e:
                mon.check()
            assert e.value.heartbeat_age == pytest.approx(6.5)
            armed = mon_cls(timeout_s=2.0, heartbeat_file=str(tmp_path / "none"), clock=lambda: clock["t"])
            armed.check()
            clock["t"] += 3.0
            with pytest.raises(err):
                armed.check()
    finally:
        beat.set(prev[0])
        ref_beat.set(prev[1])
    hb = tmp_path / "hb"
    hb.touch()
    mon = HeartbeatMonitor(timeout_s=3600.0, heartbeat_file=str(hb))
    mon.check()
    assert mon.age() < 60.0 and not HeartbeatMonitor().stale()  # the timeout knob defaults to 0: off
    with rz.fault_plan({"elastic.detect": [{"at": 0, "kind": "transient"}]}) as inj:
        with pytest.raises(rz.TransientFault):
            HeartbeatMonitor(timeout_s=0.0).check()
    assert inj.hits["elastic.detect"] == 1


def test_the_supervisors_budget_and_floor_in_a_world_of_one(tmp_path):
    d = str(tmp_path / "ck")

    def always_lost(comm, resume_from):
        raise WorkerLostError("gone", lost=0)

    sup = ElasticSupervisor(always_lost, d, shrink_by=0, max_recoveries=2)
    with pytest.raises(WorkerLostError):
        sup.run()
    assert sup.recoveries == 3  # two recoveries, and the third loss over budget
    with pytest.raises(rz.ReshapeError):
        ElasticSupervisor(always_lost, d).run()  # one rank less than one
    with pytest.raises(rz.ReshapeError):
        ht.get_comm().reshape(2)
    with pytest.raises(rz.ReshapeError):
        ht.get_comm().reshape(devices=[])


def test_a_killed_world_of_three_resumes_at_two(tmp_path):
    """The one ProcessSupervisor run of the tier: every rank of a world of
    3 killed (exit 137) at its second chunk boundary, the world relaunched
    at 2 from the checkpoint, the reference's contract met."""
    d = str(tmp_path / "pq")
    kill = json.dumps({"plan": {"kmeans.iter": [{"at": 1, "kind": "kill", "exit_code": 137}]}})

    def build(ws, resume, attempt):
        src = kmeans_worker_source(d, resume_from=resume, device="cpu")
        return [sys.executable, "-c", src], {"HEAT_TPU_FAULT_PLAN": kill if attempt == 0 else "",
                                             "OMP_NUM_THREADS": "1"}

    losses = metrics.counter("elastic.worker_losses").value
    out = ProcessSupervisor(build, d, world_size=3, poll_s=0.1, attempt_timeout_s=120).run()
    assert out["recoveries"] == 1 and out["world_size"] == 2
    assert out["attempts"][0]["returncodes"] == [137] * 3 and out["attempts"][1]["returncodes"] == [0, 0]
    assert len(out["recovery_s"]) == 1 and out["recovery_s"][0] < 280
    assert metrics.counter("elastic.worker_losses").value == losses + 1 and elastic_state()["world_size"] == 2
    hj.random.seed(13)
    x = hj.random.randn(240, 6, split=0).astype(hj.float32)
    plain = hj.cluster.KMeans(**KW).fit(x)
    st = Checkpointer(d).restore()
    assert st["converged"] and st["n_iter"] == plain.n_iter_
    np.testing.assert_allclose(st["state"], np.asarray(plain.cluster_centers_._dense()), atol=1e-4)
