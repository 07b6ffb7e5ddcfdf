"""The port's per-collective accounting (heat_tpu_torch/parallel/comm.py)
against the JAX package's (heat_tpu/parallel/comm.py:88-110, :493-604).

Every collective evaluates the ``comm.collective`` fault site, adds one to
``comm.calls.{op}`` and payload x participants to ``comm.bytes.{op}``, under
one ``comm.{op}`` span whose ``bytes`` equal the counter and whose
``participants`` equal the size.  The reference accounts once per traced
program; the port once per call it issues, so single calls are compared
at world size 1 (the reference's collectives traced once under
``shard_map`` on a one-device mesh).  The gloo world of 3 in
``tests/test_torch_gloo.py`` checks the counts per rank."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import heat_tpu as hj
import heat_tpu_torch as ht
from heat_tpu import telemetry as r_tel
from heat_tpu_torch import telemetry as p_tel
from heat_tpu_torch.parallel import Communication, HierarchicalCommunication
from heat_tpu_torch.resilience import faults as p_faults

#: op name -> (the port's call, the reference's call inside shard_map)
COLLECTIVES = {
    "psum": (lambda c, t: c.psum(t), lambda c, v: c.psum(v)),
    "pmin": (lambda c, t: c.pmin(t), lambda c, v: c.pmin(v)),
    "pmax": (lambda c, t: c.pmax(t), lambda c, v: c.pmax(v)),
    "all_gather": (lambda c, t: c.all_gather(t), lambda c, v: c.all_gather(v)),
    "all_to_all": (lambda c, t: c.all_to_all(t, 0, 0), lambda c, v: c.all_to_all(v, 0, 0)),
    "psum_scatter": (lambda c, t: c.psum_scatter(t), lambda c, v: c.psum_scatter(v)),
    "ppermute": (lambda c, t: c.ppermute(t, [(0, 0)]), lambda c, v: c.ppermute(v, [(0, 0)])),
    "ring_shift": (lambda c, t: c.ring_shift(t), lambda c, v: c.ring_shift(v)),
    "pscan": (lambda c, t: c.pscan(t), lambda c, v: c.pscan(v)),
    "exscan": (lambda c, t: c.exscan(t), lambda c, v: c.exscan(v)),
}

#: the port's own collectives (no reference counterpart): op -> (call,
#: payload bytes per participant of a (4, 3) float32 x)
PORT_ONLY = {
    "pprod": (lambda c, t: c.pprod(t), 48),
    "bcast": (lambda c, t: c.bcast(t, 0), 48),
    "all_gather_varying": (lambda c, t: c.all_gather_varying(t, [4], 0), 48),
    "all_to_all_varying": (lambda c, t: c.all_to_all_varying([t], [4], 0), 48),
}


@pytest.fixture(autouse=True)
def _clean():
    ht.use_device("cpu")
    prev = (p_tel.set_tracing(True), r_tel.set_tracing(True))
    for tel in (p_tel, r_tel):
        tel.reset_all("comm")
        tel.clear_spans()
    yield
    p_tel.set_tracing(prev[0])
    r_tel.set_tracing(prev[1])


def _comm_counts(tel):
    return {k: v for k, v in tel.snapshot().items() if k.startswith("comm.") and v}


def _x():
    return np.arange(12, dtype=np.float32).reshape(4, 3)


@pytest.mark.parametrize("op", sorted(COLLECTIVES))
def test_one_call_counts_as_the_reference(op):
    port_call, ref_call = COLLECTIVES[op]
    port_call(Communication(size=1, rank=0), torch.from_numpy(_x()))
    rc = hj.Communication(jax.devices()[:1])
    jax.jit(jax.shard_map(lambda v: ref_call(rc, v), mesh=rc.mesh, in_specs=P(rc.axis_name),
                          out_specs=P(rc.axis_name), check_vma=False))(jnp.asarray(_x()))
    got, want = _comm_counts(p_tel), _comm_counts(r_tel)
    assert got == want
    assert got[f"comm.calls.{op}"] == 1


@pytest.mark.parametrize("op", sorted(COLLECTIVES) + sorted(PORT_ONLY))
def test_one_span_per_collective_carries_the_counted_bytes(op):
    """The contract of the reference's
    ``TestCommAccounting::test_collective_spans_carry_bytes``: one span per
    collective, its ``bytes`` equal to the counter, ``participants`` equal
    to the size."""
    call = COLLECTIVES[op][0] if op in COLLECTIVES else PORT_ONLY[op][0]
    comm = Communication(size=1, rank=0)
    call(comm, torch.from_numpy(_x()))
    recs = [r for r in p_tel.get_spans() if r.name.startswith("comm.")]
    assert [r.name for r in recs] == [f"comm.{op}"]
    snap = p_tel.snapshot()
    assert recs[0].attrs["bytes"] == snap[f"comm.bytes.{op}"]
    assert recs[0].attrs["participants"] == comm.size
    assert snap[f"comm.calls.{op}"] == 1
    if op in PORT_ONLY:
        assert snap[f"comm.bytes.{op}"] == PORT_ONLY[op][1]


@pytest.mark.parametrize("op", sorted(COLLECTIVES) + sorted(PORT_ONLY))
def test_every_collective_evaluates_the_fault_site(op):
    call = COLLECTIVES[op][0] if op in COLLECTIVES else PORT_ONLY[op][0]
    with p_faults.fault_plan({"comm.collective": [0]}) as inj:
        with pytest.raises(ht.resilience.TransientFault):
            call(Communication(size=1, rank=0), torch.from_numpy(_x()))
    assert inj.hits == {"comm.collective": 1}
    assert _comm_counts(p_tel) == {}  # the fault fires before the counters


def test_exscan_accounts_rounds_on_a_described_world():
    """pscan/exscan count log2(size) rounds (and the exclusive shift) of
    the payload, as the reference's ladder does (:573); a described world
    of 5 refuses the exchange after accounting it."""
    comm = Communication(size=5, rank=2)
    with pytest.raises(RuntimeError):
        comm.exscan(torch.ones(2))
    rounds = (5 - 1).bit_length() + 1
    assert _comm_counts(p_tel) == {"comm.calls.exscan": 1, "comm.bytes.exscan": 8 * 5 * rounds}


def test_account_implicit_as_the_reference():
    with Communication(size=1, rank=0).account_implicit("psum", 128, site="test"):
        pass
    with hj.Communication(jax.devices()[:1]).account_implicit("psum", 128, site="test"):
        pass
    assert _comm_counts(p_tel) == _comm_counts(r_tel) == {"comm.calls.psum": 1, "comm.bytes.psum": 128}
    for tel in (p_tel, r_tel):
        rec = tel.get_spans()[-1]
        assert rec.name == "comm.psum" and rec.attrs["implicit"] is True and rec.attrs["site"] == "test"


def test_hierarchical_axis_collectives_are_accounted():
    hc = HierarchicalCommunication(grid=(1, 1), size=1, rank=0)
    t = torch.ones(3)
    hc.psum(t, axis="node")
    hc.pmax(t, axis="global")
    hc.all_gather(t, mesh_axis=None)
    hc.bcast(t, 0, axis="node")
    assert _comm_counts(p_tel) == {f"comm.{w}.{op}": v for op in ("psum", "pmax", "all_gather", "bcast")
                                    for w, v in (("calls", 1), ("bytes", 12))}


def test_a_world_of_one_kmeans_fit_issues_no_lloyd_psum():
    """The Lloyd all-reduce is issued only on more than one rank, and the
    reference's ``_account_lloyd_psum`` is a no-op at size 1 likewise."""
    pts = np.random.default_rng(3).normal(size=(256, 8)).astype(np.float32)
    ht.cluster.KMeans(n_clusters=4, init="random", max_iter=5, random_state=0).fit(ht.array(pts, split=0))
    saved = hj.get_comm()
    hj.use_comm(hj.Communication(jax.devices()[:1]))
    try:
        hj.cluster.KMeans(n_clusters=4, init="random", max_iter=5, random_state=0).fit(hj.array(pts, split=0))
    finally:
        hj.use_comm(saved)
    assert "comm.calls.psum" not in _comm_counts(p_tel)
    assert "comm.calls.psum" not in _comm_counts(r_tel)


def test_summary_line_as_the_reference():
    for tel in (p_tel, r_tel):
        tel.counter("comm.bytes.psum").inc(2**30)
    for rate in (12.5, 0.0):
        got, want = p_tel.summary_line(iter_rate=rate), r_tel.summary_line(iter_rate=rate)
        assert got.split(" · ")[0] == want.split(" · ")[0] == "telemetry: comm 1.0000 GiB"
        assert got.split(" · ")[2] == want.split(" · ")[2]
