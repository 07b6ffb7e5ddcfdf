"""The port's DASO and DataParallelMultiGPU (heat_tpu_torch.optim.DASO,
heat_tpu_torch.nn.DataParallelMultiGPU, parallel.HierarchicalCommunication)
against the JAX package's in one process: the schedule state over the same
losses, the bfloat16 round trip bitwise, the delayed application, and
config 4's CNN trained on a (1, 1) grid from carried-over parameters.

A cross-node average rounds every parameter to bfloat16.  Where the two
packages' parameters differ by float32 rounding before it (about 1e-7), a
value near a bfloat16 rounding boundary may round to neighbouring bfloat16
values in the two (one bfloat16 ulp, up to 2^-8 of the value), and the
next average may round the drift apart once more.  So the parity runs
hold losses at rtol 1e-5 throughout, parameters at atol 1e-5 where one
average is taken (batch 0), and at atol 1e-5 or two bfloat16 ulps (the
largest seen: 2, on 10 steps of config 4) where averages land every other
batch.  An average every batch compounds the drift past that; there the
average is held bitwise against the round trip of the port's own
parameters (the delayed-application test, on SGD)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import heat_tpu as hj
import heat_tpu_torch as ht
from heat_tpu_torch.interop import from_reference_state, params_from_reference
from test_torch_data_parallel import CNN, _ref_cnn, port_loss, ref_loss

N, BATCH, STEPS = 512, 64, 10
LOSS_RTOL, PARAM_ATOL = 1e-5, 1e-5


@pytest.fixture(autouse=True)
def _on_the_cpu():
    ht.use_device("cpu")


def _ref_hier():
    return hj.parallel.HierarchicalCommunication(grid=(1, 1), devices=jax.devices()[:1])


def test_hierarchical_comm_of_one():
    hc = ht.parallel.HierarchicalCommunication()
    assert (hc.num_nodes, hc.node_size, hc.size, hc.rank) == (1, 1, 1, 0)
    assert (hc.global_axis, hc.node_axis) == ("global", "node")
    assert hc == ht.parallel.HierarchicalCommunication(grid=(1, 1)) and hash(hc) == hash(ht.parallel.HierarchicalCommunication())
    assert hc != ht.get_comm() and "nodes=1" in repr(hc)
    assert type(hc.split([0])) is ht.parallel.Communication
    with pytest.raises(ValueError):
        ht.parallel.HierarchicalCommunication(grid=(2, 2))
    one = hc.reshape(1)  # the grid of the ranks that stay: still (1, 1)
    assert isinstance(one, ht.parallel.HierarchicalCommunication) and (one.num_nodes, one.node_size) == (1, 1)
    assert hc.retired and not one.retired
    with pytest.raises(ht.resilience.ReshapeError):
        hc.reshape(2)
    # a described grid of 2 x 3: the layout questions of a world of six
    d = ht.parallel.HierarchicalCommunication(grid=(2, 3), size=6, rank=4)
    assert (d.node_index, d.node_comm.rank, d.global_comm.rank) == (1, 1, 1)
    np.testing.assert_array_equal(d.lshape_map((17, 3), 0), ht.parallel.Communication(size=6, rank=4).lshape_map((17, 3), 0))
    x = ht.arange(17, dtype=ht.float32, split=0, comm=hc)
    assert float(ht.sum(x)) == float(np.arange(17).sum())


@pytest.mark.parametrize("hosts,grid", [(["a"] * 4, (1, 4)), (["a", "a", "b", "b"], (2, 2)), (["a", "b", "a", "b"], (1, 4)),
                                        (["a", "a", "a", "b"], (1, 4)), (["a", "b", "c"], (3, 1))])
def test_infer_grid_is_one_node_a_host(hosts, grid):
    assert ht.parallel.HierarchicalCommunication.infer_grid(hosts) == grid


def _schedules():
    """The reference's and the port's DASO driven by one loss sequence over
    12 epochs: warm-up, the doubling and halving of global_skip, cool-down."""
    losses = [5.0, 4.0, 3.5, 3.4, 3.39, 3.389, 3.388, 3.0, 2.9, 2.89, 2.889, 2.888]
    ref = hj.optim.DASO(optax.sgd(0.1), total_epochs=12, comm=_ref_hier(), warmup_epochs=2, cooldown_epochs=2,
                        max_global_skips=8)
    p = torch.zeros(3, requires_grad=True)
    port = ht.optim.DASO(ht.optim.SGD([p], lr=0.1), total_epochs=12, comm=ht.parallel.HierarchicalCommunication(),
                         warmup_epochs=2, cooldown_epochs=2, max_global_skips=8)
    states = []
    for loss in losses:
        for d in (ref, port):
            d.epoch_loss_logic(loss)
            d.next_epoch()
        states.append((ref.get_state(), port.get_state()))
    return states


def test_schedule_state_is_the_references():
    states = _schedules()
    for want, got in states:
        assert got == want
    skips = [w["global_skip"] for w, _ in states]
    assert max(skips) == 8 and 0 in skips  # doubled up to the cap, zero in warm-up and cool-down


def test_set_state_round_trip():
    _, got = _schedules()[5]
    p = torch.zeros(2, requires_grad=True)
    d = ht.optim.DASO(ht.optim.SGD([p], lr=0.1), total_epochs=12)
    d.set_state(got)
    assert d.get_state() == got
    assert not d.hierarchical


def test_bf16_round_trip_is_the_references_bitwise():
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((64, 33)) * 10.0 ** rng.integers(-6, 6, (64, 1))).astype(np.float32)
    w.reshape(-1)[:4] = [np.float32(1.00390625), np.float32(-1.01171875), 3.0e38, 1e-40]  # ties, overflow, subnormal
    ref = hj.optim.DASO(optax.sgd(0.0), total_epochs=1, warmup_epochs=0, cooldown_epochs=0)
    want = np.asarray(ref._bf16_roundtrip({"w": jnp.asarray(w)})["w"])
    p = torch.tensor(w)
    port = ht.optim.DASO(ht.optim.SGD([p], lr=0.0), total_epochs=1, warmup_epochs=0, cooldown_epochs=0)
    got = port._global_average([p])[0].numpy()
    assert got.tobytes() == want.tobytes()
    hier = ht.optim.DASO(ht.optim.SGD([p], lr=0.0), total_epochs=1, comm=ht.parallel.HierarchicalCommunication())
    assert hier._global_average([p])[0].numpy().tobytes() == want.tobytes()  # the mean over one node
    hier2 = ht.optim.DASO(ht.optim.SGD([p], lr=0.0), total_epochs=1, comm=ht.parallel.HierarchicalCommunication(),
                          sending_chunk_size=100)  # in chunks
    assert hier2._global_average([p])[0].numpy().tobytes() == want.tobytes()


@pytest.mark.parametrize("skip,wait", [(0, 0), (2, 1), (3, 2)])
def test_delayed_application_is_the_references(skip, wait):
    """SGD steps on fixed gradients: the average scheduled at batch t
    replaces the parameters at batch t + wait, as the reference's."""
    rng = np.random.default_rng(1)
    w0 = rng.standard_normal(16).astype(np.float32)
    grads = [rng.standard_normal(16).astype(np.float32) for _ in range(8)]
    ref = hj.optim.DASO(optax.sgd(0.5), total_epochs=1, comm=_ref_hier(), warmup_epochs=0, cooldown_epochs=0)
    p = torch.tensor(w0, requires_grad=True)
    port = ht.optim.DASO(ht.optim.SGD([p], lr=0.5), total_epochs=1, comm=ht.parallel.HierarchicalCommunication(),
                         warmup_epochs=0, cooldown_epochs=0)
    for d in (ref, port):
        d.global_skip, d.batches_to_wait = skip, wait
    rp = ref.replicate({"w": jnp.asarray(w0)})
    scheduled = {}
    for t, g in enumerate(grads):
        rp = ref.step(rp, {"w": jnp.asarray(g)[None]})
        p.grad = torch.tensor(g)
        before = port._pending
        port.step()
        if port._pending is not None and port._pending is not before:
            scheduled[t + wait] = port._pending[1][0].clone()
        if t in scheduled and wait:  # the average landed: the bf16 round trip of batch t - wait's parameters
            assert p.detach().numpy().tobytes() == scheduled[t].numpy().tobytes()
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(rp["w"])[0], rtol=0, atol=1e-6)
    rp = ref.last_batch(rp)
    port.last_batch()
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(ref.collect(rp)["w"]), rtol=0, atol=1e-6)
    assert port._pending is None


def _bf16_ulp(v: np.ndarray) -> np.ndarray:
    """One bfloat16 ulp at each value: 2^(exponent - 7)."""
    return np.ldexp(1.0, np.frexp(np.abs(v).astype(np.float64))[1] - 8)


@pytest.fixture(scope="module")
def mnist():
    x, y = hj.utils.data.synthetic_mnist(N)
    return x.numpy(), y.numpy()


def _batches(X, Y):
    return [(X[i * BATCH % N:i * BATCH % N + BATCH], Y[i * BATCH % N:i * BATCH % N + BATCH]) for i in range(STEPS)]


@pytest.mark.parametrize("skip,wait", [(100, 0), (2, 1)])
def test_data_parallel_multi_gpu_matches_reference(mnist, skip, wait):
    X, Y = mnist
    daso = hj.optim.DASO(optax.adam(1e-3), total_epochs=4, comm=_ref_hier(), warmup_epochs=0, cooldown_epochs=0)
    daso.global_skip, daso.batches_to_wait = skip, wait
    dp = hj.nn.DataParallelMultiGPU(_ref_cnn(), daso=daso)
    dp.init(jax.random.PRNGKey(0), jnp.asarray(X[:BATCH]))
    state = daso.get_state()
    replicas = jax.tree_util.tree_map(np.asarray, dp.params)
    ref_losses = [dp.step(ref_loss, jnp.asarray(xb), jnp.asarray(yb)) for xb, yb in _batches(X, Y)]
    ref_params = jax.tree_util.tree_map(np.asarray, daso.collect(daso.last_batch(dp.params)))

    model = CNN()
    doc = {"kind": "DASO", "params": {"total_epochs": 4, "warmup_epochs": 0, "cooldown_epochs": 0},
           "state": state, "replicas": replicas}
    port = from_reference_state(doc, comm=ht.parallel.HierarchicalCommunication(),
                                optimizer=ht.optim.Adam(model.parameters(), lr=1e-3), module=model)
    start = params_from_reference(jax.tree_util.tree_map(lambda a: a[0], replicas), model)
    for name, p in model.named_parameters():
        assert p.detach().numpy().tobytes() == start[name].numpy().tobytes()
    assert (port.global_skip, port.batches_to_wait) == (skip, wait)
    pdp = ht.nn.DataParallelMultiGPU(model, daso=port)
    losses = [pdp.step(port_loss, ht.array(xb, split=0), ht.array(yb, split=0)) for xb, yb in _batches(X, Y)]
    port.last_batch()
    np.testing.assert_allclose(losses, ref_losses, rtol=LOSS_RTOL)
    want = params_from_reference(ref_params, model)
    for name, p in pdp.collect_params().items():
        got, w = p.numpy(), want[name].numpy()
        if skip == 100:
            np.testing.assert_allclose(got, w, rtol=0, atol=PARAM_ATOL, err_msg=name)
        else:
            assert np.all((np.abs(got - w) <= PARAM_ATOL) | (np.abs(got - w) <= 2 * _bf16_ulp(w))), name


def test_data_parallel_multi_gpu_checks():
    model = CNN()
    opt = ht.optim.Adam(model.parameters(), lr=1e-3)
    plain = ht.optim.DASO(opt, total_epochs=1)
    with pytest.raises(ValueError):
        ht.nn.DataParallelMultiGPU(model, daso=plain)
    hier = ht.optim.DASO(opt, total_epochs=1, comm=ht.parallel.HierarchicalCommunication())
    with pytest.raises(ValueError):
        ht.nn.DataParallelMultiGPU(model, comm=ht.parallel.HierarchicalCommunication(grid=(1, 1), size=1, rank=0),
                                   daso=hier)
    dp = ht.nn.DataParallelMultiGPU(model, optimizer=opt)
    assert dp.daso.hierarchical and dp.daso.total_epochs == 1 and isinstance(dp.comm, ht.parallel.HierarchicalCommunication)
    with pytest.raises(NotImplementedError):
        dp.train_steps(port_loss, torch.zeros(2, 4, 28, 28, 1), torch.zeros(2, 4))
    x = torch.randn(8, 28, 28, 1, generator=torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(dp(x).detach().numpy(), model(x).detach().numpy())
    assert set(dp.collect_params()) == {n for n, _ in model.named_parameters()}
