"""The port's data-parallel training (heat_tpu_torch.nn.DataParallel,
heat_tpu_torch.optim, utils.data.synthetic_mnist, interop.params_from_reference)
against the JAX package's in a world of one: BASELINE config 4, the MNIST CNN
of benchmarks/cb/nn.py, from the same carried parameters -- forward,
value_and_grad, Adam steps and train_steps -- and the small modules."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

import heat_tpu as hj
import heat_tpu_torch as ht
from heat_tpu_torch.interop import params_from_reference
from heat_tpu_torch.nn import data_parallel

N, BATCH = 512, 128
LOSS_RTOL, PARAM_ATOL = 1e-5, 1e-5


class CNN(torch.nn.Module):
    """benchmarks/cb/nn.py's CNN: NHWC in, as flax's; a 3x3 "SAME"
    convolution of 16 channels, relu, a 2x2 average pool, flattened in
    (H, W, C) order as flax flattens, Dense 64, relu, Dense 10."""

    def __init__(self):
        super().__init__()
        self.conv = torch.nn.Conv2d(1, 16, 3, padding=1)
        self.dense0 = torch.nn.Linear(14 * 14 * 16, 64)
        self.dense1 = torch.nn.Linear(64, 10)

    def forward(self, x):
        t = F.avg_pool2d(F.relu(self.conv(x.permute(0, 3, 1, 2))), 2)
        t = t.permute(0, 2, 3, 1).reshape(t.shape[0], -1)
        return self.dense1(F.relu(self.dense0(t)))


def _ref_cnn():
    import flax.linen as lnn

    class RefCNN(lnn.Module):
        @lnn.compact
        def __call__(self, t):
            t = lnn.Conv(16, (3, 3))(t)
            t = lnn.relu(t)
            t = lnn.avg_pool(t, (2, 2), strides=(2, 2))
            t = t.reshape((t.shape[0], -1))
            t = lnn.Dense(64)(t)
            t = lnn.relu(t)
            return lnn.Dense(10)(t)

    return RefCNN()


def ref_loss(pred, target):
    return optax.softmax_cross_entropy_with_integer_labels(pred, target).mean()


def port_loss(pred, target):
    return F.cross_entropy(pred, target.long())


@pytest.fixture(scope="module")
def data():
    x, y = hj.utils.data.synthetic_mnist(N)
    return x.numpy(), y.numpy()


@pytest.fixture(scope="module")
def reference(data):
    """The reference's CNN on one device, initialised from PRNGKey(0), its
    parameters as numpy, and its trajectory: forward, value_and_grad, three
    Adam steps, then train_steps over the four batches from the start."""
    X, Y = data
    comm = hj.Communication(jax.devices()[:1])
    batches = [(X[i:i + BATCH], Y[i:i + BATCH]) for i in range(0, N, BATCH)]
    dp = hj.nn.DataParallel(_ref_cnn(), comm=comm, optimizer=optax.adam(1e-3))
    dp.init(jax.random.PRNGKey(0), jnp.asarray(X[:BATCH]))
    start = jax.tree_util.tree_map(np.asarray, dp.params)
    out = {"start": start, "forward": np.asarray(dp(jnp.asarray(X[:BATCH])))}
    loss, grads = dp.value_and_grad(ref_loss, jnp.asarray(X[:BATCH]), jnp.asarray(Y[:BATCH]))
    out["loss"], out["grads"] = float(loss), jax.tree_util.tree_map(np.asarray, grads)
    out["steps"] = []
    for xb, yb in batches[:3]:
        loss = dp.step(ref_loss, jnp.asarray(xb), jnp.asarray(yb))
        out["steps"].append((loss, jax.tree_util.tree_map(np.asarray, dp.params)))
    dp.set_params(start)
    out["scan"] = np.asarray(dp.train_steps(ref_loss, X.reshape(-1, BATCH, 28, 28, 1), Y.reshape(-1, BATCH)))
    out["scan_params"] = jax.tree_util.tree_map(np.asarray, dp.params)
    return out


def _port(reference, **kw):
    model = CNN()
    dp = ht.nn.DataParallel(model, optimizer=ht.optim.Adam(model.parameters(), lr=1e-3), **kw)
    dp.set_params(params_from_reference(reference["start"], model))
    return dp


def _assert_params(dp, ref_params):
    want = params_from_reference(ref_params, dp.module)
    for name, p in dp.params.items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), atol=PARAM_ATOL, rtol=0, err_msg=name)


@pytest.fixture(autouse=True)
def _on_the_cpu():
    ht.use_device("cpu")


def test_synthetic_mnist_is_the_references_bitwise():
    for n, seed in ((2048, 0), (1003, 3)):
        x, y = ht.utils.data.synthetic_mnist(n, seed=seed)
        rx, ry = hj.utils.data.synthetic_mnist(n, seed=seed)
        assert x.shape == (n, 28, 28, 1) and x.split == 0 and x.dtype == ht.float32 and y.dtype == ht.int32
        np.testing.assert_array_equal(x.numpy(), rx.numpy())
        np.testing.assert_array_equal(y.numpy(), ry.numpy())


def test_params_from_reference_lays_out_kernels_as_torch(reference):
    model = CNN()
    params = params_from_reference(reference["start"], model)
    tree = reference["start"]["params"]
    assert list(params) == [name for name, _ in model.named_parameters()]
    np.testing.assert_array_equal(params["conv.weight"].numpy(), tree["Conv_0"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(params["dense0.weight"].numpy(), tree["Dense_0"]["kernel"].T)
    np.testing.assert_array_equal(params["dense1.bias"].numpy(), tree["Dense_1"]["bias"])
    with pytest.raises(ValueError, match="does not fit"):
        params_from_reference(reference["start"], torch.nn.Sequential(
            torch.nn.Conv2d(1, 8, 3), torch.nn.Linear(3136, 64), torch.nn.Linear(64, 10)))
    with pytest.raises(ValueError, match="layers"):
        params_from_reference(reference["start"], torch.nn.Linear(4, 2))


def test_forward_and_value_and_grad_match_the_reference(reference, data):
    X, Y = data
    dp = _port(reference)
    out = dp(ht.array(X[:BATCH], split=0))
    assert out.shape == (BATCH, 10) and out.split == 0
    np.testing.assert_allclose(out.numpy(), reference["forward"], atol=1e-5, rtol=0)
    loss, grads = dp.value_and_grad(port_loss, ht.array(X[:BATCH], split=0), ht.array(Y[:BATCH], split=0))
    np.testing.assert_allclose(float(loss), reference["loss"], rtol=LOSS_RTOL)
    want = params_from_reference(reference["grads"], dp.module)
    assert set(grads) == set(want)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=1e-6, rtol=0, err_msg=name)
    _assert_params(dp, reference["start"])  # value_and_grad leaves the parameters as they were


@pytest.mark.parametrize("schedule", ["implicit", "bucketed", "fused"])
def test_adam_steps_match_the_reference(reference, data, schedule):
    X, Y = data
    dp = _port(reference, grad_reduction=schedule)
    for k, (want_loss, want_params) in enumerate(reference["steps"]):
        sl = slice(k * BATCH, (k + 1) * BATCH)
        loss = dp.step(port_loss, ht.array(X[sl], split=0), ht.array(Y[sl], split=0))
        np.testing.assert_allclose(loss, want_loss, rtol=LOSS_RTOL)
        _assert_params(dp, want_params)
    assert reference["steps"][-1][0] < reference["steps"][0][0]


def test_train_steps_match_sequential_steps_and_the_reference(reference, data):
    X, Y = data
    xs, ys = X.reshape(-1, BATCH, 28, 28, 1), Y.reshape(-1, BATCH)
    scan = _port(reference)
    losses = scan.train_steps(port_loss, xs, ys)
    assert losses.shape == (N // BATCH,)
    np.testing.assert_allclose(losses.numpy(), reference["scan"], rtol=LOSS_RTOL)
    _assert_params(scan, reference["scan_params"])
    seq = _port(reference)
    steps = [seq.step(port_loss, xs[k], ys[k]) for k in range(xs.shape[0])]
    np.testing.assert_array_equal(losses.numpy(), np.asarray(steps, np.float32))
    for name, p in scan.params.items():
        assert torch.equal(p, seq.params[name]), name
    with pytest.raises(ValueError, match="step axes"):
        scan.train_steps(port_loss, xs, ys[:2])


def test_a_new_loss_fn_takes_effect_on_the_next_step(reference, data):
    """The reference's test_step_rebuilds_on_new_loss_fn: eager torch has no
    program cache, so the contract holds by construction."""
    X, Y = data
    dp = _port(reference, grad_reduction="bucketed")
    x, y = X[:16], Y[:16]

    def big_constant(pred, target):
        return 42.0 + 0.0 * port_loss(pred, target)

    l1 = dp.step(port_loss, x, y)
    assert abs(dp.step(big_constant, x, y) - 42.0) < 1e-5
    losses = dp.train_steps(big_constant, X[:32].reshape(2, 16, 28, 28, 1), Y[:32].reshape(2, 16))
    np.testing.assert_allclose(losses.numpy(), 42.0, rtol=1e-6)
    assert float(dp.train_steps(port_loss, X[:32].reshape(2, 16, 28, 28, 1), Y[:32].reshape(2, 16))[0]) != 42.0
    assert l1 != 42.0


def test_init_draws_from_the_generator():
    def drawn(seed):
        model = CNN()
        dp = ht.nn.DataParallel(model).init(torch.Generator().manual_seed(seed), np.zeros((2, 28, 28, 1), np.float32))
        return dp.params

    a, b, c = drawn(3), drawn(3), drawn(4)
    for name in a:
        assert torch.equal(a[name], b[name]), name
    assert not torch.equal(a["dense0.weight"], c["dense0.weight"])
    assert not a["dense0.bias"].any() and not a["conv.bias"].any()
    w = a["dense0.weight"]
    std = 1.0 / np.sqrt(3136)
    assert float(w.abs().max()) <= 2 * std / 0.87962566103423978 and abs(float(w.std()) - std) < 0.05 * std


def test_schedules_options_and_refusals(reference, data):
    X, Y = data
    model = CNN()
    adam = ht.optim.Adam(model.parameters(), lr=1e-3)
    assert ht.nn.DataParallel(model).grad_reduction == "implicit"
    assert ht.nn.DataParallel(model, blocking_parameter_updates=True).grad_reduction == "fused"
    assert ht.nn.DataParallel(model, optimizer=ht.optim.DataParallelOptimizer(adam)).grad_reduction == "bucketed"
    fused = ht.nn.DataParallel(model, optimizer=ht.optim.DataParallelOptimizer(adam, blocking=True))
    assert fused.grad_reduction == "fused" and fused.optimizer is adam
    with pytest.raises(ValueError, match="grad_reduction"):
        ht.nn.DataParallel(model, grad_reduction="eager")
    with pytest.raises(TypeError, match="optimizer"):
        ht.nn.DataParallel(model, optimizer=optax.adam(1e-3))
    with pytest.raises(RuntimeError, match="optimizer"):
        ht.nn.DataParallel(model).step(port_loss, X[:4], Y[:4])
    with pytest.raises(KeyError):
        ht.nn.DataParallel(model).set_params({"conv.weight": np.zeros((16, 1, 3, 3), np.float32)})
    assert torch.backends.cudnn.allow_tf32 is False


def test_reduce_gradients_in_a_world_of_one():
    grads = [torch.full((n,), float(n)) for n in (5, 300, 7, 2000)]
    before = data_parallel.GRAD_BUCKETS
    bucketed = data_parallel.reduce_gradients(grads, bucket_bytes=4 * 400)
    assert data_parallel.GRAD_BUCKETS - before == 2  # 2000 alone, then 7, 300 and 5
    fused = data_parallel.reduce_gradients(grads, blocking=True)
    assert data_parallel.GRAD_BUCKETS - before == 3
    for g, b, f in zip(grads, bucketed, fused):
        assert torch.equal(g, b) and torch.equal(g, f)


def test_bucket_partition_matches_the_reference():
    from heat_tpu.nn.data_parallel import bucket_partition as ref_partition

    shapes = [(3, 4), (100,), (7, 7), (2,), (1000,), (5, 5)]
    leaves = [torch.zeros(s) for s in shapes]
    ref_leaves = [jnp.zeros(s, jnp.float32) for s in shapes]
    for bound in (None, 16, 400, 4000, 10**6):
        assert data_parallel.bucket_partition(leaves, bound) == ref_partition(ref_leaves, bound), bound
    mixed = [torch.zeros(3), torch.zeros(3, dtype=torch.float64), torch.zeros(3)]
    ref_mixed = [jnp.zeros(3), jnp.zeros(3, dtype=jnp.int32), jnp.zeros(3)]
    assert data_parallel.bucket_partition(mixed, None) == ref_partition(ref_mixed, None) == [[2], [1], [0]]


def test_optim_falls_through_to_torch():
    import torch.optim.lr_scheduler as sched

    assert ht.optim.Adam is torch.optim.Adam and ht.optim.SGD is torch.optim.SGD
    assert ht.optim.AdamW is torch.optim.AdamW
    assert ht.optim.lr_scheduler.StepLR is sched.StepLR
    assert ht.nn.Linear is torch.nn.Linear and ht.nn.DataParallel is data_parallel.DataParallel
    with pytest.raises(AttributeError):
        ht.optim.NoSuchOptimizer
    with pytest.raises(AttributeError):
        ht.optim.lr_scheduler.NoSuchScheduler


def test_data_parallel_optimizer():
    p = torch.nn.Parameter(torch.tensor([2.0]))
    opt = ht.optim.DataParallelOptimizer(torch.optim.SGD([p], lr=0.5))
    assert opt.schedule == "bucketed" and ht.optim.DataParallelOptimizer(opt.optimizer, True).schedule == "fused"
    p.grad = torch.tensor([1.0])
    opt.step()
    assert p.item() == 1.5  # the reference's test_dp_optimizer
    opt.zero_grad()
    assert p.grad is None
    with pytest.raises(TypeError):
        ht.optim.DataParallelOptimizer(optax.sgd(0.5))
    with pytest.raises(ValueError, match="blocking"):
        ht.optim.DataParallelOptimizer(opt.optimizer, blocking="yes")


@pytest.mark.parametrize("mode,threshold_mode", [("min", "rel"), ("min", "abs"), ("max", "rel"), ("max", "abs")])
def test_detect_metric_plateau_matches_the_reference(mode, threshold_mode):
    rng = np.random.default_rng(len(mode) + len(threshold_mode))
    metrics = np.concatenate([np.linspace(1.0, 0.5, 6), 0.5 + 1e-5 * rng.standard_normal(12), np.linspace(0.5, 2.0, 5)])
    got = ht.optim.DetectMetricPlateau(mode=mode, patience=2, threshold=1e-3, threshold_mode=threshold_mode)
    want = hj.optim.DetectMetricPlateau(mode=mode, patience=2, threshold=1e-3, threshold_mode=threshold_mode)
    assert [got.test_if_improving(m) for m in metrics] == [want.test_if_improving(m) for m in metrics]
    assert got.get_state() == want.get_state()
    fresh = ht.optim.DetectMetricPlateau()
    fresh.set_state(got.get_state())
    assert fresh.get_state() == got.get_state()
    with pytest.raises(ValueError):
        ht.optim.DetectMetricPlateau(mode="sideways")
