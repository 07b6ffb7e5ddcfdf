"""The hierarchy in a world of 4 CPU ranks (torch.distributed, gloo) against
heat_tpu on ``jax.devices()[:4]``, grids (2, 2) and (4, 1): the topology and
the node and global groups' collectives; split arrays on a hierarchical
communication (the plain one's layout); DASO's cross-node average (bitwise
on 2 nodes, within one bfloat16 ulp on 4) and its delayed application;
DataParallelMultiGPU with DASO training the reference test's MLP
(tests/test_daso_hier.py:158-198); a DataLoader over a split Dataset (no
all-gather of rows); and ``gradient`` with coordinates and ``trapz`` with
N-D sample points along the split axis (their halos).

One world of 4 rank processes (tests/torch_world.py) runs the slices in
turn, each within its 60 s; the reference computes while the ranks run.
The MLP's losses are held at rtol 1e-5 and its parameters at atol 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

import heat_tpu as hj
from torch_world import spawned

pytestmark = pytest.mark.multiprocess

SIZE = 4
GRIDS = [(2, 2), (4, 1)]
STEPS = 10

_TOPOLOGY_MAIN = r"""
saved = {}
for n_node, per_node in ((2, 2), (4, 1)):
    tag = f"{n_node}x{per_node}"
    hc = ht.parallel.HierarchicalCommunication(grid=(n_node, per_node))
    saved[tag + "/meta"] = np.array([hc.num_nodes, hc.node_size, hc.size, hc.rank, hc.node_index,
                                     hc.node_comm.size, hc.node_comm.rank, hc.global_comm.size, hc.global_comm.rank])
    for axis in ("node", "global", None, ("global", "node")):
        v = torch.tensor([float(rank + 1)])
        saved[f"{tag}/psum/{axis}"] = hc.psum(v, axis=axis).numpy()
    saved[tag + "/gather_global"] = hc.all_gather(torch.tensor([rank]), mesh_axis="global").numpy()
    saved[tag + "/eq"] = np.array([hc == hc, hc != ht.get_comm(), hash(hc) == hash(hc)])
    x = ht.arange(17, dtype=ht.float32, split=0, comm=hc)
    saved[tag + "/lshape_map"] = np.asarray(x.lshape_map)
    saved[tag + "/plain_lshape_map"] = np.asarray(ht.arange(17, dtype=ht.float32, split=0).lshape_map)
    saved[tag + "/local"] = x.larray.numpy()
    saved[tag + "/sum"] = np.asarray(float(ht.sum(x * x)))
    sub = ht.get_comm().split([0, 2])
    saved[tag + "/split"] = np.array([sub.size if rank in (0, 2) else -1, sub.rank if rank in (0, 2) else -1])
    # the cross-node average of each node's bf16 parameters
    w = torch.tensor(arrays["replicas"][rank // per_node])
    opt = ht.optim.SGD([w], lr=0.0)
    daso = ht.optim.DASO(opt, total_epochs=1, comm=hc, sending_chunk_size=50)
    saved[tag + "/avg"] = daso._global_average([w])[0].numpy()
np.savez(out, **saved)
"""

_DELAYED_MAIN = r"""
saved = {}
for n_node, per_node in ((2, 2), (4, 1)):
    tag = f"{n_node}x{per_node}"
    hc = ht.parallel.HierarchicalCommunication(grid=(n_node, per_node))
    node = rank // per_node
    w = torch.tensor(arrays["w0"][node], requires_grad=True)
    daso = ht.optim.DASO(ht.optim.SGD([w], lr=0.5), total_epochs=1, comm=hc, warmup_epochs=0, cooldown_epochs=0)
    daso.global_skip, daso.batches_to_wait = 2, 1
    for t in range(6):
        w.grad = torch.tensor(arrays["grads"][t, node])
        daso.step()
        saved[f"{tag}/w{t}"] = w.detach().numpy().copy()
    daso.last_batch()
    saved[tag + "/last"] = w.detach().numpy().copy()
np.savez(out, **saved)
"""

_TRAIN_MAIN = r"""
import torch.nn.functional as F
from heat_tpu_torch.interop import params_from_reference

saved = {}
for n_node, per_node in ((2, 2), (4, 1)):
    tag = f"{n_node}x{per_node}"
    hc = ht.parallel.HierarchicalCommunication(grid=(n_node, per_node))
    model = torch.nn.Sequential(torch.nn.Linear(8, 32), torch.nn.ReLU(), torch.nn.Linear(32, 2))
    start = {"params": {"Dense_0": {"kernel": arrays["k0"], "bias": arrays["b0"]},
                        "Dense_1": {"kernel": arrays["k1"], "bias": arrays["b1"]}}}
    daso = ht.optim.DASO(ht.optim.Adam(model.parameters(), lr=1e-2), total_epochs=100, comm=hc, warmup_epochs=0,
                         cooldown_epochs=0)
    daso.global_skip, daso.batches_to_wait = 4, 0
    dp = ht.nn.DataParallelMultiGPU(model, daso=daso)
    dp.set_params(params_from_reference(start, model))
    X = ht.array(arrays["X"], split=0, comm=hc)
    y = ht.array(arrays["y"], split=0, comm=hc)
    saved[tag + "/losses"] = np.array([dp.step(lambda p, t: F.cross_entropy(p, t.long()), X, y) for _ in range(10)])
    daso.last_batch()
    for name, p in dp.collect_params().items():
        saved[f"{tag}/{name}"] = p.numpy()
np.savez(out, **saved)
"""

_LOADER_MAIN = r"""
saved = {}
gathers = []
for fname in ("all_gather", "all_gather_varying"):
    fn = getattr(ht.Communication, fname)

    def recording(self, x, *args, _fn=fn, _name=fname, **kw):
        gathers.append((_name, int(x.numel())))
        return _fn(self, x, *args, **kw)

    setattr(ht.Communication, fname, recording)
x = ht.array(arrays["x"], split=0)
y = ht.array(arrays["y"], split=0)
ht.random.seed(5)
loader = ht.utils.data.DataLoader(ht.utils.data.Dataset([x, y]), batch_size=8, shuffle=True)
for i, (xb, yb) in enumerate(loader):
    saved[f"x{i}"] = xb.larray.numpy()
    saved[f"y{i}"] = yb.larray.numpy()
    saved[f"split{i}"] = np.array([-1 if xb.split is None else xb.split])
saved["batches"] = np.array([i + 1])
saved["gathered_elements"] = np.array([max([n for _, n in gathers], default=0)])
np.savez(out, **saved)
"""

_HALO_MAIN = r"""
saved = {}
f = ht.array(arrays["f"], split=0)
saved["grad0"] = ht.gradient(f, arrays["x0"], axis=0).larray.numpy()
saved["grad0_split_coords"] = ht.gradient(f, ht.array(arrays["x0"], split=0), axis=0).larray.numpy()
g = ht.gradient(f, arrays["x0"], arrays["x1"])
saved["grad_both0"], saved["grad_both1"] = g[0].larray.numpy(), g[1].larray.numpy()
saved["trapz0"] = ht.trapz(f, ht.array(arrays["xs"], split=0), axis=0).numpy()
saved["trapz0_whole_x"] = ht.trapz(f, arrays["xs"], axis=0).numpy()
saved["trapz0_x_split1"] = ht.trapz(f, ht.array(arrays["xs"], split=1), axis=0).numpy()
saved["trapz1"] = ht.trapz(f, ht.array(arrays["xs1"], split=0), axis=1).larray.numpy()
np.savez(out, **saved)
"""


def _replicas():
    rng = np.random.default_rng(0)
    r = (rng.standard_normal((4, 300)) * 3).astype(np.float32)
    r[:, :3] = [[1.00390625, -1.01171875, 0.5]] * 4  # bf16 ties in every replica
    return r


def _mlp_data():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(48, 8)).astype(np.float32)
    w_true = rng.normal(size=(8,)).astype(np.float32)
    return X, (X @ w_true > 0).astype(np.int32)


def _mlp():
    import flax.linen as lnn

    class MLP(lnn.Module):
        @lnn.compact
        def __call__(self, x):
            x = lnn.Dense(32)(x)
            x = lnn.relu(x)
            return lnn.Dense(2)(x)

    return MLP()


def _train_inputs():
    X, y = _mlp_data()
    start = _mlp().init(jax.random.PRNGKey(0), jnp.asarray(X))["params"]
    arrays = {"X": X, "y": y, "k0": np.asarray(start["Dense_0"]["kernel"]), "b0": np.asarray(start["Dense_0"]["bias"]),
              "k1": np.asarray(start["Dense_1"]["kernel"]), "b1": np.asarray(start["Dense_1"]["bias"])}
    return arrays, None


def _delayed_inputs():
    rng = np.random.default_rng(2)
    return {"w0": rng.standard_normal((4, 16)).astype(np.float32),
            "grads": rng.standard_normal((6, 4, 16)).astype(np.float32)}, None


def _loader_inputs():
    rng = np.random.default_rng(4)
    return {"x": rng.standard_normal((37, 5)).astype(np.float32), "y": np.arange(37, dtype=np.int32)}, None


def _halo_inputs():
    rng = np.random.default_rng(6)
    f = rng.standard_normal((13, 5)).astype(np.float32)
    xs = np.cumsum(rng.random((13, 5)) + 0.1, axis=0).astype(np.float32)
    return {"f": f, "x0": np.cumsum(rng.random(13) + 0.1).astype(np.float32),
            "x1": np.cumsum(rng.random(5) + 0.1).astype(np.float32), "xs": xs,
            "xs1": np.cumsum(rng.random((13, 5)) + 0.1, axis=1).astype(np.float32)}, None


_SLICES = {
    "topology": (_TOPOLOGY_MAIN, lambda: ({"replicas": _replicas()}, None)),
    "delayed": (_DELAYED_MAIN, _delayed_inputs),
    "train": (_TRAIN_MAIN, _train_inputs),
    "loader": (_LOADER_MAIN, _loader_inputs),
    "halo": (_HALO_MAIN, _halo_inputs),
}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    with spawned(tmp_path_factory.mktemp("daso"), _SLICES, size=SIZE) as w:
        yield w


def _ref_hier(grid):
    return hj.parallel.HierarchicalCommunication(grid=grid, devices=jax.devices()[:SIZE])


def _tag(grid):
    return f"{grid[0]}x{grid[1]}"


def _bf16_ulp(v):
    return np.ldexp(1.0, np.frexp(np.abs(v).astype(np.float64))[1] - 8)


@pytest.mark.parametrize("grid", GRIDS)
def test_topology_and_split_arrays(world, grid):
    ranks = world.ranks("topology")
    tag, (n_node, per_node) = _tag(grid), grid
    comm = _ref_hier(grid)
    want = hj.arange(17, dtype=hj.float32, split=0, comm=comm)
    for r, got in enumerate(ranks):
        node, local = divmod(r, per_node)
        assert got[tag + "/meta"].tolist() == [n_node, per_node, SIZE, r, node, per_node, local, n_node, node]
        assert (comm.num_nodes, comm.node_size) == (n_node, per_node)
        node_ranks = [node * per_node + j for j in range(per_node)]
        assert got[f"{tag}/psum/node"][0] == sum(q + 1 for q in node_ranks)
        assert got[f"{tag}/psum/global"][0] == sum(i * per_node + local + 1 for i in range(n_node))
        assert got[f"{tag}/psum/None"][0] == got[f"{tag}/psum/('global', 'node')"][0] == 10
        assert got[tag + "/gather_global"].tolist() == [i * per_node + local for i in range(n_node)]
        assert got[tag + "/eq"].all()
        np.testing.assert_array_equal(got[tag + "/lshape_map"], got[tag + "/plain_lshape_map"])
        np.testing.assert_array_equal(got[tag + "/lshape_map"], np.asarray(want.lshape_map))
        assert float(got[tag + "/sum"]) == float(hj.sum(want * want))
        assert got[tag + "/split"].tolist() == ([2, [0, 2].index(r)] if r in (0, 2) else [-1, -1])
    np.testing.assert_array_equal(np.concatenate([got[tag + "/local"] for got in ranks]), np.arange(17))


@pytest.mark.parametrize("grid", GRIDS)
def test_cross_node_average(world, grid):
    ranks = world.ranks("topology")
    tag, (n_node, per_node) = _tag(grid), grid
    replicas = world["topology"][0]["replicas"][:n_node]
    daso = hj.optim.DASO(optax.sgd(0.0), total_epochs=1, comm=_ref_hier(grid))
    want = np.asarray(daso._bf16_roundtrip({"w": jnp.asarray(replicas)})["w"])
    for got in ranks:
        if n_node == 2:
            assert got[tag + "/avg"].tobytes() == want[0].tobytes()
        else:
            assert np.all(np.abs(got[tag + "/avg"] - want[0]) <= _bf16_ulp(want[0]))
        assert got[tag + "/avg"].tobytes() == ranks[0][tag + "/avg"].tobytes()  # every node the same


@pytest.mark.parametrize("grid", GRIDS)
def test_delayed_application(world, grid):
    ranks = world.ranks("delayed")
    tag, (n_node, per_node) = _tag(grid), grid
    arrays = world["delayed"][0]
    daso = hj.optim.DASO(optax.sgd(0.5), total_epochs=1, comm=_ref_hier(grid), warmup_epochs=0, cooldown_epochs=0)
    daso.global_skip, daso.batches_to_wait = 2, 1
    p = {"w": jnp.asarray(arrays["w0"][:n_node])}
    for t in range(6):
        p = daso.step(p, {"w": jnp.asarray(arrays["grads"][t, :n_node])})
        want = np.asarray(p["w"])
        for r, got in enumerate(ranks):
            w = want[r // per_node]
            assert np.all(np.abs(got[f"{tag}/w{t}"] - w) <= np.maximum(1e-6, _bf16_ulp(w))), (t, r)
    last = np.asarray(daso.last_batch(p)["w"])
    for r, got in enumerate(ranks):
        assert np.all(np.abs(got[tag + "/last"] - last[r // per_node]) <= np.maximum(1e-6, _bf16_ulp(last[0])))


@pytest.mark.parametrize("grid", GRIDS)
def test_data_parallel_multi_gpu_trains_as_the_reference(world, grid):
    ranks = world.ranks("train")
    tag, (n_node, per_node) = _tag(grid), grid
    arrays = world["train"][0]
    X, y = arrays["X"], arrays["y"]
    daso = hj.optim.DASO(optax.adam(1e-2), total_epochs=100, comm=_ref_hier(grid), warmup_epochs=0,
                         cooldown_epochs=0)
    daso.global_skip, daso.batches_to_wait = 4, 0
    dp = hj.nn.DataParallelMultiGPU(_mlp(), daso=daso)
    dp.set_params({"params": {"Dense_0": {"kernel": arrays["k0"], "bias": arrays["b0"]},
                              "Dense_1": {"kernel": arrays["k1"], "bias": arrays["b1"]}}})

    def loss_fn(pred, target):
        return optax.softmax_cross_entropy_with_integer_labels(pred, target).mean()

    losses = [dp.step(loss_fn, X, y) for _ in range(STEPS)]
    final = daso.last_batch(dp.params)["params"]  # per node: the last batch's replicas need not agree
    names = {"0.weight": ("Dense_0", "kernel"), "0.bias": ("Dense_0", "bias"), "2.weight": ("Dense_1", "kernel"),
             "2.bias": ("Dense_1", "bias")}
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got[tag + "/losses"], losses, rtol=1e-5)
        for name, (layer, leaf) in names.items():
            w = np.asarray(final[layer][leaf])[r // per_node]
            w = w.T if leaf == "kernel" else w
            np.testing.assert_allclose(got[f"{tag}/{name}"], w, rtol=0, atol=1e-5, err_msg=name)
    assert losses[-1] < losses[0]


def test_data_loader_over_a_split_dataset_gathers_no_rows(world):
    ranks = world.ranks("loader")
    arrays = world["loader"][0]
    x, y = arrays["x"], arrays["y"]
    hj.random.seed(5)
    rl = hj.utils.data.DataLoader(hj.utils.data.Dataset([hj.array(x, split=0), hj.array(y, split=0)]), batch_size=8)
    want = list(rl)
    assert int(ranks[0]["batches"][0]) == len(want) == 5
    for i, (wx, wy) in enumerate(want):
        got_x = np.concatenate([got[f"x{i}"] for got in ranks])
        got_y = np.concatenate([got[f"y{i}"] for got in ranks])
        assert got_x.tobytes() == np.asarray(wx).tobytes() and got_y.tobytes() == np.asarray(wy).tobytes()
        assert all(int(got[f"split{i}"][0]) == 0 for got in ranks)
    # no collective handed a rank more elements than the batches' index counts
    assert all(int(got["gathered_elements"][0]) <= SIZE for got in ranks)


def test_gradient_and_trapz_along_the_split_axis(world):
    ranks = world.ranks("halo")
    a = world["halo"][0]
    comm = hj.Communication(jax.devices()[:SIZE])
    f = hj.array(a["f"], split=0, comm=comm)

    def whole(key):
        return np.concatenate([got[key] for got in ranks])

    np.testing.assert_allclose(whole("grad0"), hj.gradient(f, a["x0"], axis=0).numpy(), rtol=3e-5, atol=1e-6)
    np.testing.assert_allclose(whole("grad0_split_coords"), hj.gradient(f, a["x0"], axis=0).numpy(), rtol=3e-5, atol=1e-6)
    g = hj.gradient(f, a["x0"], a["x1"])
    np.testing.assert_allclose(whole("grad_both0"), g[0].numpy(), rtol=3e-5, atol=1e-6)
    np.testing.assert_allclose(whole("grad_both1"), g[1].numpy(), rtol=3e-5, atol=1e-6)
    t0 = hj.trapz(f, hj.array(a["xs"], split=0, comm=comm), axis=0).numpy()
    for got in ranks:
        for key in ("trapz0", "trapz0_whole_x", "trapz0_x_split1"):
            np.testing.assert_allclose(got[key], t0, rtol=3e-5, atol=1e-6)
    np.testing.assert_allclose(whole("trapz1"), hj.trapz(f, a["xs1"], axis=1).numpy(), rtol=3e-5, atol=1e-6)
