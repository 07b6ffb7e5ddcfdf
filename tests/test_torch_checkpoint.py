"""The port's checkpoints, async saves and preemption gate
(heat_tpu_torch/utils/checkpoint.py, utils/overlap.py, core/preempt.py)
against the JAX package's: the native format byte for byte both ways (the
same state.json, the same npz members bitwise, the same CRC32 sidecars,
with zipfile's clock pinned: a zip member records the time it was written),
steps, pruning, templates, faults, checksums, the async writer's bounds and
the gate's accounting, in one process (a world of one)."""

import json
import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import heat_tpu as hj
import heat_tpu_torch as ht
from heat_tpu import resilience as hrz
from heat_tpu.core import preempt as ref_preempt
from heat_tpu.telemetry import journal as ref_journal
from heat_tpu.utils import checkpoint as ref_ckpt
from heat_tpu.utils import overlap as ref_overlap
from heat_tpu_torch import resilience as rz
from heat_tpu_torch.core import preempt
from heat_tpu_torch.telemetry import journal
from heat_tpu_torch.utils import checkpoint, overlap


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    ht.use_device("cpu")
    monkeypatch.setenv("HEAT_TPU_RETRY_NO_SLEEP", "1")


X = np.arange(35, dtype=np.float32).reshape(7, 5) * 0.25
BF16 = np.array([0.0, 1.0, -2.5, 3.140625, 1e-3], dtype=np.float32)  # the last one is not a bfloat16 value


def _ref_state():
    one = hj.Communication(jax.devices()[:1])
    return {
        "w": np.linspace(-1, 1, 6).reshape(2, 3),
        "b": jnp.asarray([1.0, 2.0, 3.0], jnp.float32),
        "meta": ["a", 2, (3.5, None)],
        "c": 1.5 - 2j,
        "x": hj.array(X, split=0, comm=one),
        "h": np.asarray(jnp.asarray(BF16, jnp.bfloat16)),
        "n": None,
        "k": np.int64(7),
    }


def _port_state():
    return {
        "w": np.linspace(-1, 1, 6).reshape(2, 3),
        "b": torch.tensor([1.0, 2.0, 3.0]),
        "meta": ["a", 2, (3.5, None)],
        "c": 1.5 - 2j,
        "x": ht.array(X, split=0),
        "h": torch.from_numpy(BF16).to(torch.bfloat16),
        "n": None,
        "k": np.int64(7),
    }


def _pinned_clock(monkeypatch):
    """zipfile stamps each member with time.localtime(): pin it, so that two
    writes of the same arrays are the same bytes."""
    fixed = time.struct_time((2026, 1, 2, 3, 4, 6, 4, 2, 0))
    monkeypatch.setattr(time, "localtime", lambda *a: fixed)


def _files(d, step):
    root = os.path.join(d, f"step_{step}")
    return {name: open(os.path.join(root, name), "rb").read() for name in sorted(os.listdir(root))}


def _bf16_bits(t):
    return t.view(torch.int16).numpy()


def test_nested_tree_round_trips(tmp_path):
    """Every node type: dict, list, tuple, complex, None, strings, a float64
    array, a bfloat16 tensor (back as bfloat16, bitwise), a split DNDarray
    (back as its global value, or on a communication as a DNDarray)."""
    ck = checkpoint.Checkpointer(str(tmp_path / "ck"))
    state = _port_state()
    ck.save(4, state, extra_metadata={"epoch": 2})
    back = ck.restore()
    assert back["meta"] == ["a", 2, (3.5, None)] and back["c"] == 1.5 - 2j and back["n"] is None
    assert back["w"].dtype == np.float64 and np.array_equal(back["w"], state["w"])
    assert back["b"].dtype == np.float32 and np.array_equal(back["b"], state["b"].numpy())
    assert back["h"].dtype == torch.bfloat16 and np.array_equal(_bf16_bits(back["h"]), _bf16_bits(state["h"]))
    assert np.array_equal(back["x"], X) and back["k"] == 7
    on = ck.restore(4, comm=ht.get_comm())
    assert isinstance(on["x"], ht.DNDarray) and on["x"].split == 0 and np.array_equal(on["x"].numpy(), X)
    assert ck.metadata(4) == {"epoch": 2} and ck.world_size() == 1 and ck.all_steps() == [4]


def test_a_step_of_the_jax_package_restores_in_the_port_and_back(tmp_path, monkeypatch):
    """The same tree through both writers: state.json the same document (and
    bytes), arrays.npz the same members bitwise (and bytes, the clock
    pinned), the same CRC32 sidecars; each package restores the other's
    step to the same values."""
    _pinned_clock(monkeypatch)
    ref_dir, port_dir = str(tmp_path / "ref"), str(tmp_path / "port")
    ref_ckpt.Checkpointer(ref_dir).save(3, _ref_state())
    checkpoint.Checkpointer(port_dir).save(3, _port_state())
    ref_files, port_files = _files(ref_dir, 3), _files(port_dir, 3)
    assert sorted(port_files) == ["arrays.npz", "arrays.npz.crc32", "state.json", "state.json.crc32"]
    assert json.loads(port_files["state.json"]) == json.loads(ref_files["state.json"])
    assert port_files == ref_files  # every byte, the sidecars included
    with np.load(os.path.join(ref_dir, "step_3", "arrays.npz")) as a, \
            np.load(os.path.join(port_dir, "step_3", "arrays.npz")) as b:
        assert a.files == b.files == ["a0", "a1", "a2", "a3", "a4"]
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes()
    mine = checkpoint.Checkpointer(ref_dir).restore()  # the JAX package's step in the port
    theirs = ref_ckpt.Checkpointer(port_dir).restore()  # the port's step in the JAX package
    assert mine["meta"] == theirs["meta"] == ["a", 2, (3.5, None)] and mine["c"] == theirs["c"] == 1.5 - 2j
    for key in ("w", "b", "x", "k"):
        assert np.asarray(mine[key]).tobytes() == np.asarray(theirs[key]).tobytes()
    assert np.array_equal(_bf16_bits(mine["h"]), theirs["h"].view(np.int16))
    on = checkpoint.Checkpointer(ref_dir).restore(comm=ht.get_comm())
    assert on["x"].split == 0 and np.array_equal(on["x"].numpy(), X)


def test_max_to_keep_prunes_and_templates_are_checked(tmp_path):
    ck = checkpoint.Checkpointer(str(tmp_path / "ck"), max_to_keep=2)
    rck = ref_ckpt.Checkpointer(str(tmp_path / "ref"), max_to_keep=2)
    for s in (1, 2, 3, 5):
        ck.save(s, {"v": torch.full((3,), float(s))})
        rck.save(s, {"v": np.full((3,), float(s), np.float32)})
    assert ck.all_steps() == rck.all_steps() == [3, 5] and ck.latest_step() == 5
    ok = ck.restore(template={"v": torch.zeros(3)})
    assert np.array_equal(ok["v"], np.full(3, 5.0, np.float32))
    for bad in ({"v": torch.zeros(4)}, {"v": torch.zeros(3, dtype=torch.float64)}, {"w": torch.zeros(3)}, [1]):
        with pytest.raises(rz.ReshapeError):
            ck.restore(template=bad)
        ref_bad = jax.tree_util.tree_map(lambda t: np.asarray(t), bad)
        with pytest.raises(hrz.ReshapeError):
            rck.restore(template=ref_bad)
    with pytest.raises(NotImplementedError, match="15c"):
        checkpoint.Checkpointer(str(tmp_path / "o"), backend="orbax")


def test_write_faults_retry_or_leave_no_partial_step(tmp_path):
    """A transient fault at checkpoint.write is retried; a permanent one
    raises and leaves neither a step nor a staging directory behind (the
    JAX package's behaviour under the same plans)."""
    for mod, frz, d in ((checkpoint, rz, tmp_path / "port"), (ref_ckpt, hrz, tmp_path / "ref")):
        ck = mod.Checkpointer(str(d))
        with frz.fault_plan({"checkpoint.write": [0]}) as inj:
            ck.save(1, {"v": np.arange(3.0)})
        assert inj.injected["checkpoint.write"] == [(0, "transient")] and ck.latest_step() == 1
        with frz.fault_plan({"checkpoint.write": [{"at": 1, "kind": "permanent"}]}):
            with pytest.raises(frz.PermanentFault):
                ck.save(2, {"v": np.arange(3.0)})
        assert sorted(os.listdir(str(d))) == ["step_1"]


def test_a_corrupt_step_raises_checksum_error(tmp_path):
    """One flipped byte of arrays.npz's payload fails its sidecar.  The zip
    local header's size fields of a zip64 member are 0xff already, so the
    byte flipped here is the array data's (checked to change the file)."""
    d = str(tmp_path / "ck")
    ck = checkpoint.Checkpointer(d)
    ck.save(0, {"v": np.arange(16, dtype=np.float64)})
    npz = os.path.join(d, "step_0", "arrays.npz")
    before = open(npz, "rb").read()
    at = before.index(np.arange(16, dtype=np.float64).tobytes()) + 9
    with open(npz, "r+b") as f:
        f.seek(at)
        f.write(bytes([before[at] ^ 0xFF]))
    assert open(npz, "rb").read() != before
    with pytest.raises(rz.ChecksumError):
        ck.restore(0)
    with pytest.raises(hrz.ChecksumError):
        ref_ckpt.Checkpointer(d).restore(0)


def test_async_saves_one_at_a_time_and_errors_surface_at_wait(tmp_path):
    ac = checkpoint.Checkpointer(str(tmp_path / "ck")).as_async()
    inner = ac.checkpointer._save_local
    live, most = [0], [0]
    lock = threading.Lock()

    def slow(step, state, meta=None):
        with lock:
            live[0] += 1
            most[0] = max(most[0], live[0])
        time.sleep(0.05)
        inner(step, state, meta)
        with lock:
            live[0] -= 1

    ac.checkpointer._save_local = slow
    overlap.reset_overlap_stats()
    state = {"v": torch.arange(5.0)}
    for s in (1, 2, 3):
        ac.save(s, state)
        state["v"] += 1  # the snapshot was taken: a later write never sees this
    assert ac.all_steps() == [1, 2, 3] and most[0] == 1
    assert np.array_equal(ac.restore(2)["v"], np.arange(5.0, dtype=np.float32) + 1)
    with rz.fault_plan({"checkpoint.async_write": [{"at": 0, "kind": "permanent"}]}):
        ac.save(4, state)
        with pytest.raises(rz.PermanentFault):
            ac.wait()
    ac.wait()  # the error was handed out once
    ac.save(5, state, async_=False)
    stats = overlap.overlap_stats()
    assert set(stats) == set(ref_overlap.overlap_stats())
    assert stats["async_saves"] == 4 and stats["sync_saves"] == 1 and stats["ckpt_stall_ms"] > 0
    assert ac.all_steps() == [1, 2, 3, 5] and overlap.async_checkpoint_enabled()


def test_async_checkpoint_switch_reads_the_environment(monkeypatch):
    for value, want in (("0", False), ("off", False), ("1", True), ("yes", True)):
        monkeypatch.setenv("HEAT_TPU_ASYNC_CKPT", value)
        assert overlap.async_checkpoint_enabled() is want is ref_overlap.async_checkpoint_enabled()


def test_the_preemption_gate_matches_the_reference():
    """request, take and clear in one order on both gates: the same answers,
    the same per-gate and process counters, journal events of the same
    actor and actions."""
    gates = (preempt.PreemptionGate(), ref_preempt.PreemptionGate())
    names = ("qos.preempt_requests", "qos.preemptions", "qos.preempt_ignored")
    from heat_tpu.telemetry import metrics as ref_metrics
    from heat_tpu_torch.telemetry import metrics as port_metrics

    before = [{n: m.counter(n).value for n in names} for m in (port_metrics, ref_metrics)]
    answers = [[], []]
    for i, g in enumerate(gates):
        answers[i].append(g.take(durable=True))
        g.request("spike")
        g.request("spike again")  # the same spike, counted once
        answers[i] += [g.pending(), g.take(durable=False), g.take(durable=True), g.take(durable=True)]
        g.clear()
        answers[i] += [g.pending(), g.take(durable=True), g.stats()]
    assert answers[0] == answers[1]
    assert answers[0][-1] == {"pending": None, "requests": 1, "preemptions": 2, "ignored": 1}
    after = [{n: m.counter(n).value - b[n] for n in names} for m, b in zip((port_metrics, ref_metrics), before)]
    assert after[0] == after[1] == {"qos.preempt_requests": 1, "qos.preemptions": 2, "qos.preempt_ignored": 1}
    last = [j.find_last(actor="preempt") for j in (journal, ref_journal)]
    assert [(e["actor"], e["action"]) for e in last] == [("preempt", "clear")] * 2
    assert preempt.preemption_gate() is preempt.preemption_gate()
