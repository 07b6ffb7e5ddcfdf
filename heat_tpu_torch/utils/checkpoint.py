"""Checkpoint/resume of distributed arrays and fit state (counterpart of
heat_tpu/utils/checkpoint.py).

A directory-per-step :class:`Checkpointer` with the JAX package's native
format, byte for byte: the tree's structure goes to ``state.json``
(version 2, step, world size, tree), its array leaves to ``arrays.npz``
(members ``a0.npy``, ``a1.npy``, ... in the order the tree meets them),
both written through the resilience layer's atomic write with CRC32
sidecars into a staged ``.tmp-step_*`` directory that one atomic rename
commits as ``step_<k>``.  A step either exists completely or not at all, so
a fit killed mid-save resumes from the previous step.  A step written by
either package restores in the other.  A DNDarray leaf is stored as its
dense global value with its split axis; bfloat16, which numpy lacks, is
stored as the JAX package stores ml_dtypes' bfloat16 (two raw bytes an
element, descr ``<V2``) and comes back as a torch bfloat16 tensor.  Other
array leaves (torch tensors, numpy arrays and scalars) come back as numpy
arrays, as in the JAX package.

On several ranks every rank encodes the state (a DNDarray leaf is gathered
once, by ``_dense()``), every rank evaluates the fault sites, rank 0 alone
writes and renames, and the outcome is agreed by every rank of the
checkpointer's communication (``io._together``: all ranks raise alike, and
rank 0's write retries under the io policy on its own, as io's gathering
writers do).  On restore every rank reads the step and the checksum
outcome is agreed the same way; with ``comm=`` each DNDarray leaf lands on
that communication's canonical chunk on the device.

The ``"orbax"`` backend of the JAX package (a sharded multi-host writer)
has no counterpart yet (ROADMAP item 15c) and raises.  Saves can run in the
background through :class:`~heat_tpu_torch.utils.overlap.AsyncCheckpointer`
(``Checkpointer(...).as_async()`` or ``save(..., async_=True)``).
"""

from __future__ import annotations

import json
import os
import shutil
import time
import uuid
import zipfile
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..core import types
from ..core.dndarray import DNDarray
from ..core.io import _together
from ..parallel.comm import sanitize_comm
from ..resilience import atomic as _ratomic
from ..resilience.errors import ReshapeError
from ..resilience.faults import inject as _inject
from ..resilience.retry import default_io_policy as _io_policy
from ..telemetry import metrics as _tm
from ..telemetry.spans import span as _span

__all__ = ["save_checkpoint", "load_checkpoint", "Checkpointer", "DNDSnapshot"]

#: cross-world restores performed (checkpoint written at world size P,
#: restored onto Q != P: the elastic resume path)
_CROSSWORLD_C = _tm.counter(
    "checkpoint.crossworld_restores",
    "checkpoint restores onto a world size different from the writer's",
)

_STEP_PREFIX = "step_"

#: last durable checkpoint step and when it committed
_LAST_STEP_G = _tm.gauge("checkpoint.last_step", "most recent durable checkpoint step")
_LAST_STEP_TS_G = _tm.gauge(
    "checkpoint.last_step_ts", "unix time the last checkpoint step committed"
)


def _note_durable_step(step: int) -> None:
    _LAST_STEP_G.set(step)
    _LAST_STEP_TS_G.set(time.time())


# ----------------------------------------------------------------------
# the native codec: JSON structure + npz leaves
# ----------------------------------------------------------------------
class DNDSnapshot:
    """Async-snapshot carrier of a DNDarray leaf: its dense global value
    (a host tensor), the split axis and the writer's world size, which the
    codec records, and its heat type (the unsigned types are held in wider
    tensors)."""

    __slots__ = ("dense", "split", "world_size", "dtype")

    def __init__(self, dense, split, world_size, dtype=None):
        self.dense = dense
        self.split = split
        self.world_size = world_size
        self.dtype = dtype


def _host(t: torch.Tensor, dtype=None) -> np.ndarray:
    """A tensor as the numpy array the JAX package stores for it: bfloat16
    as its raw two bytes (``V2``), an unsigned heat type ``dtype`` read back
    from its holding dtype."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.int16).numpy().view(np.dtype("V2"))
    a = t.numpy()
    return types._from_holding(a, dtype) if dtype is not None else a


def _encode(obj: Any, leaves: List[np.ndarray]):
    if isinstance(obj, DNDSnapshot):
        leaves.append(_host(obj.dense, obj.dtype))
        return {"t": "dnd", "i": len(leaves) - 1, "split": obj.split}
    if isinstance(obj, DNDarray):
        # the dense GLOBAL value plus the split axis: a restore re-splits
        # the leaf onto the restoring communication's canonical chunks
        leaves.append(_host(obj._dense(), obj.dtype))
        return {"t": "dnd", "i": len(leaves) - 1, "split": obj.split}
    if isinstance(obj, torch.Tensor):
        leaves.append(_host(obj))
        return {"t": "arr", "i": len(leaves) - 1}
    if isinstance(obj, (np.ndarray, np.generic)):
        leaves.append(np.asarray(obj))
        return {"t": "arr", "i": len(leaves) - 1}
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return {"t": "py", "v": obj}
    if isinstance(obj, complex):
        return {"t": "complex", "re": obj.real, "im": obj.imag}
    if isinstance(obj, (list, tuple)):
        return {
            "t": "tuple" if isinstance(obj, tuple) else "list",
            "v": [_encode(x, leaves) for x in obj],
        }
    if isinstance(obj, dict):
        if not all(isinstance(k, str) for k in obj):
            raise TypeError("native checkpoints require str dict keys")
        return {"t": "dict", "v": {k: _encode(v, leaves) for k, v in obj.items()}}
    raise TypeError(
        f"cannot checkpoint object of type {type(obj)!r} natively; "
        "use arrays, python scalars, lists/tuples/dicts"
    )


def _leaf(a: np.ndarray):
    """A stored array as the port returns it: two raw bytes an element are
    bfloat16's (a torch tensor, since numpy has no bfloat16)."""
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(torch.bfloat16)
    return a


def _decode(node: Dict, leaves, comm=None) -> Any:
    t = node["t"]
    if t == "arr":
        return _leaf(leaves[f"a{node['i']}"])
    if t == "dnd":
        arr = _leaf(leaves[f"a{node['i']}"])
        if comm is None:
            return arr  # no target communication: the global host value
        from ..core.factories import array

        # every rank holds the whole value: each keeps its canonical chunk
        return array(arr, split=node.get("split"), comm=comm, copy=True)
    if t == "py":
        return node["v"]
    if t == "complex":
        return complex(node["re"], node["im"])
    if t == "list":
        return [_decode(x, leaves, comm) for x in node["v"]]
    if t == "tuple":
        return tuple(_decode(x, leaves, comm) for x in node["v"])
    if t == "dict":
        return {k: _decode(v, leaves, comm) for k, v in node["v"].items()}
    raise ValueError(f"unknown checkpoint node type {t!r}")


def _write_npz(f, leaves: List[np.ndarray]) -> None:
    """``np.savez(f, a0=..., a1=...)``, except that a bfloat16 leaf's header
    names ``<V2``, as ml_dtypes' bfloat16 writes it (numpy's own void type
    writes ``|V2``): the same bytes as the JAX package's file."""
    with zipfile.ZipFile(f, mode="w", compression=zipfile.ZIP_STORED, allowZip64=True) as zipf:
        for i, a in enumerate(leaves):
            with zipf.open(f"a{i}.npy", "w", force_zip64=True) as fid:
                if a.dtype.kind == "V" and a.dtype.itemsize == 2:
                    np.lib.format.write_array_header_1_0(
                        fid, {"descr": "<V2", "fortran_order": False, "shape": a.shape})
                    fid.write(np.ascontiguousarray(a).tobytes())
                else:
                    np.lib.format.write_array(fid, np.asanyarray(a), allow_pickle=True)


def _dtype_name(x) -> Optional[str]:
    if isinstance(x, DNDarray):
        return x.dtype.__name__
    if isinstance(x, torch.Tensor):
        return str(x.dtype).rsplit(".", 1)[-1]
    if isinstance(x, (np.ndarray, np.generic)):
        return np.dtype(x.dtype).name
    return None


def _leaf_shape_dtype(x):
    """(shape, dtype name) of an array-like template or state leaf, or None
    for non-arrays."""
    name = _dtype_name(x)
    return None if name is None else (tuple(int(s) for s in x.shape), name)


def _validate_template(template: Any, restored: Any, path: str = "state") -> None:
    """Shape and dtype validation of a restored tree against a template:
    the tree's structure and every array leaf's global shape and dtype must
    not change across worlds.  A mismatch raises :class:`ReshapeError`
    naming the leaf."""
    want = _leaf_shape_dtype(template)
    if want is not None:
        got = _leaf_shape_dtype(restored)
        if got is None:
            raise ReshapeError(
                f"checkpoint leaf {path!r}: template expects an array "
                f"{want[0]}/{want[1]}, restored a {type(restored).__name__}",
                leaf=path,
            )
        if want[0] != got[0] or want[1] != got[1]:
            raise ReshapeError(
                f"checkpoint leaf {path!r}: template expects {want[0]}/{want[1]}, "
                f"checkpoint holds {got[0]}/{got[1]} — global shapes and dtypes "
                "must be world-size invariant",
                leaf=path,
            )
        return
    if isinstance(template, dict):
        if not isinstance(restored, dict) or set(template) != set(restored):
            raise ReshapeError(
                f"checkpoint node {path!r}: dict keys differ from template",
                leaf=path,
            )
        for k in template:
            _validate_template(template[k], restored[k], f"{path}.{k}")
        return
    if isinstance(template, (list, tuple)):
        if not isinstance(restored, (list, tuple)) or len(template) != len(restored):
            raise ReshapeError(
                f"checkpoint node {path!r}: sequence arity differs from template",
                leaf=path,
            )
        for i, (t, r) in enumerate(zip(template, restored)):
            _validate_template(t, r, f"{path}[{i}]")
        return
    # scalars/None: nothing to pin


def _first_dnd_world(state: Any) -> Optional[int]:
    """The world size of the first DNDarray (or snapshot) leaf, in the JAX
    package's leaf order (dict keys sorted), or None."""
    if isinstance(state, DNDSnapshot):
        return state.world_size
    if isinstance(state, DNDarray):
        return state.comm.size
    if isinstance(state, dict):
        children = [state[k] for k in sorted(state)]
    elif isinstance(state, (list, tuple)):
        children = state
    else:
        return None
    for c in children:
        ws = _first_dnd_world(c)
        if ws is not None:
            return ws
    return None


class Checkpointer:
    """Directory-per-step checkpoint manager.

    Step directories (``step_<k>``) are committed atomically; ``latest_step``
    only ever sees complete checkpoints.  ``comm`` (the default
    communication by default) is the set of ranks that save and restore
    together: every one of them calls each method."""

    def __init__(
        self,
        directory: str,
        max_to_keep: Optional[int] = None,
        backend: str = "native",
        comm=None,
    ):
        if backend not in ("native", "orbax"):
            raise ValueError(f"backend must be 'native' or 'orbax', got {backend!r}")
        if backend == "orbax":
            raise NotImplementedError(
                "the orbax (sharded multi-host) checkpoint backend has no counterpart in heat_tpu_torch yet "
                "(ROADMAP Queue 1 item 15c: torch.distributed.checkpoint); use backend='native'"
            )
        self.directory = os.path.abspath(directory)
        self.backend = backend
        self.max_to_keep = max_to_keep
        self.comm = sanitize_comm(comm)
        os.makedirs(self.directory, exist_ok=True)

    # -- step bookkeeping ----------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"{_STEP_PREFIX}{int(step)}")

    def _listed_steps(self) -> List[int]:
        steps = []
        for name in os.listdir(self.directory):
            if name.startswith(_STEP_PREFIX):
                try:
                    steps.append(int(name[len(_STEP_PREFIX):]))
                except ValueError:
                    continue
        return sorted(steps)

    def all_steps(self) -> List[int]:
        """Committed steps, ascending (drains any in-flight async save
        first, so a caller never misses the step it just enqueued)."""
        self.close()
        return self._listed_steps()

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # -- async front end ------------------------------------------------
    def as_async(self) -> "AsyncCheckpointer":
        """An :class:`~heat_tpu_torch.utils.overlap.AsyncCheckpointer` over
        this checkpointer (at most one background write in flight)."""
        from .overlap import AsyncCheckpointer

        return AsyncCheckpointer(self)

    def wait(self) -> None:
        """No-op (synchronous saves are durable on return); lets callers
        drive sync and async checkpointers through one protocol."""

    def close(self) -> None:
        """Drain the internal async front end, if ``save(async_=True)``
        ever created one (no-op otherwise)."""
        inner = getattr(self, "_async", None)
        if inner is not None:
            inner.close()

    # -- save / restore -------------------------------------------------
    def _agreed(self, fn, what: str, comm=None):
        """``fn()`` on every rank of ``comm`` (this checkpointer's by
        default), rank-local file work under the io retry policy, its
        outcome agreed by every rank (``io._together``)."""
        return _together(comm if comm is not None else self.comm, None, lambda: _io_policy().call(fn), what)

    def _encoded(self, state: Any):
        """``(tree, leaves, world size)`` of a state: gathers each DNDarray
        leaf (a collective on its communication)."""
        leaves: List[np.ndarray] = []
        tree = _encode(state, leaves)
        ws = _first_dnd_world(state)
        return tree, leaves, self.comm.size if ws is None else ws

    def save(
        self,
        step: int,
        state: Any,
        extra_metadata: Optional[Dict] = None,
        async_: bool = False,
    ) -> None:
        """Save a tree of arrays, DNDarrays and python scalars.

        Every rank calls it.  The step directory is staged under a temporary
        name and committed with one atomic rename, so a crash mid-save leaves
        no partial step behind; rank 0 writes under the io retry policy and
        every rank raises where it failed.

        ``async_=True`` snapshots the state and runs the same write on a
        background writer (at most one in flight; errors re-raise at the
        next ``save``/``close``): call :meth:`close` before relying on
        durability."""
        if async_:
            inner = getattr(self, "_async", None)
            if inner is None:
                inner = self._async = self.as_async()
            inner.save(step, state, extra_metadata)
            return
        step = int(step)
        tree, leaves, ws = self._encoded(state)
        self._agreed(lambda: self._native_save(step, tree, leaves, ws, extra_metadata), self._step_dir(step))
        _note_durable_step(step)

    def _save_local(self, step: int, state: Any, extra_metadata: Optional[Dict] = None) -> None:
        """This rank's part of a save of a state that holds no DNDarray (an
        async snapshot): no collective, the outcome left to the caller to
        agree."""
        tree, leaves, ws = self._encoded(state)
        _io_policy().call(self._native_save, int(step), tree, leaves, ws, extra_metadata)
        _note_durable_step(int(step))

    @_span("checkpoint.write")
    def _native_save(self, step: int, tree, leaves, world_size: int, extra_metadata=None) -> None:
        _inject("checkpoint.save", step=step)
        if self.comm.rank != 0:
            return
        staging = os.path.join(
            self.directory, f".tmp-{_STEP_PREFIX}{step}-{os.getpid()}-{uuid.uuid4().hex[:8]}"
        )
        os.makedirs(staging)
        try:
            with _ratomic.atomic_write(os.path.join(staging, "state.json"), fault_site="checkpoint.write") as tmp:
                with open(tmp, "w") as f:
                    json.dump({"version": 2, "step": step, "world_size": world_size, "tree": tree}, f)
            with _ratomic.atomic_write(os.path.join(staging, "arrays.npz"), fault_site="checkpoint.write") as tmp:
                with open(tmp, "wb") as f:
                    _write_npz(f, leaves)
            final = self._step_dir(step)
            if os.path.isdir(final):
                # re-save of an existing step: replace it (the previous
                # step still exists in the short window it is absent)
                shutil.rmtree(final)
            os.rename(staging, final)
        except BaseException:
            shutil.rmtree(staging, ignore_errors=True)
            raise
        self._prune()
        if extra_metadata is not None:
            self._write_metadata(step, extra_metadata)

    def _prune(self) -> None:
        if not self.max_to_keep:
            return
        steps = self._listed_steps()
        for s in steps[: max(0, len(steps) - self.max_to_keep)]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    def restore(self, step: Optional[int] = None, template: Any = None, comm=None) -> Any:
        """Restore a step (latest by default).

        Both files verify against their CRC32 sidecars before decoding: a
        corrupt checkpoint raises ``ChecksumError`` on every rank instead of
        returning garbage.

        ``comm`` is the **cross-world restore** path: DNDarray leaves land
        on ``comm``'s canonical chunks on the default device, even when the
        step was written at another world size; a
        restore onto a world of size Q != the writer's P is counted in
        ``checkpoint.crossworld_restores``.  The ranks of ``comm`` (of this
        checkpointer's communication without it) restore together.
        ``template`` validates the restored tree's structure and every
        array leaf's global shape and dtype, raising
        :class:`~heat_tpu_torch.resilience.errors.ReshapeError` on a
        mismatch."""
        self.close()
        step = self.latest_step() if step is None else int(step)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        # the ranks of a joined target restore together; a described world
        # (a layout without a process group) is this checkpointer's ranks'
        agree = comm if comm is not None and comm._size is None else None
        doc, leaves = self._agreed(lambda: self._native_restore(step), self._step_dir(step), agree)
        if comm is not None:
            written = doc.get("world_size")
            if written is not None and int(written) != comm.size:
                _CROSSWORLD_C.inc()
        state = _decode(doc["tree"], leaves, comm)
        if template is not None:
            _validate_template(template, state)
        return state

    @_span("checkpoint.read")
    def _native_restore(self, step: int):
        _inject("checkpoint.restore", step=step)
        d = self._step_dir(step)
        state_path = os.path.join(d, "state.json")
        arrays_path = os.path.join(d, "arrays.npz")
        if not os.path.isdir(d):
            raise FileNotFoundError(f"no checkpoint for step {step} in {self.directory}")
        _ratomic.verify_checksum(state_path)
        _ratomic.verify_checksum(arrays_path)
        with open(state_path) as f:
            doc = json.load(f)
        with np.load(arrays_path) as z:
            leaves = {k: z[k] for k in z.files}
        return doc, leaves

    def world_size(self, step: Optional[int] = None) -> Optional[int]:
        """World size a step was written at, or None where the checkpoint
        predates the metadata (version 1)."""
        self.close()
        step = self.latest_step() if step is None else int(step)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        state_path = os.path.join(self._step_dir(step), "state.json")
        if not os.path.exists(state_path):
            raise FileNotFoundError(f"no checkpoint for step {step} in {self.directory}")
        with open(state_path) as f:
            doc = json.load(f)
        ws = doc.get("world_size")
        return int(ws) if ws is not None else None

    # -- metadata -------------------------------------------------------
    def _write_metadata(self, step: int, meta: Dict) -> None:
        path = os.path.join(self.directory, f"meta_{step}.json")
        with _ratomic.atomic_write(path, fault_site="checkpoint.write") as tmp:
            with open(tmp, "w") as f:
                json.dump(meta, f)

    def metadata(self, step: int) -> Optional[Dict]:
        """Step metadata (``extra_metadata`` of the save), or None;
        checksum-verified like the step itself."""
        path = os.path.join(self.directory, f"meta_{step}.json")
        if os.path.exists(path):
            _ratomic.verify_checksum(path)
            with open(path) as f:
                return json.load(f)
        return None


def save_checkpoint(path: str, state: Any, step: int = 0) -> None:
    """One-shot checkpoint save (convenience wrapper)."""
    Checkpointer(path).save(step, state)


def load_checkpoint(path: str, step: Optional[int] = None, template: Any = None) -> Any:
    """One-shot checkpoint restore."""
    return Checkpointer(path).restore(step, template)
