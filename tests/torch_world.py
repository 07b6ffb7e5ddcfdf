"""One spawned world of CPU ranks (3 by default; torch.distributed, gloo) for a test
module of the port: the ranks start once and run the module's slices in
turn, one rank script a slice, each in a fresh namespace, the state a slice
patches put back after it; each test checks its own slice's arrays as soon
as that slice is done.

The ranks meet through a file store under the module's temporary directory
(no TCP port), with the repository and its tests directory (for the
shared case tables) on their path.  Slice i must be done ``deadline_s *
(i + 1)`` after the world starts (60 s by default), or the world is killed
and the test fails.

A module declares its slices as ``{name: (rank script, inputs function)}``;
the inputs function returns ``(arrays, extra)``: the arrays go to the ranks
as ``arrays`` (an npz), ``extra`` stays with the tests.  A rank script sees
``np``, ``torch``, ``dist``, ``ht``, ``sys``, ``rank``, ``arrays`` and
``out``, the file it saves its results to with ``np.savez``."""

import contextlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

WORLD = 3
DEADLINE_S = 60.0
REPO = Path(__file__).resolve().parents[1]

# every slice runs in a namespace of its own (np, torch, dist, ht, rank, its
# arrays and the file it saves to) from the state a fresh process starts in:
# the attributes of Communication a slice patches, torch.linalg.eigh, the
# environment and both random generators are put back after it; a slice
# that raises leaves its traceback for its tests and the next one runs.  A
# slice starts once its inputs are marked ready, and is marked done on each
# rank after it, so that the tests of a slice run while the world goes on
# with the next ones
_WORLD_MAIN = r"""
import json
import os
import sys
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

rank, store, work, size = int(sys.argv[1]), sys.argv[2], sys.argv[3], int(sys.argv[4])
dist.init_process_group("gloo", init_method="file://" + store, world_size=size, rank=rank)
import heat_tpu_torch as ht

ht.use_device("cpu")
fresh = (dict(vars(ht.Communication)), torch.linalg.eigh, dict(os.environ), ht.random.get_state(),
         torch.get_rng_state())
for name in json.loads(open(os.path.join(work, "slices.json")).read()):
    while not os.path.exists(os.path.join(work, name + ".ready")):
        time.sleep(0.02)
    ns = {"np": np, "torch": torch, "dist": dist, "ht": ht, "sys": sys, "rank": rank,
          "arrays": np.load(os.path.join(work, name + ".npz")), "out": os.path.join(work, f"{name}.rank{rank}.npz")}
    try:
        exec(compile(open(os.path.join(work, name + ".py")).read(), name, "exec"), ns)
    except Exception:
        with open(os.path.join(work, f"{name}.rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
    open(os.path.join(work, f"{name}.rank{rank}.done"), "w").close()
    attrs, eigh, env, state, torch_state = fresh
    for key in set(vars(ht.Communication)) - set(attrs):
        delattr(ht.Communication, key)
    for key, value in attrs.items():
        if vars(ht.Communication).get(key) is not value:
            setattr(ht.Communication, key, value)
    torch.linalg.eigh = eigh
    os.environ.clear()
    os.environ.update(env)
    ht.random.set_state(state)
    torch.set_rng_state(torch_state)
dist.destroy_process_group()
"""

class World:
    """One world of ``size`` rank processes (WORLD by default) running the
    module's slices in turn.  The ranks start first; each slice's inputs are made and marked
    ready in order while they start, and :meth:`ranks` waits only for its
    own slice, so a slice's tests run while the world goes on with the
    next.  Slice i must be done ``deadline_s * (i + 1)`` after the start."""

    def __init__(self, tmp_path, slices, deadline_s=DEADLINE_S, size=WORLD):
        self.deadline_s, self.size = deadline_s, size
        self.tmp, self.slices, self.made, self.procs, self.deadlines = tmp_path, slices, {}, [], {}

    def start(self) -> None:
        for name, (script, _) in self.slices.items():
            (self.tmp / f"{name}.py").write_text(script)
        (self.tmp / "slices.json").write_text(json.dumps(list(self.slices)))
        t0 = time.monotonic()
        self.deadlines = {name: t0 + self.deadline_s * (i + 1) for i, name in enumerate(self.slices)}
        env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": os.pathsep.join([str(REPO), str(REPO / "tests")])}
        for r in range(self.size):
            cmd = [sys.executable, "-c", _WORLD_MAIN, str(r), str(self.tmp / "store"), str(self.tmp), str(self.size)]
            log = open(self.tmp / f"rank{r}.log", "w")
            self.procs.append((subprocess.Popen(cmd, cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT), log))
        try:
            for name, (_, make) in self.slices.items():
                self.made[name] = make()
                np.savez(self.tmp / f"{name}.npz", **self.made[name][0])
                (self.tmp / f"{name}.ready").touch()
        except BaseException:
            self.kill()
            raise

    def __getitem__(self, name):
        """The slice's inputs and the reference's objects made with them."""
        return self.made[name]

    def ranks(self, name):
        """Every rank's saved arrays of the slice ``name``, once it is done
        on every rank; fails with the ranks' tracebacks where it raised,
        with a rank's log where one died, and at the deadline."""
        done = [self.tmp / f"{name}.rank{r}.done" for r in range(self.size)]
        while not all(d.exists() for d in done):
            for r, (p, _) in enumerate(self.procs):
                if p.poll() is not None and not done[r].exists():
                    pytest.fail(f"gloo rank {r} ended ({p.returncode}) before slice {name}:\n"
                                + (self.tmp / f"rank{r}.log").read_text())
            if time.monotonic() > self.deadlines[name]:
                self.kill()
                pytest.fail(f"the gloo world of {self.size} did not finish slice {name} by its deadline")
            time.sleep(0.05)
        errors = [f"rank {r}: " + e.read_text() for r, e in enumerate(
            self.tmp / f"{name}.rank{r}.err" for r in range(self.size)) if e.exists()]
        if errors:
            pytest.fail(f"slice {name} raised on the gloo ranks:\n" + "\n".join(errors))
        return [dict(np.load(self.tmp / f"{name}.rank{r}.npz")) for r in range(self.size)]

    def kill(self) -> None:
        for p, _ in self.procs:
            p.kill()

    def close(self) -> None:
        """Wait for the ranks (killed at the last deadline); each must exit 0."""
        try:
            for p, _ in self.procs:
                p.wait(timeout=max(0.1, max(self.deadlines.values()) - time.monotonic()))
        except subprocess.TimeoutExpired:
            self.kill()
        finally:
            for p, log in self.procs:
                p.wait()
                log.close()
        for r, (p, _) in enumerate(self.procs):
            assert p.returncode == 0, (self.tmp / f"rank{r}.log").read_text()


@contextlib.contextmanager
def spawned(tmp_path, slices, deadline_s=DEADLINE_S, size=WORLD):
    """A started :class:`World` of ``size`` ranks running ``slices`` under
    ``tmp_path``, closed (each rank must exit 0) on leaving."""
    w = World(tmp_path, slices, deadline_s, size)
    try:
        w.start()
        yield w
    finally:
        w.close()
