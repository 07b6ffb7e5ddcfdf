"""Cross-process elastic supervision (counterpart of
heat_tpu/elastic/process.py): the kill-and-resume harness as a driver.

A real preemption kills a *worker process*, not an exception handler.
:class:`ProcessSupervisor` launches one attempt as ``world`` worker
processes, one rank each, with the rendezvous in their environment
(``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``,
which ``parallel.init()`` reads: gloo on the CPU, NCCL with one rank per
card), and supervises them through two loss signals:

* **exit code**: a rank that exits non-zero (the fault injector's
  ``kind: "kill"`` ``os._exit(137)``, an OOM kill, a preemption's SIGKILL)
  is a lost worker;
* **heartbeat files**: each rank's ``resumable_fit_loop`` touches its
  ``HEAT_TPU_HEARTBEAT_FILE`` at every chunk boundary; a rank whose file
  goes stale past ``heartbeat_timeout_s`` is *hung*.

On a loss the supervisor kills the attempt's other ranks (they would wait
in a collective for the lost one), shrinks the world (``shrink_by`` ranks,
never below ``min_world``) and relaunches it with ``resume_from`` set, so
the fit goes on from its last durable step on the smaller world.  Recovery
latency, from the loss to the resumed attempt's first heartbeat, feeds the
shared ``elastic.recovery_ms`` histogram; losses, reshapes and the world
size use the in-process supervisor's counters and gauge.
"""

from __future__ import annotations

import os
import socket
import subprocess
import time
from typing import Callable, List, Optional, Tuple

from ..resilience.errors import ReshapeError, WorkerLostError
from ..resilience.faults import inject as _inject
from .supervisor import LOSSES_C, RECOVERY_H, RESHAPES_C, WORLD_G, _env_float, _env_int

__all__ = ["ProcessSupervisor", "kmeans_worker_source"]

#: build_worker(world_size, resume_from, attempt) -> (argv, extra_env); the
#: same argv runs on every rank of the attempt
WorkerBuilder = Callable[[int, Optional[str], int], Tuple[List[str], dict]]


def kmeans_worker_source(
    checkpoint_dir: str,
    *,
    resume_from: Optional[str] = None,
    n: int = 240,
    f: int = 6,
    k: int = 4,
    max_iter: int = 40,
    tol: float = 1e-4,
    seed: int = 13,
    random_state: int = 3,
    checkpoint_every: int = 2,
    device: Optional[str] = None,
) -> str:
    """Source of a self-contained KMeans fit worker, one rank of a world.

    The canonical elastic workload: the seeded data do not depend on the
    world's size (one global array drawn, then split), the fit checkpoints
    every ``checkpoint_every`` iterations into ``checkpoint_dir``, and the
    converged state is read from that directory (the supervisor never
    parses output).  ``device`` is ``"cpu"`` or ``"gpu"``; by default the
    card where there is one (rank ``LOCAL_RANK`` takes card ``LOCAL_RANK``),
    else the CPU.  It imports heat_tpu_torch only."""
    lines = [
        "import os",
        "import torch",
        "import heat_tpu_torch as ht",
        f"device = {device!r} or ('gpu' if torch.cuda.is_available() else 'cpu')",
        "if device == 'gpu':",
        "    torch.cuda.set_device(int(os.environ.get('LOCAL_RANK', '0')) % torch.cuda.device_count())",
        "ht.use_device(device)",
        "ht.parallel.init()",
        f"ht.random.seed({seed})",
        f"x = ht.random.randn({n}, {f}, split=0).astype(ht.float32)",
        f"km = ht.cluster.KMeans(n_clusters={k}, init='random', max_iter={max_iter},",
        f"                       tol={tol}, random_state={random_state},",
        f"                       checkpoint_every={checkpoint_every},",
        f"                       checkpoint_dir={checkpoint_dir!r},",
        f"                       resume_from={resume_from!r})",
        "km.fit(x)",
        "print('ELASTIC-WORKER-OK', km.n_iter_, flush=True)",
        "ht.parallel.finalize()",
    ]
    return "\n".join(lines)


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class ProcessSupervisor:
    """Supervise a world of fit processes through preemption, reshape and
    resume.

    ``build_worker(world_size, resume_from, attempt)`` returns ``(argv,
    extra_env)`` of one attempt; every rank runs ``argv``, and the
    supervisor adds the rendezvous (``MASTER_ADDR`` localhost, a free
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``), each rank's
    heartbeat file and the repository to the path.  ``run()`` returns a
    summary (the final world size, the recoveries, each recovery's
    latency, each attempt's return codes and output tails); a world that
    keeps dying past ``max_recoveries`` raises :class:`WorkerLostError`, a
    shrink below ``min_world`` :class:`ReshapeError`.  Every process it
    starts has ended when ``run()`` returns or raises."""

    def __init__(
        self,
        build_worker: WorkerBuilder,
        checkpoint_dir: str,
        world_size: int,
        *,
        min_world: Optional[int] = None,
        shrink_by: int = 1,
        max_recoveries: Optional[int] = None,
        heartbeat_timeout_s: Optional[float] = None,
        poll_s: Optional[float] = None,
        attempt_timeout_s: float = 600.0,
        env: Optional[dict] = None,
    ):
        if world_size < 1:
            raise ReshapeError(f"world_size must be >= 1, got {world_size}")
        self.build_worker = build_worker
        self.checkpoint_dir = os.path.abspath(checkpoint_dir)
        self.world_size = int(world_size)
        self.min_world = _env_int("HEAT_TPU_ELASTIC_MIN_WORLD", 1) if min_world is None else int(min_world)
        self.shrink_by = int(shrink_by)
        self.max_recoveries = (
            _env_int("HEAT_TPU_ELASTIC_MAX_RECOVERIES", 2) if max_recoveries is None else int(max_recoveries)
        )
        self.heartbeat_timeout_s = (
            _env_float("HEAT_TPU_ELASTIC_HEARTBEAT_TIMEOUT_S", 0.0)
            if heartbeat_timeout_s is None
            else float(heartbeat_timeout_s)
        )
        self.poll_s = _env_float("HEAT_TPU_ELASTIC_POLL_S", 0.5) if poll_s is None else float(poll_s)
        self.attempt_timeout_s = float(attempt_timeout_s)
        self.base_env = dict(os.environ if env is None else env)

    # -- one attempt ----------------------------------------------------
    def _rank_env(self, world: int, rank: int, port: int, extra: dict, hb_path: str) -> dict:
        env = dict(self.base_env)
        env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE=str(world), RANK=str(rank),
                   LOCAL_RANK=str(rank), HEAT_TPU_HEARTBEAT_FILE=hb_path)
        repo_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
        env.update(extra or {})
        return env

    @staticmethod
    def _mtime(path: str) -> Optional[float]:
        try:
            return os.path.getmtime(path)
        except OSError:
            return None

    @staticmethod
    def _stop(procs: List[subprocess.Popen]) -> None:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()

    def _await_world(self, procs: List[subprocess.Popen], hb_paths: List[str],
                     launched_wall: float) -> Tuple[List[int], Optional[float]]:
        """Poll one attempt's ranks until all have exited 0, or one has
        failed or gone stale (the rest are then killed).  Returns ``(return
        codes, first_beat_monotonic)``; a rank killed for staleness reads
        -9."""
        started = time.monotonic()
        first_beat: Optional[float] = None
        stale = set()
        try:
            while True:
                rcs = [p.poll() for p in procs]
                beats = [self._mtime(h) for h in hb_paths]
                if first_beat is None and any(b is not None and b >= launched_wall for b in beats):
                    first_beat = time.monotonic()
                if all(rc == 0 for rc in rcs) or any(rc not in (None, 0) for rc in rcs):
                    break
                now_wall = time.time()
                if self.heartbeat_timeout_s > 0:
                    for r, (rc, b) in enumerate(zip(rcs, beats)):
                        if rc is None and now_wall - (b if b is not None else launched_wall) > self.heartbeat_timeout_s:
                            stale.add(r)
                    if stale:
                        break
                if time.monotonic() - started > self.attempt_timeout_s:
                    raise WorkerLostError(
                        f"the world exceeded the attempt timeout ({self.attempt_timeout_s:.0f}s) without finishing",
                        world_size=len(procs),
                    )
                time.sleep(self.poll_s)
        finally:
            self._stop(procs)
        return [-9 if r in stale else p.returncode for r, p in enumerate(procs)], first_beat

    @staticmethod
    def _tail(path: str, limit: int = 2000) -> str:
        try:
            with open(path, "rb") as f:
                data = f.read()
            return data[-limit:].decode("utf-8", "replace")
        except OSError:
            return ""

    # -- the supervision loop -------------------------------------------
    def run(self) -> dict:
        """Drive attempts until a world finishes cleanly.

        Returns ``{"world_size", "recoveries", "recovery_s": [...],
        "attempts": [{"world_size", "returncode", "returncodes", "tail"},
        ...]}``; an attempt's ``returncode`` is 0 where every rank exited 0,
        else the first failing rank's code, and ``tail`` is rank 0's
        output (the failing rank's where one failed)."""
        world = self.world_size
        WORLD_G.set(world)
        resume: Optional[str] = None
        recoveries = 0
        recovery_s: List[float] = []
        attempts: List[dict] = []
        t_loss: Optional[float] = None
        os.makedirs(self.checkpoint_dir, exist_ok=True)
        while True:
            attempt = len(attempts)
            argv, extra = self.build_worker(world, resume, attempt)
            port = _free_port()
            hb_paths = [os.path.join(self.checkpoint_dir, f".heartbeat.{r}") for r in range(world)]
            logs = [os.path.join(self.checkpoint_dir, f".worker-{attempt}.rank{r}.log") for r in range(world)]
            launched_wall = time.time()
            procs: List[subprocess.Popen] = []
            try:
                for r in range(world):
                    fd = os.open(logs[r], os.O_CREAT | os.O_WRONLY | os.O_TRUNC, 0o644)
                    try:
                        procs.append(subprocess.Popen(argv, env=self._rank_env(world, r, port, extra, hb_paths[r]),
                                                      stdout=fd, stderr=subprocess.STDOUT))
                    finally:
                        os.close(fd)
            except BaseException:
                self._stop(procs)
                raise
            rcs, first_beat = self._await_world(procs, hb_paths, launched_wall)
            failed = [r for r, rc in enumerate(rcs) if rc != 0]
            rc = rcs[failed[0]] if failed else 0
            attempts.append({"world_size": world, "returncode": rc, "returncodes": rcs,
                             "tail": self._tail(logs[failed[0] if failed else 0])})
            if t_loss is not None:
                # recovery latency: the previous world's loss to this
                # world's first heartbeat (its end where it resumed straight
                # into a converged checkpoint)
                end = first_beat if first_beat is not None else time.monotonic()
                dt = max(0.0, end - t_loss)
                recovery_s.append(dt)
                RECOVERY_H.observe(dt * 1000.0)
                t_loss = None
            if rc == 0:
                return {
                    "world_size": world,
                    "recoveries": recoveries,
                    "recovery_s": recovery_s,
                    "attempts": attempts,
                }
            # -- loss detected ------------------------------------------
            t_loss = time.monotonic()
            _inject("elastic.detect", returncode=rc, world_size=world)
            LOSSES_C.inc()
            recoveries += 1
            if recoveries > self.max_recoveries:
                raise WorkerLostError(
                    f"a worker died (rc={rc}) and the recovery budget "
                    f"({self.max_recoveries}) is exhausted; last output:\n"
                    + attempts[-1]["tail"],
                    world_size=world,
                )
            target = world - self.shrink_by
            if target < self.min_world:
                raise ReshapeError(
                    f"worker loss would shrink the world to {target}, below "
                    f"the configured minimum {self.min_world}",
                    old_size=world,
                    new_size=target,
                )
            _inject("elastic.reshape", old=world, new=target)
            world = target
            RESHAPES_C.inc()
            WORLD_G.set(world)
            resume = self.checkpoint_dir
            _inject("elastic.resume", world_size=world)
