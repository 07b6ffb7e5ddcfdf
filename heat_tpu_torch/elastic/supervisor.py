"""In-process elastic supervision: detect worker loss, reshape, resume
(counterpart of heat_tpu/elastic/supervisor.py).

:class:`ElasticSupervisor` wraps a checkpointing fit (anything built on
``resumable_fit_loop``) in the detect -> reshape -> resume recovery loop;
:class:`HeartbeatMonitor` turns the ``fit.heartbeat_ts`` gauge (or the
``HEAT_TPU_HEARTBEAT_FILE`` a fit touches at every chunk boundary) into
a staleness check that raises
:class:`~heat_tpu_torch.resilience.errors.WorkerLostError`.

The supervisor is exception-driven: every rank runs it, a loss surfaces on
all of them as a scripted :class:`WorkerLostError` (a fault plan fires at
the same boundary on every rank), and the world shrinks by
``comm.reshape``, which every rank of the old world still takes part in; a
rank that is left out ends its :meth:`ElasticSupervisor.run` with None.  A
process that really died cannot take part in making a group: that case, and
a stalled process, are the
:class:`~heat_tpu_torch.elastic.process.ProcessSupervisor`'s job (a restart
of a smaller world).
"""

from __future__ import annotations

import os
import time
from typing import Callable, Optional, Tuple, Type

from ..parallel.comm import Communication, get_comm
from ..resilience.errors import ReshapeError, WorkerLostError
from ..resilience.faults import inject as _inject
from ..resilience.retry import RetryPolicy, default_init_policy
from ..analysis.protocols import ACTOR_ELASTIC, ELASTIC_RESHAPE
from ..telemetry import journal as _journal
from ..telemetry import metrics as _tm
from ..telemetry.spans import span as _span

__all__ = ["ElasticSupervisor", "HeartbeatMonitor", "elastic_state"]

# process-global elastic telemetry — shared with the process supervisor
LOSSES_C = _tm.counter("elastic.worker_losses", "worker losses detected")
RESHAPES_C = _tm.counter(
    "elastic.reshapes", "mesh reshapes performed after worker loss"
)
RECOVERY_H = _tm.histogram(
    "elastic.recovery_ms", "worker-loss recovery latency (detect -> resumed), ms"
)
WORLD_G = _tm.gauge("elastic.world_size", "current elastic world size (devices)")

#: the fit-loop heartbeat gauge (registered by resumable_fit_loop; the
#: registry returns the same object, so reading here needs no fit import)
_HEARTBEAT_G = _tm.gauge(
    "fit.heartbeat_ts", "unix time of the last resumable-fit chunk boundary"
)


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name, "").strip()
    return int(v) if v else default


def _env_float(name: str, default: float) -> float:
    v = os.environ.get(name, "").strip()
    return float(v) if v else default


def elastic_state() -> dict:
    """Current elastic counters — the ``/statusz`` elastic section and
    the crash flight recorder read this one snapshot."""
    return {
        "world_size": WORLD_G.value,
        "worker_losses": LOSSES_C.value,
        "reshapes": RESHAPES_C.value,
    }


class HeartbeatMonitor:
    """Staleness check over a fit's liveness signal.

    Two signal sources, matching the two supervision modes:

    * default — the process-local ``fit.heartbeat_ts`` gauge every
      ``resumable_fit_loop`` chunk boundary refreshes;
    * ``heartbeat_file`` — the mtime of the file a (different) worker
      process touches when ``HEAT_TPU_HEARTBEAT_FILE`` is set.

    ``check()`` evaluates the ``elastic.detect`` fault site (the hook a
    plan uses to script detection-path faults) and raises
    :class:`WorkerLostError` when the signal is older than
    ``timeout_s``.  A monitor that never saw a beat measures age from
    its own construction — a worker that dies before its first chunk
    still trips the timeout.
    """

    def __init__(
        self,
        timeout_s: Optional[float] = None,
        heartbeat_file: Optional[str] = None,
        clock: Callable[[], float] = time.time,
    ):
        self.timeout_s = (
            _env_float("HEAT_TPU_ELASTIC_HEARTBEAT_TIMEOUT_S", 0.0)
            if timeout_s is None
            else float(timeout_s)
        )
        self.heartbeat_file = heartbeat_file
        self._clock = clock
        self._armed_at = clock()

    def last_beat(self) -> Optional[float]:
        """Unix time of the newest observed heartbeat, or None."""
        if self.heartbeat_file is not None:
            try:
                return os.path.getmtime(self.heartbeat_file)
            except OSError:
                return None
        ts = float(_HEARTBEAT_G.value)
        return ts if ts > 0 else None

    def age(self) -> float:
        """Seconds since the last heartbeat (since arming, before the
        first beat)."""
        beat = self.last_beat()
        origin = self._armed_at if beat is None else max(beat, self._armed_at)
        return max(0.0, self._clock() - origin)

    def stale(self) -> bool:
        return self.timeout_s > 0 and self.age() > self.timeout_s

    def check(self) -> None:
        """Evaluate the ``elastic.detect`` site; raise on staleness."""
        _inject("elastic.detect", age=self.age())
        if self.stale():
            raise WorkerLostError(
                f"fit heartbeat is {self.age():.1f}s old "
                f"(timeout {self.timeout_s:.1f}s) — declaring the worker lost",
                heartbeat_age=self.age(),
            )


class ElasticSupervisor:
    """Drive a checkpointing fit through worker loss.

    ``fit_fn(comm, resume_from)`` runs the fit on ``comm`` — building
    its arrays on that comm (or :meth:`DNDarray.reshard_`-ing existing
    ones in ``on_world_change``) and honoring
    ``checkpoint_every=...``/``resume_from=...`` — and returns the
    fitted result.  Every rank of ``comm`` runs the supervisor; the
    ``on_world_change`` hook runs on every rank of the old world (the ranks
    that leave too), and a rank left out of the new world returns None.  When it raises one of ``loss_types`` the supervisor
    recovers: shrink the world by the error's ``lost`` count (default
    ``shrink_by``), ``comm.reshape`` under the bounded init retry
    policy, and re-enter ``fit_fn`` with ``resume_from=checkpoint_dir``
    so the fit continues from its last durable step.  At most
    ``max_recoveries`` recoveries (``HEAT_TPU_ELASTIC_MAX_RECOVERIES``),
    never below ``min_world`` (``HEAT_TPU_ELASTIC_MIN_WORLD``).

    The recovery is observable end to end: ``elastic.worker_losses`` /
    ``elastic.reshapes`` counters, the ``elastic.recovery_ms`` histogram
    and the ``elastic.world_size`` gauge, plus the three registered
    fault sites ``elastic.detect`` / ``elastic.reshape`` /
    ``elastic.resume`` for scripting recovery-path faults.
    """

    def __init__(
        self,
        fit_fn: Callable[[Communication, Optional[str]], object],
        checkpoint_dir: str,
        comm: Optional[Communication] = None,
        *,
        max_recoveries: Optional[int] = None,
        min_world: Optional[int] = None,
        shrink_by: int = 1,
        loss_types: Tuple[Type[BaseException], ...] = (WorkerLostError,),
        retry_policy: Optional[RetryPolicy] = None,
        on_world_change: Optional[Callable[[Communication], None]] = None,
    ):
        self.fit_fn = fit_fn
        self.checkpoint_dir = checkpoint_dir
        self.comm = comm
        self.max_recoveries = (
            _env_int("HEAT_TPU_ELASTIC_MAX_RECOVERIES", 2)
            if max_recoveries is None
            else int(max_recoveries)
        )
        self.min_world = (
            _env_int("HEAT_TPU_ELASTIC_MIN_WORLD", 1)
            if min_world is None
            else int(min_world)
        )
        self.shrink_by = int(shrink_by)
        self.loss_types = tuple(loss_types)
        self.retry_policy = retry_policy or default_init_policy()
        self.on_world_change = on_world_change
        #: recoveries performed by the most recent :meth:`run`
        self.recoveries = 0
        #: the comm the most recent :meth:`run` finished (or gave up) on
        self.world: Optional[Communication] = None

    def _recover(self, world: Communication, err: BaseException) -> Communication:
        lost = int(getattr(err, "lost", 0) or 0) or self.shrink_by
        target = world.size - lost
        if target < self.min_world:
            raise ReshapeError(
                f"worker loss leaves {target} device(s), below the configured "
                f"minimum world size {self.min_world}",
                old_size=world.size,
                new_size=target,
            ) from err

        def _do_reshape() -> Communication:
            _inject("elastic.reshape", old=world.size, new=target)
            return world.reshape(target)

        new_world = self.retry_policy.call(_do_reshape)
        RESHAPES_C.inc()
        WORLD_G.set(new_world.size)
        _journal.emit(
            ACTOR_ELASTIC, ELASTIC_RESHAPE,
            severity="warn",
            message=(
                f"mesh reshaped {world.size} -> {new_world.size} after "
                f"worker loss ({type(err).__name__})"
            ),
            evidence={"old_world": world.size, "new_world": new_world.size,
                      "lost": lost, "error": type(err).__name__,
                      "recovery": self.recoveries},
        )
        if self.on_world_change is not None:
            self.on_world_change(new_world)
        _inject("elastic.resume", world_size=new_world.size)
        return new_world

    def run(self, resume_from: Optional[str] = None) -> object:
        """Run the fit to completion, recovering from worker losses."""
        world = self.comm if self.comm is not None else get_comm()
        WORLD_G.set(world.size)
        self.recoveries = 0
        resume = resume_from
        while True:
            try:
                result = self.fit_fn(world, resume)
            except self.loss_types as e:
                # detection: the loss surfaced as an exception; the
                # registered site lets a plan script detection faults
                _inject("elastic.detect", error=type(e).__name__)
                LOSSES_C.inc()
                self.recoveries += 1
                if self.recoveries > self.max_recoveries:
                    self.world = world
                    raise
                t0 = time.perf_counter()
                with _span(
                    "elastic.recover", old=world.size, attempt=self.recoveries
                ):
                    world = self._recover(world, e)
                    resume = self.checkpoint_dir
                RECOVERY_H.observe((time.perf_counter() - t0) * 1000.0)
                if not world.is_member:
                    # this rank handed over its part and is out of the fit
                    self.world = world
                    return None
                continue
            self.world = world
            return result
