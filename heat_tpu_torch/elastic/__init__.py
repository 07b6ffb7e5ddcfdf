"""Elastic execution: survive the loss of a worker, reshape the world,
resume the fit (counterpart of heat_tpu/elastic).

detect -> reshape -> resume
---------------------------
* **detect**: a loss surfaces as a typed exception
  (:class:`~heat_tpu_torch.resilience.errors.WorkerLostError`) in process,
  or as a dead or stale worker process under the
  :class:`~heat_tpu_torch.elastic.process.ProcessSupervisor` (its exit code,
  and the heartbeat file every ``resumable_fit_loop`` chunk boundary touches
  when ``HEAT_TPU_HEARTBEAT_FILE`` is set).  Fault site ``elastic.detect``.
* **reshape**: in process, ``comm.reshape(n)`` makes the communication of
  the ranks that stay (every rank of the old world takes part); live arrays
  move with :meth:`~heat_tpu_torch.core.dndarray.DNDarray.reshard_`,
  checkpointed state re-splits through ``Checkpointer.restore(...,
  comm=new)``.  Across processes the supervisor relaunches a smaller world.
  Fault site ``elastic.reshape``.
* **resume**: the fit re-enters ``resumable_fit_loop`` with
  ``resume_from=<checkpoint_dir>`` and goes on from the last durable step
  on the new world.  A resume at the same size is bitwise the
  uninterrupted fit; a smaller world converges to it within the
  reduction-order tolerance.  Fault site ``elastic.resume``.

Telemetry: the ``elastic.worker_losses`` and ``elastic.reshapes``
counters, the ``elastic.recovery_ms`` histogram and the
``elastic.world_size`` gauge (:func:`elastic_state`).
"""

from __future__ import annotations

from ..resilience.errors import ReshapeError, WorkerLostError
from .supervisor import ElasticSupervisor, HeartbeatMonitor, elastic_state
from .process import ProcessSupervisor, kmeans_worker_source

__all__ = [
    "ElasticSupervisor",
    "HeartbeatMonitor",
    "ProcessSupervisor",
    "ReshapeError",
    "WorkerLostError",
    "elastic_state",
    "kmeans_worker_source",
]
