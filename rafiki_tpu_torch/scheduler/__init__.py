"""Trial schedulers.

Counterpart of ``rafiki_tpu/scheduler``: ``LocalScheduler`` runs a
train job with worker threads in one process, one device each;
``ProcessScheduler`` runs one subprocess per device, with the advisor
shared over loopback HTTP and a dp group per worker slot when a trial
spans several devices; ``MeshSweepScheduler`` drives the whole mesh as
ONE sweep (k packed trials per chip x N chips from one batched draft,
every claim bracketed in a write-ahead log, chip loss re-packed, a
sharded lane for trials wider than a chip); ``recovery`` re-runs the
trials of dead workers (``recover_orphaned_trials``) and adopts a dead
supervisor's whole sweep (``resume_sweep``), which ``python -m
rafiki_tpu_torch.scheduler.sweep_proc`` runs in a process of its own.
"""

from rafiki_tpu_torch.scheduler.local import LocalScheduler, TrainJobResult
from rafiki_tpu_torch.scheduler.mesh import MeshSweepScheduler
from rafiki_tpu_torch.scheduler.process import ProcessScheduler, worker_device_env

__all__ = ["LocalScheduler", "MeshSweepScheduler", "ProcessScheduler", "TrainJobResult",
           "worker_device_env"]
