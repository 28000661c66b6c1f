"""Trial schedulers.

Counterpart of ``rafiki_tpu/scheduler``: ``LocalScheduler`` runs a
train job with worker threads in one process, one device each;
``ProcessScheduler`` runs one subprocess per device, with the advisor
shared over loopback HTTP and a dp group per worker slot when a trial
spans several devices; ``recovery.recover_orphaned_trials`` re-runs the
trials of dead workers. The ``MeshSweepScheduler`` and the whole-sweep
resume are not ported yet (ROADMAP Queue 1, item 8).
"""

from rafiki_tpu_torch.scheduler.local import LocalScheduler, TrainJobResult
from rafiki_tpu_torch.scheduler.process import ProcessScheduler, worker_device_env

__all__ = ["LocalScheduler", "ProcessScheduler", "TrainJobResult", "worker_device_env"]
