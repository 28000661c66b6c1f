"""Trial schedulers.

Counterpart of ``rafiki_tpu/scheduler``: ``LocalScheduler`` runs a
train job with worker threads in one process, one device each, and
``recovery.recover_orphaned_trials`` re-runs the trials of dead workers.
The process-per-worker ``ProcessScheduler``, the ``MeshSweepScheduler``
and the whole-sweep resume are not ported yet.
"""

from rafiki_tpu_torch.scheduler.local import LocalScheduler, TrainJobResult

__all__ = ["LocalScheduler", "TrainJobResult"]
