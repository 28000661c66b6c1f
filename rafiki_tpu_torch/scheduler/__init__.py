"""Trial schedulers.

Counterpart of ``rafiki_tpu/scheduler``: ``LocalScheduler`` runs a
train job with worker threads in one process, one device each. The
process-per-worker ``ProcessScheduler``, the ``MeshSweepScheduler`` and
crash recovery are not ported yet.
"""

from rafiki_tpu_torch.scheduler.local import LocalScheduler, TrainJobResult

__all__ = ["LocalScheduler", "TrainJobResult"]
