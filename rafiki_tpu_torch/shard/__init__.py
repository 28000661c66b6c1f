"""Sharded-trial lane: one big trial sharded across a chip group.

The port's counterpart of ``rafiki_tpu/shard``. The sweep plane packs
many small trials per chip; this package is the inverse lane, for
trials whose train state outgrows one chip's memory:

* :mod:`~rafiki_tpu_torch.shard.plan`: :class:`ShardPlan`, a trial's
  leaf shapes + a memory estimate against the device's own memory ->
  the smallest group width under the ceiling, and each leaf's shard
  axis over a ``("shard",)`` group;
* :mod:`~rafiki_tpu_torch.shard.loop`: :class:`ShardedTrainLoop` /
  :func:`train_sharded`, the group's epoch loop, bit-identical to the
  serial loop at every width;
* :mod:`~rafiki_tpu_torch.shard.checkpoint`: per-shard chunk manifests
  with **reshard-on-restore**: a width-w checkpoint restores at any
  width w', which is how a group that loses a chip resumes on its
  survivors (``scheduler/mesh.py GroupHandle``).

The lane uses no ``torch.distributed``: a group runs in one process, as
the JAX package's ``shard_map`` does.
"""

from rafiki_tpu_torch.shard.checkpoint import (gather_state, is_manifest, load_manifest,
                                               restore_sharded, save_sharded)
from rafiki_tpu_torch.shard.loop import (GroupAborted, ShardedTrainLoop, sharded_program_key,
                                         train_sharded)
from rafiki_tpu_torch.shard.plan import ShardPlan, group_mesh, shard_axis, solve_width

__all__ = [
    "GroupAborted",
    "ShardPlan",
    "ShardedTrainLoop",
    "gather_state",
    "group_mesh",
    "is_manifest",
    "load_manifest",
    "restore_sharded",
    "save_sharded",
    "shard_axis",
    "sharded_program_key",
    "solve_width",
    "train_sharded",
]
