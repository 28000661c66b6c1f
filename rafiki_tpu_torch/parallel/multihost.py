"""A dp worker group's shared vocabulary: the leader, and each rank's
slice of a global batch.

Counterpart of ``rafiki_tpu/parallel/multihost.py``. A width-W trial is
W processes in one ``torch.distributed`` group, one device each, or W
replicas of an in-process mesh (``replica_put`` gives each its rows). The
control plane stays single-headed: rank 0 is the LEADER and runs the
normal trial loop (meta store writes, advisor calls, params
persistence); the other ranks run ``worker.follower.FollowerWorker``,
which mirrors the leader's trials step for step so the collectives
pair up.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch


def is_leader() -> bool:
    """Rank 0 of the default process group owns the control plane (a
    process in no group leads itself)."""
    import torch.distributed as dist

    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def global_put(batch: Dict[str, np.ndarray], mesh) -> Dict[str, torch.Tensor]:
    """This rank's contiguous slice of a host batch whose full value is
    known, identically, on every rank: rows ``[r*B/W, (r+1)*B/W)`` on
    the rank's device. Every rank draws the same global batch (an
    epoch's order is seeded by the trial seed and the epoch), so the W
    slices tile it. To a card the copy goes from pinned memory, without
    waiting."""
    return _rows(batch, mesh.rank, mesh.world_size, mesh.device)


def replica_put(batch: Dict[str, np.ndarray], mesh) -> List[Dict[str, torch.Tensor]]:
    """An in-process mesh's slices of a host batch: replica r's rows
    ``[r*B/k, (r+1)*B/k)`` on ``mesh.devices[r]``, in replica order, the
    rows :func:`global_put` gives rank r of a group."""
    return [_rows(batch, r, mesh.world_size, device) for r, device in enumerate(mesh.devices)]


def _rows(batch: Dict[str, np.ndarray], rank: int, world: int,
          device: torch.device) -> Dict[str, torch.Tensor]:
    out = {}
    for k, v in batch.items():
        v = np.asarray(v)
        if v.shape[0] % world:
            raise ValueError(f"a global batch of {v.shape[0]} rows does not split over "
                             f"{world} ranks")
        b = v.shape[0] // world
        t = torch.from_numpy(np.ascontiguousarray(v[rank * b:(rank + 1) * b]))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t
    return out
