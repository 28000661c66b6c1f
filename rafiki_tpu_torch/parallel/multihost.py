"""A dp worker group's shared vocabulary: the leader, and each rank's
slice of a global batch.

Counterpart of ``rafiki_tpu/parallel/multihost.py``. A width-W trial is
W processes in one ``torch.distributed`` group, one device each. The
control plane stays single-headed: rank 0 is the LEADER and runs the
normal trial loop (meta store writes, advisor calls, params
persistence); the other ranks run ``worker.follower.FollowerWorker``,
which mirrors the leader's trials step for step so the collectives
pair up.
"""

from __future__ import annotations

from typing import Dict

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
    out = {}
    for k, v in batch.items():
        v = np.asarray(v)
        if v.shape[0] % mesh.world_size:
            raise ValueError(f"a global batch of {v.shape[0]} rows does not split over "
                             f"{mesh.world_size} ranks")
        b = v.shape[0] // mesh.world_size
        t = torch.from_numpy(np.ascontiguousarray(v[mesh.rank * b:(mesh.rank + 1) * b]))
        if mesh.device.type == "cuda":
            t = t.pin_memory().to(mesh.device, non_blocking=True)
        out[k] = t
    return out
