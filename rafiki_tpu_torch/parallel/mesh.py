"""Device sets and the data-parallel mesh.

Counterpart of ``rafiki_tpu/parallel/mesh.py``: the scheduler thinks in
*device sets*, and each train worker owns one. ``local_devices`` is
``utils/backend.local_devices`` (every CUDA card, or ``[cpu]`` on
request).

``data_parallel_mesh`` is the counterpart of the JAX package's 1-axis
``Mesh(("dp",))``. There, one process owns k devices and XLA inserts the
gradient all-reduce; in the port one process owns one device, and a
width-W trial is W processes in one ``torch.distributed`` process group
(``nccl`` on the card, ``gloo`` on the CPU), which ``worker/main.py``
joins before the first trial. The mesh is a small record of that group:
its rank, its world size and this rank's device. ``ops/train.py``
reduces each step's gradients over it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional, Sequence

import torch

from rafiki_tpu_torch.utils.backend import local_devices

__all__ = ["data_parallel_mesh", "local_devices", "partition_devices"]

#: The process-group backend of each device type.
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


@dataclass(frozen=True)
class DataParallelMesh:
    """A 1-D ``"dp"`` mesh over the ranks of ``group``: this process is
    ``rank`` of ``world_size`` and computes on ``device``. ``group`` None
    is the default process group."""

    group: Any
    rank: int
    world_size: int
    device: torch.device
    axis_names = ("dp",)


def data_parallel_mesh(devices: Sequence, group: Optional[Any] = None) -> DataParallelMesh:
    """The dp mesh of this process: ``devices`` is its device set, which
    must be one device (a rank owns one device), and ``group`` the
    initialised process group it is a rank of (default: the default
    group). The group's backend must be the device's (``BACKENDS``):
    a card's collectives never run over gloo, nor the CPU's over NCCL."""
    import torch.distributed as dist

    devices = [torch.device(d) for d in devices]
    if len(devices) != 1:
        raise NotImplementedError(
            f"a dp rank owns one device; got {len(devices)} (several devices in one "
            "process: ROADMAP Queue 1, item 7, the in-process multi-device worker)")
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("data_parallel_mesh needs an initialised torch.distributed "
                           "process group (worker/main.py joins it)")
    device = devices[0]
    backend = str(dist.get_backend(group))
    if backend != BACKENDS[device.type]:
        raise ValueError(f"a {device.type} rank needs a {BACKENDS[device.type]} group, "
                         f"not {backend}")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return DataParallelMesh(group=group, rank=dist.get_rank(group),
                            world_size=dist.get_world_size(group), device=device)


def partition_devices(devices: Sequence, n_workers: int) -> List[List]:
    """Split a device list into n_workers contiguous groups.

    len(devices) must be divisible by n_workers so every worker's set
    has the same size (uniform trial throughput).
    """
    devices = list(devices)
    if n_workers <= 0:
        raise ValueError("n_workers must be positive")
    if len(devices) % n_workers != 0:
        raise ValueError(
            f"{len(devices)} devices do not split evenly over {n_workers} workers")
    per = len(devices) // n_workers
    return [devices[i * per : (i + 1) * per] for i in range(n_workers)]
