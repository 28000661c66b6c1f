"""Device sets and the data-parallel mesh.

Counterpart of ``rafiki_tpu/parallel/mesh.py``: the scheduler thinks in
*device sets*, and each train worker owns one. ``local_devices`` is
``utils/backend.local_devices`` (every CUDA card, or ``[cpu]`` on
request).

``data_parallel_mesh`` is the counterpart of the JAX package's 1-axis
``Mesh(("dp",))`` (``rafiki_tpu/parallel/mesh.py:29-33``). It gives one
of two meshes:

  * :class:`LocalDataParallelMesh`, for a set of several devices in a
    process of no process group: the JAX package's in-process mesh, one
    process owning k devices (``rafiki_tpu/worker/train.py:276-279``).
    Replica r of the trial is the pair ``(r, devices[r])``, so a device
    may repeat, as a chip of the mesh sweep may share a card:
    ``[cuda:0, cuda:0]`` is two replicas on one card, and ``[cpu, cpu]``
    the CPU's only width-2 set (torch has one CPU device). One host
    thread runs the replicas in lockstep (``ops/train.py``).
  * :class:`DataParallelMesh`, for one device in an initialised
    ``torch.distributed`` process group (``nccl`` on the card, ``gloo``
    on the CPU), which ``worker/main.py`` joins before the first trial: a
    width-W trial is W processes, each a rank of the group, and the mesh
    records this rank, the world size and the rank's device.

Several devices inside a process group (the JAX package's multihost
hybrid, a process owning k devices) are refused: the port's
``ProcessScheduler`` gives each rank one device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional, Sequence, Tuple, Union

import torch

from rafiki_tpu_torch.utils.backend import local_devices

__all__ = ["DataParallelMesh", "LocalDataParallelMesh", "data_parallel_mesh",
           "local_devices", "partition_devices"]

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
    in_process = False


@dataclass(frozen=True)
class LocalDataParallelMesh:
    """A 1-D ``"dp"`` mesh of ``world_size`` replicas in this process:
    replica r computes on ``devices[r]`` (devices may repeat). ``device``
    is replica 0's, where the trial's own state lives; ``rank`` is 0, the
    process's index, as ``jax.process_index()`` is for the JAX package's
    in-process mesh."""

    devices: Tuple[torch.device, ...]
    axis_names = ("dp",)
    in_process = True
    rank = 0

    @property
    def world_size(self) -> int:
        return len(self.devices)

    @property
    def device(self) -> torch.device:
        return self.devices[0]


def data_parallel_mesh(devices: Sequence, group: Optional[Any] = None
                       ) -> Union[DataParallelMesh, LocalDataParallelMesh]:
    """The dp mesh of this process over ``devices``, its device set.

    Several devices, and no initialised process group: the in-process
    mesh of that many replicas (module doc). They must be of one type.

    One device: this process is a rank of ``group``, an initialised
    process group (default: the default group), whose backend must be
    the device's (``BACKENDS``): a card's collectives never run over
    gloo, nor the CPU's over NCCL."""
    import torch.distributed as dist

    devices = [torch.device(d) for d in devices]
    if not devices:
        raise ValueError("a dp mesh needs at least one device")
    in_group = dist.is_available() and dist.is_initialized()
    if len(devices) > 1:
        if in_group:
            raise NotImplementedError(
                f"a rank of a process group owns one device; got {len(devices)} (the JAX "
                "package's multihost hybrid, a process owning several devices, is not "
                "ported: the ProcessScheduler runs one rank per device)")
        if len({d.type for d in devices}) != 1:
            raise ValueError(f"a dp mesh's devices are of one type; got {devices}")
        return LocalDataParallelMesh(devices=tuple(_indexed(d) for d in devices))
    if not in_group:
        raise RuntimeError("data_parallel_mesh over one device needs an initialised "
                           "torch.distributed process group (worker/main.py joins it)")
    device = devices[0]
    backend = str(dist.get_backend(group))
    if backend != BACKENDS[device.type]:
        raise ValueError(f"a {device.type} rank needs a {BACKENDS[device.type]} group, "
                         f"not {backend}")
    return DataParallelMesh(group=group, rank=dist.get_rank(group),
                            world_size=dist.get_world_size(group), device=_indexed(device))


def _indexed(device: torch.device) -> torch.device:
    """A card by its index (plain ``cuda`` is the current card)."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


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
