"""Device sets for the scheduler.

Counterpart of ``rafiki_tpu/parallel/mesh.py``: the scheduler thinks in
*device sets*, and each train worker owns one. ``local_devices`` is
``utils/backend.local_devices`` (every CUDA card, or ``[cpu]`` on
request). The dp mesh (``data_parallel_mesh``) is not ported: a
worker's set is one card.
"""

from __future__ import annotations

from typing import List, Sequence

from rafiki_tpu_torch.utils.backend import local_devices

__all__ = ["local_devices", "partition_devices"]


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
