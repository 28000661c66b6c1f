"""Parallelism: device lists and the stacked-ensemble forward.

Counterpart of ``rafiki_tpu/parallel``. Not exported yet:
``data_parallel_mesh``, with within-trial data parallelism (ROADMAP
Queue 1 item 7).
"""

from rafiki_tpu_torch.parallel.mesh import local_devices, partition_devices

__all__ = ["local_devices", "partition_devices"]
