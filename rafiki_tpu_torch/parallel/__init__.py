"""Parallelism: device lists, the data-parallel mesh and the
stacked-ensemble forward.

Counterpart of ``rafiki_tpu/parallel``.
"""

from rafiki_tpu_torch.parallel.mesh import data_parallel_mesh, local_devices, partition_devices

__all__ = ["data_parallel_mesh", "local_devices", "partition_devices"]
