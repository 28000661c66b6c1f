"""Data-plane workers: the threads that touch the device.

Counterpart of ``rafiki_tpu/worker``.
"""

from rafiki_tpu_torch.worker.inference import InferenceWorker
from rafiki_tpu_torch.worker.train import AdvisorHandle, InProcAdvisorHandle, TrainWorker

__all__ = ["TrainWorker", "AdvisorHandle", "InProcAdvisorHandle", "InferenceWorker"]
