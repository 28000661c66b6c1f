"""Data-plane workers: the threads and processes that touch the device.

Counterpart of ``rafiki_tpu/worker``: workers run in a thread
(``LocalScheduler``) or as a subprocess pinned to its device
(``ProcessScheduler``, ``python -m rafiki_tpu_torch.worker.main``).
"""

from rafiki_tpu_torch.worker.inference import InferenceWorker
from rafiki_tpu_torch.worker.train import AdvisorHandle, InProcAdvisorHandle, TrainWorker

__all__ = ["TrainWorker", "AdvisorHandle", "InProcAdvisorHandle", "InferenceWorker"]
