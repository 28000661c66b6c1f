"""Query/prediction bus between the predictor and inference workers.

Counterpart of ``rafiki_tpu/bus``: the in-process bus (plain queues and
a dict) and the multiprocessing bus with the same interface, so the
predictor and inference workers can live in separate processes.
"""

from rafiki_tpu_torch.bus.queues import InProcBus, make_mp_bus

__all__ = ["InProcBus", "make_mp_bus"]
