"""Query/prediction bus between the predictor and inference workers.

Counterpart of ``rafiki_tpu/bus``. Not exported yet: ``make_mp_bus``,
the multiprocessing bus (ROADMAP Queue 1 item 13).
"""

from rafiki_tpu_torch.bus.queues import InProcBus

__all__ = ["InProcBus"]
