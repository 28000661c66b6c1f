"""The compute path: the train step, losses, metrics, programs.

Counterpart of ``rafiki_tpu/ops``. Everything that touches the device
goes through here or through ``rafiki_tpu_torch.parallel``. Not
exported yet, with the compiled step and its program cache (ROADMAP
Queue 1 item 2): ``get_program``, ``program_cache_stats``,
``clear_program_cache``, ``make_train_step``, ``make_eval_step`` and
``make_predict_fn``.
"""

from rafiki_tpu_torch.ops.train import (
    DYNAMIC_KNOBS,
    Program,
    TrainLoop,
    cross_entropy_loss,
    dropout,
)

__all__ = [
    "DYNAMIC_KNOBS",
    "Program",
    "TrainLoop",
    "cross_entropy_loss",
    "dropout",
]
