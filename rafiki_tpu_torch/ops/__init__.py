"""The compute path: the train step, losses, metrics, programs.

Counterpart of ``rafiki_tpu/ops``, with its whole ``__all__``.
Everything that touches the device goes through here or through
``rafiki_tpu_torch.parallel``. Where the JAX package compiles a step
with ``jit``, the port captures it as a CUDA graph (``ops/graphs.py``),
and ``get_program`` caches the programs process-wide as the JAX
package's cache does.
"""

from rafiki_tpu_torch.ops.train import (
    DYNAMIC_KNOBS,
    Program,
    TrainLoop,
    clear_program_cache,
    cross_entropy_loss,
    dropout,
    get_program,
    make_eval_step,
    make_predict_fn,
    make_train_step,
    program_cache_stats,
)

__all__ = [
    "DYNAMIC_KNOBS",
    "Program",
    "TrainLoop",
    "clear_program_cache",
    "cross_entropy_loss",
    "dropout",
    "get_program",
    "make_train_step",
    "make_eval_step",
    "make_predict_fn",
    "program_cache_stats",
]
