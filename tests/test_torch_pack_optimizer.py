"""Packing a template with its own ``make_optimizer``, on the CPU.

The JAX package packs such a template (``rafiki_tpu/model/base.py
packable`` checks only ``preprocess``); its program key bakes every knob
but the seed, and the planned steps, so a pack's members differ only by
seed. The port packs it too: each member keeps its own counts of
optax's ``adam(linear_schedule(0, lr, warmup))`` and applies its own
``-schedule(count)``. Three members (one learning rate, seeds 0, 5, 7,
every member from the same flax-drawn float32 params, so only their
shuffles differ) for two epochs must end where their serial trials end,
bit for bit, and where the JAX package's pack of the same template
ends, within ``tests/test_torch_train.py`` F32_TOL (readings: loss
2.3e-7 rel, params 7.1e-8 max abs and 3.2e-7 of the distance moved,
accuracies and scores equal).
"""

import numpy as np
import torch

from rafiki_tpu_torch.ops import train as ops_train
from rafiki_tpu_torch.ops.optim import AdamState
from tests.test_torch_pack import (
    FF_INIT, FF_KNOBS, TRAIN, VAL, JaxFFConst, PortFFConst, _jax_params, _pack_readings, _params,
    port_train_logger)
from tests.test_torch_train import F32_TOL, blob_params

# See test_torch_train.py: two intra-op threads per xdist worker.
torch.set_num_threads(2)

KNOBS = dict(FF_KNOBS, learning_rate=2e-3)
SEEDS = (0, 5, 7)


class JaxFFOpt(JaxFFConst):
    def make_optimizer(self):
        return super().make_optimizer()


class PortFFOpt(PortFFConst):
    def make_optimizer(self):
        return super().make_optimizer()


def _make(cls, seed, jax_side=False):
    m = cls(**KNOBS) if jax_side else cls(device="cpu", **KNOBS)
    m._seed = seed
    return m


def _pack(cls, jax_side=False):
    models = [_make(cls, s, jax_side) for s in SEEDS]
    histories = cls.train_packed(models, TRAIN)
    scores = cls.evaluate_packed(models, VAL)
    params = [_jax_params(m) if jax_side else {k: v.numpy() for k, v in _params(m).items()}
              for m in models]
    return models, [{"history": h, "score": s, "params": p}
                    for h, s, p in zip(histories, scores, params)]


def test_a_make_optimizer_template_packs_as_in_the_jax_package():
    assert PortFFOpt.packable() and JaxFFOpt.packable()
    models, got = _pack(PortFFOpt)
    packed = models[0]._loop.packed
    # The complete optimizer's pack: no per-member lr, its own counts.
    assert packed.state.hyper == {} and isinstance(packed.state.opt, AdamState)
    assert packed.state.opt.count == (2 * (256 // 64),) * 3
    assert packed._perf_key == ops_train.packed_program_key(
        packed._program_key, 3, False)
    _, ref = _pack(JaxFFOpt, jax_side=True)
    r = _pack_readings(ref, got, blob_params(FF_INIT))
    print(r)
    for key in r:
        assert r[key] <= F32_TOL[key], (key, r)


def test_a_make_optimizer_pack_member_is_its_serial_trial():
    _, got = _pack(PortFFOpt)
    for seed, member in zip(SEEDS, got):
        m = _make(PortFFOpt, seed)
        logs = []
        with port_train_logger().capture(logs.append):
            m.train(TRAIN)
        assert [e["values"] for e in logs if e["type"] == "values"] == member["history"]
        assert m.evaluate(VAL) == member["score"]
        serial = {k: v.numpy() for k, v in _params(m).items()}
        for k in serial:
            np.testing.assert_array_equal(member["params"][k], serial[k])
