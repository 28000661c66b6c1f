"""Training of the rest of the model zoo in the port against the JAX
package's, on the CPU: three float32 steps of DenseNet, the Transformer
and PosBiLstm from the same flax-drawn params (``tests/test_torch_zoo.py``
draws them), loss, sentinels and params. Each tolerance stands next to
the readings that set it.
"""

import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from rafiki_tpu_torch.convert import state_dict_to_flax
from rafiki_tpu_torch.model.log import logger as port_logger
from tests.test_torch_train import F32_TOL, _capture, check_readings, readings
from tests.test_torch_zoo import BLOBS, FAMILIES, _f32_pair, _flat

# See test_torch_train.py: two intra-op threads per xdist worker.
torch.set_num_threads(2)


def train_one(side, cls, knobs, blob, train_uri, eval_uri, steps):
    """``blob``'s params through load_parameters -> train -> evaluate in
    one package, with ``steps`` planned (the warmup reads them)."""
    m = cls(**knobs) if side == "jax" else cls(device="cpu", **knobs)
    m._planned_steps = steps
    m.load_parameters(blob)
    health = _capture(m)
    logs = []
    if side == "jax":
        from rafiki_tpu.model.log import logger
    else:
        logger = port_logger
    with logger.capture(logs.append):
        m.train(train_uri)
    score = m.evaluate(eval_uri)
    if side == "jax":
        params = {k: np.asarray(v) for k, v in flatten_dict(m._loop.params, sep="/").items()}
    else:
        params = {k: v.numpy() for k, v in state_dict_to_flax(m._module).items()}
    return {"values": [e["values"] for e in logs if e["type"] == "values"],
            "health": health, "score": score, "params": params, "model": m}


def _zero_gradient_leaves(runs, start, lr, steps):
    """Take out of each run's params the leaves whose exact gradient is
    zero: an attention key bias adds one constant to every score of a
    query, which the softmax over keys cancels, so its computed gradient
    is float32 rounding noise, which Adam's first steps scale up to
    about ``lr`` a step in either direction (every other leaf of the
    Transformer agrees to 3e-8 here). Each must stay within that of its
    start."""
    for run in runs:
        for k in [k for k in run["params"] if k.endswith("/key/bias")]:
            moved = float(np.abs(run["params"].pop(k) - start[k]).max())
            assert moved <= lr * steps, (k, moved)


# Three float32 steps at lr 1e-3 from the same params (DenseNet and the
# Transformer on the device-resident epoch, PosBiLstm fed from the host
# with its masked labels). The Transformer and PosBiLstm are held to
# test_torch_train's F32_TOL. Readings: Transformer (its key bias
# aside) params 3.4e-8 max abs, update norm 4.4e-6 rel, the rest equal;
# PosBiLstm loss 1.3e-7 rel, grad norm 4.6e-7, params 8.7e-7 max abs and
# 4.4e-6 of the distance moved; accuracies and scores equal.
#
# DenseNet's float32 training is more sensitive than that on its own:
# each of its 20 GroupNorm -> ReLU pairs sees about 6e5 activations at
# this size, and an activation within rounding of 0 takes the other side
# of the ReLU in one run, which changes the gradients upstream of it
# (one such element in a batch of 64 moved the stem's and the first
# layer's kernel gradients by 3e-4-8e-4 relative). Readings after three
# steps, port vs JAX / JAX vs JAX started one ulp away: loss 6.6e-6 /
# 8.2e-6 rel, grad norm 6.7e-4 / 1.2e-3, update norm 9.1e-6 / 5.0e-6,
# params 2.2e-3 / 2.2e-3 max abs and 6.9e-3 / 6.8e-3 of the distance
# moved, accuracies and scores equal. Its bounds: about 3x the port's
# readings.
DENSENET_F32_TOL = {"loss_rel": 3e-5, "acc": 1 / 64, "health_grad_norm_rel": 3e-3,
                    "health_update_norm_rel": 3e-5, "health_param_norm_rel": 1e-6,
                    "param_max_abs": 7e-3, "param_rel_l2": 2e-2, "score": 0.01}


def _f32_tol(family):
    return DENSENET_F32_TOL if family == "densenet" else F32_TOL


@pytest.mark.parametrize("family", list(FAMILIES))
def test_three_float32_steps_match_jax(family):
    jax_cls, port_cls = _f32_pair(family)
    knobs, pattern = FAMILIES[family][2], FAMILIES[family][3]
    args = (knobs, BLOBS[family], pattern.format(n=3 * knobs["batch_size"], seed=0),
            pattern.format(n=40, seed=1), 3)
    ref = train_one("jax", jax_cls, *args)
    got = train_one("port", port_cls, *args)
    assert [v["epoch"] for v in got["values"]] == [0]
    start = {k: v.float().numpy() for k, v in _flat(BLOBS[family]).items()}
    _zero_gradient_leaves((ref, got), start, knobs["learning_rate"], 3)
    check_readings(readings(ref, got, start), _f32_tol(family))


