"""The port's FeedForward against the JAX package's, on the CPU.

The SURVEY's minimum slice model: the forward in float32 and bf16, the
params carrier, the training loop in float32 and bf16 (the device-
resident and the batch-feeding paths, after 1 and 5 steps), and the
trial through the model contract, served by the other package. Inputs
are made from numpy seeds; each tolerance stands next to its readings.
The loop helpers are shared with ``test_torch_train.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from rafiki_tpu.models.ff import FeedForward as JaxFeedForward, _Mlp as JaxMlp
from rafiki_tpu_torch.convert import flax_to_state_dict, state_dict_to_flax
from rafiki_tpu_torch.models.ff import FeedForward, _Mlp
from tests.test_torch_train import (
    _f32, blob_params, check_readings, flax_init_blob, jax_side_without_excess_precision,
    readings, set_path, train_one)

# See test_torch_train.py: two intra-op threads per xdist worker.
torch.set_num_threads(2)

FF_KNOBS = dict(hidden_layers=2, hidden_units=32, learning_rate=1e-3, batch_size=32,
                epochs=1, seed=0)
IMAGES = "synthetic://images?classes=10&w=8&h=8&c=1&n={n}&seed={seed}"
SHAPE = (8, 8, 1)

JaxFF32, FF32 = _f32(
    JaxFeedForward, FeedForward,
    lambda m, nc, shape, dt: JaxMlp(hidden_layers=m.knobs["hidden_layers"],
                                    hidden_units=m.knobs["hidden_units"], num_classes=nc, dtype=dt),
    lambda m, nc, shape, dt: _Mlp(m.knobs["hidden_layers"], m.knobs["hidden_units"], nc, shape,
                                  dtype=dt))


def _flax_params(hidden_layers, seed=0):
    mod = JaxMlp(hidden_layers=hidden_layers, hidden_units=32, num_classes=10, dtype=jnp.float32)
    params = mod.init(jax.random.PRNGKey(seed), jnp.zeros((1,) + SHAPE))["params"]
    return {k: np.asarray(v) for k, v in flatten_dict(params, sep="/").items()}


@pytest.mark.parametrize("hidden_layers", [1, 2, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_forward_matches_flax(hidden_layers, dtype):
    """Same params, same queries: float32 logits agree to rounding, bf16
    probabilities within the serving slice's bf16 bound (5e-3)."""
    flat = _flax_params(hidden_layers)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    x = np.random.default_rng(hidden_layers).uniform(0, 1, size=(16,) + SHAPE).astype(np.float32)
    ref_mod = JaxMlp(hidden_layers=hidden_layers, hidden_units=32, num_classes=10, dtype=jdt)
    from flax.traverse_util import unflatten_dict

    params = unflatten_dict({tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()})
    ref = np.asarray(ref_mod.apply({"params": params}, jnp.asarray(x)).astype(jnp.float32))
    port = _Mlp(hidden_layers, 32, 10, SHAPE, dtype=tdt)
    port.load_state_dict(flax_to_state_dict(flat, port))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert got.dtype == tdt
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
    else:
        probs = lambda z: np.asarray(jax.nn.softmax(jnp.asarray(z, jnp.float32), -1))
        np.testing.assert_allclose(probs(got.float().numpy()), probs(ref), rtol=0, atol=5e-3)


def test_convert_names_the_mlp_layers_as_flax_does():
    flat = _flax_params(3)
    assert sorted(flat) == [f"Dense_{i}/{p}" for i in range(4) for p in ("bias", "kernel")]
    port = _Mlp(3, 32, 10, SHAPE, dtype=torch.float32)
    port.load_state_dict(flax_to_state_dict(flat, port))
    back = state_dict_to_flax(port)
    assert sorted(back) == sorted(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k].numpy(), flat[k])


def ff_blob():
    return flax_init_blob(JaxMlp(hidden_layers=2, hidden_units=32, num_classes=10,
                                 dtype=jnp.float32), SHAPE)


# float32, FF 2x32 on 8x8x1, batch 32, lr 1e-3 (warmup: 1 step).
# Readings (max over fast/feed x 1/5 steps): loss 1.1e-7 rel, grad norm
# 1.5e-7, update norm 1.8e-6, param norm 1.2e-7, params 3.0e-8 max abs
# and 5.6e-7 of the distance they moved, last-batch acc and eval score
# equal. Bounds: about 3x the readings, with acc and score allowing one
# flip.
F32_TOL = {"loss_rel": 1e-6, "acc": 1 / 32, "health_grad_norm_rel": 1e-6,
           "health_update_norm_rel": 6e-6, "health_param_norm_rel": 1e-6,
           "param_max_abs": 1e-7, "param_rel_l2": 2e-6, "score": 0.01}


@pytest.mark.parametrize("steps", [1, 5])
@pytest.mark.parametrize("path", ["fast", "feed"])
def test_ff_training_matches_jax_in_float32(steps, path, monkeypatch):
    set_path(monkeypatch, path)
    blob = ff_blob()
    args = (FF_KNOBS, blob, IMAGES.format(n=32 * steps, seed=0), IMAGES.format(n=100, seed=1))
    ref = train_one("jax", JaxFF32, *args)
    got = train_one("port", FF32, *args)
    check_readings(readings(ref, got, blob_params(blob)), F32_TOL)


# bf16 compute (as the model ships), JAX without excess precision (see
# test_torch_train.BF16_TOL). Readings (fast and feed alike): after 1
# step loss 1.0e-7 rel, grad norm 2.0e-4, update norm 1.7e-6, param norm
# 1.1e-7, params 4.5e-7 of the distance moved; after 5 steps loss
# 1.0e-4, grad norm 6.1e-4, update norm 1.8e-6, param norm 4.5e-7,
# params 6.4e-3 of the distance moved; last-batch acc and eval score
# equal. Bounds: about 3x, with acc and score allowing one flip.
BF16_TOL = {
    1: {"loss_rel": 1e-6, "acc": 1 / 32, "health_grad_norm_rel": 6e-4,
        "health_update_norm_rel": 6e-6, "health_param_norm_rel": 1e-6,
        "param_rel_l2": 2e-6, "score": 0.01},
    5: {"loss_rel": 3e-4, "acc": 1 / 32, "health_grad_norm_rel": 2e-3,
        "health_update_norm_rel": 6e-6, "health_param_norm_rel": 2e-6,
        "param_rel_l2": 2e-2, "score": 0.01},
}
CASES = [(path, steps) for path in ("fast", "feed") for steps in (1, 5)]


@pytest.fixture(scope="module")
def ff_bf16_jax_runs(tmp_path_factory):
    blob = ff_blob()
    jobs = [(path, "rafiki_tpu.models.ff:FeedForward",
             (FF_KNOBS, blob, IMAGES.format(n=32 * steps, seed=0), IMAGES.format(n=100, seed=1)))
            for path, steps in CASES]
    runs = jax_side_without_excess_precision(jobs, tmp_path_factory.mktemp("ff"))
    return blob, dict(zip(CASES, runs))


@pytest.mark.parametrize("path,steps", CASES)
def test_ff_training_matches_jax_in_bf16(path, steps, ff_bf16_jax_runs, monkeypatch):
    blob, ref = ff_bf16_jax_runs
    set_path(monkeypatch, path)
    got = train_one("port", FeedForward, FF_KNOBS, blob, IMAGES.format(n=32 * steps, seed=0),
                    IMAGES.format(n=100, seed=1))
    check_readings(readings(ref[(path, steps)], got, blob_params(blob)), BF16_TOL[steps])


def test_ff_trial_through_the_contract_serves_in_both_packages():
    """The minimum slice: FeedForward trains, evaluates and dumps on the
    CPU through the port; the blob serves in the port and in the JAX
    package alike, and evaluates the same. Readings: eval score 0.914;
    served probabilities 5.3e-3 apart (both bf16 forwards of a trained,
    confident model; XLA keeps excess precision in this process); the
    JAX package's eval score one example of 256 lower."""
    knobs = dict(FF_KNOBS, hidden_layers=1, learning_rate=1e-2, epochs=3)
    m = FeedForward(device="cpu", **knobs)
    m.train(IMAGES.format(n=1024, seed=0))
    score = m.evaluate(IMAGES.format(n=256, seed=1))
    assert score > 0.8  # a learnable task: chance is 0.1
    blob = m.dump_parameters()
    served, ref = FeedForward(device="cpu", **knobs), JaxFeedForward(**knobs)
    served.load_parameters(blob)
    ref.load_parameters(blob)
    queries = np.random.default_rng(3).uniform(0, 1, size=(10,) + SHAPE).astype(np.float32)
    got, want = np.asarray(served.predict(queries.tolist())), np.asarray(ref.predict(queries.tolist()))
    assert got.shape == (10, 10)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-2)
    np.testing.assert_allclose(got, m.predict_proba(queries), rtol=0, atol=1e-6)
    assert served.evaluate(IMAGES.format(n=256, seed=1)) == score
    assert abs(ref.evaluate(IMAGES.format(n=256, seed=1)) - score) <= 3 / 256
