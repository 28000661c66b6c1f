"""The stacked forward split into member groups (``StackedEnsemble(
devices=...)``, ``build_stacked(devices=...)``) against the one-device
stacked forward, the serial forwards and the JAX package's forward
sharded over a ``("model",)`` mesh axis, on the CPU.

torch has one CPU device, so a set of n CPU devices is ``[cpu] * n``:
n member groups in one process, as the JAX package's tests split an
ensemble over n of their eight faked CPU devices. A member's forward is
the same in any group, so in float32 the split forward is the
one-device forward bit for bit; against the JAX package it is held to
the bounds the cross-package forwards already meet.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from rafiki_tpu.models.ff import _Mlp as JaxMlp
from rafiki_tpu.models.vgg import Vgg as JaxVgg, _Vgg as JaxVggModule
from rafiki_tpu.parallel.ensemble import StackedEnsemble as JaxStackedEnsemble
from rafiki_tpu.parallel.serving import build_stacked as jax_build_stacked
from rafiki_tpu_torch.convert import flax_to_state_dict
from rafiki_tpu_torch.models.ff import _Mlp
from rafiki_tpu_torch.models.vgg import Vgg, _Vgg
from rafiki_tpu_torch.ops.train import predict
from rafiki_tpu_torch.parallel.ensemble import StackedEnsemble
from rafiki_tpu_torch.parallel.serving import build_stacked, try_build_stacked

# See test_torch_train.py: two intra-op threads per xdist worker.
torch.set_num_threads(2)

CPU = torch.device("cpu")
SHAPE = (8, 8, 3)
# The float32 VGG forward's probabilities, port against JAX
# (tests/test_torch_vgg.py's bound), and the bf16 serving blobs' (its
# BF16_PROB_ATOL, which tests/test_torch_serving.py holds the stacked
# route to).
F32_PROB_ATOL = 1e-5
BF16_PROB_ATOL = 5e-3
SMALL = dict(depth=11, width_mult=0.25, dropout=0.0, learning_rate=1e-3, batch_size=64,
             epochs=1, seed=0)


def _x(n=6, seed=7):
    return np.random.default_rng(seed).uniform(0, 1, size=(n,) + SHAPE).astype(np.float32)


@pytest.fixture(scope="module")
def vgg_f32():
    """Four float32 VGG11 w0.25 members from flax's init: the JAX params
    and the port's modules holding the same values."""
    jax_mod = JaxVggModule(depth=11, width_mult=0.25, num_classes=10, dropout=0.0,
                           dtype=jnp.float32)
    params, modules = [], []
    for seed in range(4):
        p = jax.jit(jax_mod.init)(jax.random.PRNGKey(seed), jnp.zeros((1,) + SHAPE))["params"]
        params.append(p)
        port = _Vgg(11, 0.25, 10, SHAPE, dtype=torch.float32)
        flat = {k: np.asarray(v) for k, v in flatten_dict(p, sep="/").items()}
        port.load_state_dict(flax_to_state_dict(flat, port))
        modules.append(port.eval())
    return jax_mod, params, modules


def test_four_f32_members_over_two_devices_bit_match_one_device_and_serial(vgg_f32):
    """Two groups of two: the contract of
    test_stacked_bit_matches_host_ensemble_of_serial_forwards, with the
    ensemble split."""
    _, _, modules = vgg_f32
    x = torch.from_numpy(_x())
    ens = StackedEnsemble(modules, devices=[CPU, CPU])
    assert ens.mesh == (CPU, CPU) and [d for d, _ in ens.groups] == [CPU, CPU]
    one = StackedEnsemble(modules)
    assert one.mesh is None and len(one.groups) == 1
    with torch.inference_mode():
        serial = np.stack([predict(m, x).numpy() for m in modules])
        fwd = ens.forward(x).numpy()
    got = ens.predict_proba(x)
    assert got.shape == (4, 6, 10)
    np.testing.assert_array_equal(got, one.predict_proba(x))
    np.testing.assert_array_equal(got, serial)
    np.testing.assert_array_equal(fwd, got)
    np.testing.assert_array_equal(ens.ensemble_proba(x), one.ensemble_proba(x))


@pytest.mark.parametrize("k, n_devices", [(3, 2), (4, 4), (4, 2), (4, 3), (6, 4), (2, 1)])
def test_the_groups_follow_the_jax_packages_divisor_rule(k, n_devices):
    """n = the largest divisor of k that is at most the device count:
    k=3 over 2 devices is one group (no mesh), k=4 over 4 four groups of
    one, as the JAX package's ``StackedEnsemble(devices=)`` splits them.
    Whatever the split, the forward is the one-device forward."""
    jax_mod = JaxMlp(hidden_layers=1, hidden_units=16, num_classes=5, dtype=jnp.float32)
    jparams, modules = [], []
    for seed in range(k):
        p = jax.jit(jax_mod.init)(jax.random.PRNGKey(seed), jnp.zeros((1, 4, 4, 1)))["params"]
        jparams.append(p)
        port = _Mlp(1, 16, 5, (4, 4, 1), dtype=torch.float32)
        flat = {key: np.asarray(v) for key, v in flatten_dict(p, sep="/").items()}
        port.load_state_dict(flax_to_state_dict(flat, port))
        modules.append(port.eval())
    want = JaxStackedEnsemble(lambda p, b: jax_mod.apply({"params": p}, b["x"]), jparams,
                              devices=jax.devices()[:n_devices])
    n = 1 if want.mesh is None else want.mesh.devices.size
    ens = StackedEnsemble(modules, devices=[CPU] * n_devices)
    assert len(ens.groups) == n and (ens.mesh is None) == (want.mesh is None)
    x = np.random.default_rng(k).uniform(0, 1, size=(5, 4, 4, 1)).astype(np.float32)
    np.testing.assert_array_equal(ens.predict_proba(torch.from_numpy(x)),
                                  StackedEnsemble(modules).predict_proba(torch.from_numpy(x)))


def test_f32_groups_agree_with_the_jax_sharded_forward(vgg_f32):
    jax_mod, params, modules = vgg_f32
    x = _x()
    ref = JaxStackedEnsemble(lambda p, b: jax_mod.apply({"params": p}, b["x"], train=False),
                             params, devices=jax.devices()[:2])
    assert ref.mesh is not None
    want = ref.predict_proba({"x": x})
    got = StackedEnsemble(modules, devices=[CPU, CPU]).predict_proba(torch.from_numpy(x))
    assert got.shape == want.shape == (4, 6, 10)
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_PROB_ATOL)


@pytest.fixture(scope="module")
def blobs():
    """Four bf16 serving blobs of the JAX package's VGG template."""
    out = []
    for seed in range(4):
        m = JaxVgg(**SMALL)
        m._seed = seed
        m._build_loop(10, SHAPE)
        out.append(m.dump_parameters())
    return out


def _port_models(blobs):
    models = []
    for b in blobs:
        m = Vgg(device="cpu", **SMALL)
        m.load_parameters(b)
        models.append(m)
    return models


def test_bf16_build_stacked_over_devices_against_the_jax_package(blobs):
    """``build_stacked(devices=)`` serves the same top-4 as two groups:
    its predictions are those without devices, bit for bit, and within
    BF16_PROB_ATOL of the JAX package's adapter over two devices."""
    trials = [{"model_name": "vgg"}] * 4
    queries = _x(5, seed=3).tolist()
    jax_models = []
    for b in blobs:
        m = JaxVgg(**SMALL)
        m.load_parameters(b)
        jax_models.append(m)
    ref, reason = jax_build_stacked(trials, jax_models, devices=jax.devices()[:2], batch_size=8)
    assert reason == "stacked" and ref._ens.mesh is not None
    want = np.asarray(ref.predict(queries), np.float64)

    split, reason = build_stacked(trials, _port_models(blobs), devices=[CPU, CPU], batch_size=8)
    assert reason == "stacked" and len(split._ens.groups) == 2
    plain = try_build_stacked(trials, _port_models(blobs), batch_size=8)
    got = np.asarray(split.predict(queries), np.float64)
    np.testing.assert_array_equal(got, np.asarray(plain.predict(queries), np.float64))
    assert got.shape == (5, 10)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)
    np.testing.assert_allclose(got, want, rtol=0, atol=BF16_PROB_ATOL)
    assert split.warmup() > 0.0
    split.destroy()
