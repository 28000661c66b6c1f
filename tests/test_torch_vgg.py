"""The port's GroupNorm and VGG against the JAX package's, on the CPU.

Same inputs (numpy, seeded) and the same params go through both. In
float32 the two must agree to rounding; in the bf16 serving path they
agree within the bf16 tolerance stated below."""

import json
import math
import os
import subprocess
import sys

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from rafiki_tpu.models.vgg import Vgg as JaxVgg, _Vgg as JaxVggModule
from rafiki_tpu_torch.convert import flax_to_state_dict, state_dict_to_flax
from rafiki_tpu_torch.models.vgg import Vgg as TorchVgg, _Vgg as TorchVggModule
from rafiki_tpu_torch.ops.layers import GroupNorm

# See test_torch_train.py: two intra-op threads per xdist worker.
torch.set_num_threads(2)

SMALL = dict(depth=11, width_mult=0.25, dropout=0.0, learning_rate=1e-3,
             batch_size=64, epochs=1, seed=0)

# bf16 serving tolerance on probabilities. Yardstick: the JAX package's
# own bf16-vs-f32 gap at init is about 2e-3 on probs (VGG11/w0.25 and
# VGG16/w1.0, 32x32, CPU); the two frameworks round bf16 at different
# places (conv accumulation, bias add), which is a gap of that kind.
BF16_PROB_ATOL = 5e-3


def _nhwc_to_nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("ch", [8, 24, 64])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_groupnorm_matches_flax(ch, dtype):
    rng = np.random.default_rng(ch)
    x = (rng.normal(size=(4, 5, 6, ch)) * 3 + 1).astype(np.float32)
    scale = rng.normal(size=(ch,)).astype(np.float32)
    bias = rng.normal(size=(ch,)).astype(np.float32)
    groups = math.gcd(8, ch)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16

    ref_mod = nn.GroupNorm(num_groups=groups, dtype=jdt)
    ref = ref_mod.apply({"params": {"scale": scale, "bias": bias}},
                        jnp.asarray(x).astype(jdt))
    ref = np.asarray(ref.astype(jnp.float32))

    gn = GroupNorm(groups, ch, dtype=tdt)
    with torch.no_grad():
        gn.weight.copy_(torch.from_numpy(scale))
        gn.bias.copy_(torch.from_numpy(bias))
        got = gn(_nhwc_to_nchw(x).to(tdt))
    assert got.dtype == tdt
    got = got.float().permute(0, 2, 3, 1).numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    else:
        # One bf16 rounding step (2**-8 relative) where the f32 values
        # straddle a rounding boundary; nearly every element is exact.
        np.testing.assert_allclose(got, ref, rtol=2 ** -7, atol=2 ** -7)
        assert np.mean(got == ref) > 0.99


@pytest.mark.parametrize("hw", [(32, 32), (8, 16)])
def test_vgg_f32_structural_parity(hw):
    """Same params, float32 compute in both: logits and probs agree to
    f32 rounding. 8x16 ends at a 1x2 map, which pins the NHWC order of
    the flatten before the first Dense."""
    h, w = hw
    ref_mod = JaxVggModule(depth=11, width_mult=0.25, num_classes=10,
                           dropout=0.0, dtype=jnp.float32)
    rng = np.random.default_rng(h * w)
    x = rng.uniform(0, 1, size=(6, h, w, 3)).astype(np.float32)
    params = jax.jit(ref_mod.init)(jax.random.PRNGKey(3), jnp.zeros((1, h, w, 3)))["params"]
    ref_logits = np.asarray(jax.jit(ref_mod.apply)({"params": params}, jnp.asarray(x)))
    ref_probs = np.asarray(jax.nn.softmax(ref_logits, axis=-1))

    port = TorchVggModule(11, 0.25, 10, (h, w, 3), dtype=torch.float32)
    flat = {k: np.asarray(v) for k, v in flatten_dict(params, sep="/").items()}
    port.load_state_dict(flax_to_state_dict(flat, port))
    # The carrier is exact both ways.
    back = state_dict_to_flax(port)
    assert sorted(back) == sorted(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k].numpy(), flat[k])

    with torch.no_grad():
        logits = port(torch.from_numpy(x))
    probs = torch.softmax(logits.float(), -1).numpy()
    np.testing.assert_allclose(logits.numpy(), ref_logits, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(probs, ref_probs, rtol=0, atol=1e-5)


def test_vgg_bf16_contract_api_parity():
    """The same bf16 serving blob through each package's contract API
    (load_parameters + predict) gives the same probabilities within
    the bf16 tolerance. Argmax is no criterion: at init the logits are
    near-ties."""
    src = JaxVgg(**SMALL)
    src._build_loop(10, (32, 32, 3))
    blob = src.dump_parameters()
    queries = np.random.default_rng(11).uniform(0, 1, size=(5, 32, 32, 3)).astype(np.float32)

    ref = JaxVgg(**SMALL)
    ref.load_parameters(blob)
    want = np.asarray(ref.predict(queries.tolist()))

    port = TorchVgg(device="cpu", **SMALL)
    port.load_parameters(blob)
    got = np.asarray(port.predict(queries.tolist()))
    assert got.shape == want.shape == (5, 10)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)
    np.testing.assert_allclose(got, want, rtol=0, atol=BF16_PROB_ATOL)
    np.testing.assert_allclose(port.predict_proba(queries), got, rtol=0, atol=0)


_JAX_BF16_AND_F32 = """
import os, sys
import numpy as np
from rafiki_tpu.utils.backend import force_cpu_backend
force_cpu_backend(n_devices=1)
import jax, jax.numpy as jnp
from flax.traverse_util import unflatten_dict
from rafiki_tpu.models.vgg import _Vgg
d = dict(np.load(sys.argv[1]))
x = d.pop("__x__")
params = unflatten_dict({tuple(k.split("/")): jnp.asarray(v) for k, v in d.items()})
out = {}
for name, dt in (("bf16", jnp.bfloat16), ("f32", jnp.float32)):
    mod = _Vgg(depth=11, width_mult=0.25, num_classes=10, dropout=0.0, dtype=dt)
    logits = jax.jit(mod.apply)({"params": params}, x)
    out[name] = np.asarray(jax.nn.softmax(logits.astype(jnp.float32), -1))
np.savez(sys.argv[2], **out)
"""


def test_bf16_rounding_matches_flax_dtypes(tmp_path):
    """The port rounds to bf16 where flax's ``dtype=bfloat16`` says
    each layer does. XLA on the CPU by default keeps float32 inside a
    fusion and skips some of those roundings, so the JAX package's
    bf16 path sits closer to float32 than the port's. With that excess
    precision turned off (``--xla_allow_excess_precision=false``, in a
    fresh process), the two bf16 paths sit equally far from float32
    and closer to each other than to it. Prints the readings (-s)."""
    ref_mod = JaxVggModule(depth=11, width_mult=0.25, num_classes=10,
                           dropout=0.0, dtype=jnp.float32)
    params = jax.jit(ref_mod.init)(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))["params"]
    # Serving blobs hold bf16 params: both packages see the same values.
    flat = {k: np.asarray(jnp.asarray(v).astype(jnp.bfloat16).astype(jnp.float32))
            for k, v in flatten_dict(params, sep="/").items()}
    x = np.random.default_rng(100).uniform(0, 1, size=(64, 32, 32, 3)).astype(np.float32)

    def jax_probs_default():
        # This process runs XLA with its default flags.
        p = unflatten_dict({tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()})
        out = []
        for dt in (jnp.bfloat16, jnp.float32):
            mod = JaxVggModule(depth=11, width_mult=0.25, num_classes=10, dropout=0.0, dtype=dt)
            out.append(np.asarray(jax.nn.softmax(
                jax.jit(mod.apply)({"params": p}, x).astype(jnp.float32), -1)))
        return out

    def jax_probs_no_excess_precision():
        src, dst = tmp_path / "in.npz", tmp_path / "out.npz"
        np.savez(src, __x__=x, **flat)
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_allow_excess_precision=false")
        out = subprocess.run([sys.executable, "-c", _JAX_BF16_AND_F32, str(src), str(dst)],
                             env=env, cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                             capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, out.stderr[-2000:]
        got = np.load(dst)
        return got["bf16"], got["f32"]

    port = {}
    for name, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        mod = TorchVggModule(11, 0.25, 10, (32, 32, 3), dtype=dt)
        mod.load_state_dict(flax_to_state_dict(flat, mod))
        with torch.no_grad():
            port[name] = torch.softmax(mod(torch.from_numpy(x)).float(), -1).numpy()
    xla_default = jax_probs_default()
    xla_rounding = jax_probs_no_excess_precision()

    def gap(a, b):
        d = np.abs(a - b)
        return {"max": float(d.max()), "mean": float(d.mean())}

    readings = {
        "port_bf16_vs_f32": gap(port["bf16"], port["f32"]),
        "jax_default_bf16_vs_f32": gap(*xla_default),
        "jax_no_excess_bf16_vs_f32": gap(*xla_rounding),
        "port_vs_jax_no_excess_bf16": gap(port["bf16"], xla_rounding[0]),
        "port_vs_jax_f32": gap(port["f32"], xla_rounding[1]),
    }
    print(json.dumps(readings))
    assert readings["port_vs_jax_f32"]["max"] <= 1e-5
    port_gap = readings["port_bf16_vs_f32"]["mean"]
    jax_gap = readings["jax_no_excess_bf16_vs_f32"]["mean"]
    assert 0.85 * jax_gap <= port_gap <= 1.15 * jax_gap
    assert readings["port_vs_jax_no_excess_bf16"]["mean"] <= 0.5 * jax_gap
    assert readings["jax_default_bf16_vs_f32"]["mean"] < 0.9 * port_gap


def test_eval_step_counts_masked_argmax_hits():
    """``eval_step`` against the JAX package's eval step on the same f32
    params and batch: argmax hits over labels >= 0 and valid examples.
    The labels are drawn at random, not from either side's argmax."""
    from rafiki_tpu.ops.train import _ShardingPlan, make_eval_step
    from rafiki_tpu_torch.ops.train import eval_step

    ref_mod = JaxVggModule(depth=11, width_mult=0.25, num_classes=10,
                           dropout=0.0, dtype=jnp.float32)
    rng = np.random.default_rng(5)
    x = rng.uniform(0, 1, size=(64, 8, 8, 3)).astype(np.float32)
    y = rng.integers(-1, 10, size=(64,)).astype(np.int32)  # -1: unlabeled
    valid = rng.uniform(size=(64,)) < 0.8                   # False: padding
    params = jax.jit(ref_mod.init)(jax.random.PRNGKey(4), jnp.zeros((1, 8, 8, 3)))["params"]
    ref_step = make_eval_step(lambda p, b: ref_mod.apply({"params": p}, b["x"]),
                              _ShardingPlan.build(None))
    want = tuple(int(v) for v in ref_step(params, {"x": x, "y": y, "valid": valid}))

    port = TorchVggModule(11, 0.25, 10, (8, 8, 3), dtype=torch.float32).eval()
    flat = {k: np.asarray(v) for k, v in flatten_dict(params, sep="/").items()}
    port.load_state_dict(flax_to_state_dict(flat, port))
    with torch.no_grad():
        got = eval_step(port, torch.from_numpy(x), torch.from_numpy(y),
                        torch.from_numpy(valid))
    assert tuple(int(v) for v in got) == want
    assert want[1] == int(((y >= 0) & valid).sum())
    assert want[0] > 0
