"""The port's training slice against the JAX package's, on the CPU.

Every input is made from a numpy seed, and the same inputs go through
the JAX function and its port counterpart: the loss, the learning-rate
warmup, Adam's core, the health sentinels and detector, dropout, the
dataset loader, and the training loop itself (VGG11 width 0.25 on
8x8x3 images here; FeedForward in ``test_torch_ff.py``), in float32 and
in the bf16 compute the models use, on the device-resident path and on
the batch-feeding path. Each tolerance stands next to the readings that
set it.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.traverse_util import flatten_dict

from rafiki_tpu.model import dataset as jax_dataset
from rafiki_tpu.model.log import logger as jax_logger
from rafiki_tpu.models.vgg import Vgg as JaxVgg, _Vgg as JaxVggModule
from rafiki_tpu.obs.health import DivergenceError as JaxDivergenceError
from rafiki_tpu.obs.health import sentinel as jax_sentinel
from rafiki_tpu.obs.health.detector import HealthMonitor as JaxHealthMonitor
from rafiki_tpu.ops import train as jax_train
from rafiki_tpu_torch.convert import state_dict_to_flax
from rafiki_tpu_torch.model import dataset as port_dataset
from rafiki_tpu_torch.model.log import logger as port_logger
from rafiki_tpu_torch.models.vgg import Vgg, _Vgg
from rafiki_tpu_torch.obs.health import DivergenceError, HealthMonitor
from rafiki_tpu_torch.obs.health import sentinel
from rafiki_tpu_torch.ops import train as port_train
from rafiki_tpu_torch.ops.optim import scale_by_adam
from rafiki_tpu_torch.utils.serial import dump_flat

# The xdist workers of the tier-1 run share the machine's cores. torch's
# default intra-op pool takes one thread per core in every worker, and
# its idle threads spin between the many small ops of these CPU loops,
# which starves the other workers' JAX jobs. Two threads per worker keep
# these tests fast without that contention.
torch.set_num_threads(2)

VGG_KNOBS = dict(depth=11, width_mult=0.25, dropout=0.0, learning_rate=1e-3,
                 batch_size=64, epochs=1, seed=0)
IMAGES_8 = "synthetic://images?classes=10&w=8&h=8&c=3&n={n}&seed={seed}"


# -- primitives ---------------------------------------------------------------


@pytest.mark.parametrize("case", ["labels", "labels+valid", "all_masked"])
def test_cross_entropy_loss_matches_jax(case):
    rng = np.random.default_rng(0)
    logits = (rng.normal(size=(32, 10)) * 3).astype(np.float32)
    labels = rng.integers(-1, 10, size=32).astype(np.int32)
    valid = None
    if case == "labels+valid":
        valid = rng.uniform(size=32) < 0.7
    elif case == "all_masked":
        labels[:] = -1
    want = jax_train.cross_entropy_loss(
        jnp.asarray(logits), jnp.asarray(labels), None if valid is None else jnp.asarray(valid))
    got = port_train.cross_entropy_loss(
        torch.from_numpy(logits), torch.from_numpy(labels),
        None if valid is None else torch.from_numpy(valid))
    # float32 log-softmax and a mean over <= 32 terms: a few ulps apart
    # (readings: equal, and 1.1e-7 relative with the valid mask).
    np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=1e-6, atol=0)
    assert float(got[1]) == float(want[1])
    if case == "all_masked":
        assert float(got[0]) == 0.0 and float(got[1]) == 0.0


@pytest.mark.parametrize("lr,warmup,step", [(1e-3, 10.0, 0), (1e-3, 10.0, 4), (1e-3, 10.0, 9),
                                            (1e-3, 10.0, 500), (3e-2, 0.5, 0), (2e-4, 39.0, 17)])
def test_effective_lr_matches_jax_exactly(lr, warmup, step):
    want = jax_train.effective_lr({"lr": jnp.float32(lr), "warmup": jnp.float32(warmup)},
                                  jnp.int32(step))
    got = port_train.effective_lr({"lr": torch.tensor(lr, dtype=torch.float32),
                                   "warmup": torch.tensor(warmup, dtype=torch.float32)}, step)
    assert got.dtype == torch.float32
    assert np.float32(got) == np.float32(want)


def _leaves(rng, scale):
    """Three leaves with values over many magnitudes, some near eps."""
    shapes = [(3, 3, 4, 8), (8,), (16, 10)]
    out = []
    for s in shapes:
        v = rng.normal(size=s) * scale * 10.0 ** rng.integers(-9, 1, size=s)
        out.append(v.astype(np.float32))
    out[1][0] = 0.0
    return out


def _ulps(a: np.ndarray, b: np.ndarray) -> int:
    """Largest distance in float32 units in the last place."""
    return int(np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64)).max())


def test_adam_core_matches_optax_scale_by_adam():
    """Five updates of the port's Adam core against optax's on the same
    gradients (values over ten orders of magnitude, zeros among them):
    the moments bit for bit, the updates bit-near. Readings: moments
    equal, updates at most 2 ulps apart (numpy's float32 power for the
    bias corrections here, XLA's there)."""
    rng = np.random.default_rng(1)
    grads = [_leaves(rng, 1.0) for _ in range(5)]
    ref = optax.scale_by_adam()
    ref_state = ref.init([jnp.zeros_like(jnp.asarray(g)) for g in grads[0]])
    opt = scale_by_adam()
    state = opt.init([torch.zeros(g.shape) for g in grads[0]])
    for step, g in enumerate(grads):
        want, ref_state = ref.update([jnp.asarray(x) for x in g], ref_state)
        got, state = opt.update([torch.from_numpy(x) for x in g], state)
        assert state.count == int(ref_state.count) == step + 1
        for a, b in zip(got, want):
            assert _ulps(a.numpy(), np.asarray(b)) <= 4
        for a, b in zip(state.mu + state.nu, list(ref_state.mu) + list(ref_state.nu)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _health_series(n, k):
    rng = np.random.default_rng(n * 10 + k)
    shape = (n,) if k == 0 else (n, k)
    nf = np.zeros(shape, np.int32)
    gn = rng.uniform(0.5, 2.0, size=shape).astype(np.float32)
    if k == 0:
        nf[3], nf[5] = 7, 2
        gn[3] = np.nan
    else:
        nf[3, 1], nf[5, 1], nf[2, 2] = 7, 2, 1
        gn[3, 1] = np.nan
    return {"health_nonfinite": nf, "health_grad_norm": gn,
            "health_update_norm": rng.uniform(size=shape).astype(np.float32),
            "health_param_norm": rng.uniform(size=shape).astype(np.float32)}


def test_sentinel_bundle_matches_jax_including_a_nonfinite_step():
    rng = np.random.default_rng(2)
    grads, updates, params = (_leaves(rng, 1.0) for _ in range(3))
    for case in ("finite", "nan_grad", "inf_loss"):
        g = [x.copy() for x in grads]
        loss = np.float32(1.5)
        if case == "nan_grad":
            g[0][0, 0, 0, :3] = np.nan
            g[2][4, 4] = -np.inf
        elif case == "inf_loss":
            loss = np.float32(np.inf)
        want = jax_sentinel.bundle(jnp.asarray(loss), [jnp.asarray(x) for x in g],
                                   [jnp.asarray(x) for x in updates], [jnp.asarray(x) for x in params])
        got = sentinel.bundle(torch.tensor(loss), [torch.from_numpy(x) for x in g],
                              [torch.from_numpy(x) for x in updates],
                              [torch.from_numpy(x) for x in params])
        assert sorted(got) == sorted(want)
        assert int(got["health_nonfinite"]) == int(want["health_nonfinite"])
        assert int(got["health_nonfinite"]) == {"finite": 0, "nan_grad": 4, "inf_loss": 1}[case]
        for key in ("health_grad_norm", "health_update_norm", "health_param_norm"):
            # Per-leaf norms summed in another order: float32 rounding
            # at most (reading: equal on these leaves).
            np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=2e-6)


@pytest.mark.parametrize("k", [0, 3])
def test_sentinel_reduce_epoch_matches_jax(k):
    """Serial ``(n,)`` and packed ``(n, k)`` series with non-finite steps:
    the reduction selects and sums the same values, so it is exact."""
    series = _health_series(8, k)
    want = jax_sentinel.reduce_epoch({key: jnp.asarray(v) for key, v in series.items()})
    got = sentinel.reduce_epoch({key: torch.from_numpy(v) for key, v in series.items()})
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
    rest, health = sentinel.split({"loss": torch.zeros(()), **got})
    assert list(rest) == ["loss"] and sorted(health) == sorted(got)


def test_health_monitor_matches_jax_verdicts(monkeypatch):
    """The same epoch sequence through both monitors: quiet epochs, a
    grad-norm explosion held for the hysteresis, then (fresh monitors)
    a non-finite epoch."""
    monkeypatch.setenv("RAFIKI_HEALTH_CAPSULE", "0")

    def run(make):
        ref, port = make("jax"), make("port")
        out = []
        for epoch, (gn, nf) in enumerate(seq):
            h = {"health_grad_norm": gn, "health_nonfinite": nf, "health_bad_step": -1,
                 "health_update_norm": 0.1}
            a = ref.observe(dict(h), epoch_seed=epoch)
            b = port.observe(dict(h), epoch_seed=epoch)
            out.append((a and a["divergence"], b and b["divergence"]))
            if a is not None:
                assert (a["diagnosis"], a["bad_step"], a["nonfinite"]) == \
                    (b["diagnosis"], b["bad_step"], b["nonfinite"])
        return out

    def make(kind):
        return JaxHealthMonitor("k") if kind == "jax" else HealthMonitor("k")

    seq = [(1.0, 0), (1.2, 0), (0.9, 0), (1.1, 0), (80.0, 0), (1.0, 0), (90.0, 0), (95.0, 0), (1.0, 0)]
    verdicts = run(make)
    assert [a for a, _ in verdicts] == [b for _, b in verdicts]
    assert [a for a, _ in verdicts].count("explosion") == 1
    seq = [(1.0, 0), (float("nan"), 3)]
    assert run(make)[-1] == ("nonfinite", "nonfinite")


def test_dropout_statistics_and_edges():
    x = torch.ones(400, 1000)
    gen = torch.Generator().manual_seed(0)
    assert port_train.dropout(x, 0.5, gen, deterministic=True) is x
    assert port_train.dropout(x, 0.5, None, deterministic=False) is x
    np.testing.assert_array_equal(port_train.dropout(x, 0.0, gen, False).numpy(), x.numpy())
    assert not port_train.dropout(x, torch.tensor(1.0), gen, False).any()
    y = port_train.dropout(x, torch.tensor(0.3), gen, False)
    kept = y != 0
    # 4e5 Bernoulli(0.7) draws: the kept share is 0.7 within 5 sigma
    # (sigma 7.2e-4), and every kept element is scaled by 1 / 0.7.
    assert abs(float(kept.float().mean()) - 0.7) < 3.6e-3
    np.testing.assert_allclose(y[kept].numpy(), np.float32(1.0) / np.float32(0.7), rtol=1e-7)
    # The JAX package's dropout on the same input: the same edges, and
    # kept values scaled identically (the streams themselves differ).
    ref = np.asarray(jax_train.dropout(jnp.ones((400, 1000)), jnp.float32(0.3),
                                       jax.random.PRNGKey(0), deterministic=False))
    assert abs(float((ref != 0).mean()) - 0.7) < 3.6e-3
    np.testing.assert_array_equal(np.unique(ref[ref != 0]), np.unique(y[kept].numpy()))
    assert not np.asarray(jax_train.dropout(jnp.ones(10), jnp.float32(1.0),
                                            jax.random.PRNGKey(0), False)).any()
    # bf16 activations keep their dtype.
    assert port_train.dropout(x.bfloat16(), 0.3, gen, False).dtype == torch.bfloat16


# -- datasets -----------------------------------------------------------------


@pytest.mark.parametrize("uri", [
    "synthetic://images?classes=10&n=64&seed=0",
    "synthetic://images?classes=10&n=500&w=32&h=32&c=3&seed=1&noise=0.35&flip=0.2",
    "synthetic://images?classes=4&n=33&w=8&h=12&c=3&seed=2&dist=5",
    "npz:float32", "npz:uint8",
])
def test_dataset_loader_gives_the_jax_loaders_bytes(uri, tmp_path):
    if uri.startswith("npz:"):
        src = jax_dataset.synthetic_images(classes=5, n=40, w=6, h=6, c=3, seed=3)
        if uri == "npz:uint8":
            src.x = (src.x * 255).astype(np.uint8)
        uri = str(tmp_path / "d.npz")
        np.savez(uri, x=src.x, y=src.y)
    ref = jax_dataset.DatasetUtils().load(uri)
    got = port_dataset.DatasetUtils().load(uri)
    assert got.x.dtype == ref.x.dtype and got.x.tobytes() == ref.x.tobytes()
    assert got.y.dtype == ref.y.dtype and got.y.tobytes() == ref.y.tobytes()
    assert (got.classes, got.meta, got.mask) == (ref.classes, ref.meta, ref.mask)
    for kw in (dict(batch_size=16, shuffle=True, seed=4),
               dict(batch_size=16, drop_remainder=False, start=16)):
        for a, b in zip(got.batches(**kw), ref.batches(**kw), strict=True):
            assert sorted(a) == sorted(b)
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])


def test_dataset_cache_and_refusals(tmp_path):
    utils = port_dataset.DatasetUtils()
    uri = IMAGES_8.format(n=8, seed=0)
    assert utils.load(uri) is utils.load(uri)
    with pytest.raises(ValueError, match="corpus"):
        utils.load("synthetic://corpus?n=4")
    with pytest.raises(ValueError, match="zip"):
        utils.load(str(tmp_path / "d.zip"))
    corpus = str(tmp_path / "c.npz")
    np.savez(corpus, x=np.ones((4, 6), np.int32), y=np.zeros((4, 6), np.int32))
    with pytest.raises(ValueError, match="corpus"):
        utils.load(corpus)


# -- the training loop --------------------------------------------------------


def _f32(jax_cls, port_cls, jax_module, port_module):
    """Subclasses of a template pair that compute in float32."""

    class JaxF32(jax_cls):
        def build_module(self, num_classes, input_shape):
            return jax_module(self, num_classes, input_shape, jnp.float32)

    class PortF32(port_cls):
        def build_module(self, num_classes, input_shape):
            return port_module(self, num_classes, input_shape, torch.float32)

    return JaxF32, PortF32


JaxVggF32, VggF32 = _f32(
    JaxVgg, Vgg,
    lambda m, nc, shape, dt: JaxVggModule(depth=m.knobs["depth"], width_mult=m.knobs["width_mult"],
                                          num_classes=nc, dropout=m.knobs["dropout"], dtype=dt),
    lambda m, nc, shape, dt: _Vgg(m.knobs["depth"], m.knobs["width_mult"], nc, shape,
                                  dtype=dt, dropout=m.knobs["dropout"]))



def flax_init_blob(jax_module, input_shape, num_classes=10, seed=0) -> bytes:
    """A float32 params blob drawn by the flax module's own init: both
    packages load it, so both trials start from the same params."""
    params = jax.jit(jax_module.init)(jax.random.PRNGKey(seed),
                                      jnp.zeros((1,) + tuple(input_shape)))["params"]
    flat = {k: torch.from_numpy(np.array(v)) for k, v in flatten_dict(params, sep="/").items()}
    return pickle.dumps({"arch": (num_classes, tuple(input_shape)),
                         "packed": dump_flat(flat, cast_f32_to_bf16=False), "dataset_meta": {}})


def _capture(model):
    """The health dict of every epoch, read before the loop strips it."""
    seen = []
    check = model._loop._health_check

    def spy(out, *args, **kwargs):
        seen.append({k: v for k, v in out.items() if k.startswith("health_")})
        return check(out, *args, **kwargs)

    model._loop._health_check = spy
    return seen


def train_one(side, cls, knobs, blob, train_uri, eval_uri):
    """One trial from ``blob``'s params through the model contract
    (load_parameters -> train -> evaluate) in one package. Returns the
    logged epoch metrics, the health dicts, the eval score, the final
    params as numpy and the model."""
    m = cls(**knobs) if side == "jax" else cls(device="cpu", **knobs)
    n_train = int(train_uri.split("n=")[1].split("&")[0])
    # The warmup is derived from the planned steps when the loop is
    # built: plan the same count on both sides before loading.
    m._planned_steps = knobs["epochs"] * (n_train // knobs["batch_size"])
    m.load_parameters(blob)
    health = _capture(m)
    logs = []
    with (jax_logger if side == "jax" else port_logger).capture(logs.append):
        m.train(train_uri)
    score = m.evaluate(eval_uri)
    if side == "jax":
        params = {k: np.asarray(v) for k, v in flatten_dict(m._loop.params, sep="/").items()}
    else:
        params = {k: v.numpy() for k, v in state_dict_to_flax(m._module).items()}
    return {"values": [e["values"] for e in logs if e["type"] == "values"],
            "health": health, "score": score, "params": params, "model": m}


def set_path(monkeypatch, path):
    """``fast``: the device-resident epoch; ``feed``: batch by batch from
    the host (both packages read the same cap)."""
    monkeypatch.setenv("RAFIKI_DEVICE_DATASET_MAX_MB", "2048" if path == "fast" else "0")


def param_gap(a, b, start):
    """Max abs difference of the final params, and that difference over
    the distance the params moved from ``start`` (relative L2)."""
    diff = max(float(np.abs(a[k] - b[k]).max()) for k in a)
    num = np.sqrt(sum(float(((a[k] - b[k]) ** 2).sum()) for k in a))
    den = np.sqrt(sum(float(((a[k] - start[k]) ** 2).sum()) for k in a))
    return diff, float(num / den)


def blob_params(blob):
    from rafiki_tpu_torch.utils.serial import load_flat

    return {k: v.float().numpy() for k, v in load_flat(pickle.loads(blob)["packed"]).items()}


def readings(ref, got, start):
    last_ref, last_got = ref["values"][-1], got["values"][-1]
    h_ref, h_got = ref["health"][-1], got["health"][-1]
    gap, rel = param_gap(ref["params"], got["params"], start)
    return {
        "loss_rel": abs(last_got["loss"] - last_ref["loss"]) / abs(last_ref["loss"]),
        "acc": abs(last_got["acc"] - last_ref["acc"]),
        **{f"{k}_rel": abs(h_got[k] - h_ref[k]) / abs(h_ref[k])
           for k in ("health_grad_norm", "health_update_norm", "health_param_norm")},
        "nonfinite": (h_ref["health_nonfinite"], h_got["health_nonfinite"]),
        "bad_step": (h_ref["health_bad_step"], h_got["health_bad_step"]),
        "param_max_abs": gap, "param_rel_l2": rel,
        "score": abs(got["score"] - ref["score"]),
    }


def check_readings(r, tol):
    print(r)
    assert r["nonfinite"] == (0, 0) and r["bad_step"] == (-1, -1), r
    for key, bound in tol.items():
        assert r[key] <= bound, (key, r)


def vgg_blob():
    return flax_init_blob(JaxVggModule(depth=11, width_mult=0.25, num_classes=10,
                                       dropout=0.0, dtype=jnp.float32), (8, 8, 3))


# float32, VGG11 w0.25, 8x8x3, batch 64, lr 1e-3 (warmup: 1 step). The
# two packages' convs sum in other orders (XLA vs oneDNN), and Adam's
# first steps divide each gradient by its own magnitude, so an element
# whose gradient is float32 rounding noise moves by a fraction of lr.
# Readings (max over fast/feed x 1/5 steps): loss 1.1e-7 rel, grad norm
# 1.6e-7, update norm 1.6e-5, param norm 2.0e-7, params 1.2e-4 max abs
# and 3.6e-4 of the distance they moved, last-batch acc and eval score
# equal. Bounds: about 3x the readings; acc and score allow one flip.
F32_TOL = {"loss_rel": 1e-6, "acc": 1 / 64, "health_grad_norm_rel": 1e-6,
           "health_update_norm_rel": 5e-5, "health_param_norm_rel": 1e-6,
           "param_max_abs": 3e-4, "param_rel_l2": 1e-3, "score": 0.01}


@pytest.mark.parametrize("steps", [1, 5])
@pytest.mark.parametrize("path", ["fast", "feed"])
def test_vgg_training_matches_jax_in_float32(steps, path, monkeypatch):
    set_path(monkeypatch, path)
    blob = vgg_blob()
    args = (VGG_KNOBS, blob, IMAGES_8.format(n=64 * steps, seed=0), IMAGES_8.format(n=100, seed=1))
    ref = train_one("jax", JaxVggF32, *args)
    got = train_one("port", VggF32, *args)
    check_readings(readings(ref, got, blob_params(blob)), F32_TOL)


_JAX_SIDE = """
import importlib, os, pickle, sys
from rafiki_tpu.utils.backend import force_cpu_backend
force_cpu_backend(n_devices=1)
import tests.test_torch_train as T
jobs = pickle.load(open(sys.argv[1], "rb"))
out = []
for env_path, cls_name, args in jobs:
    os.environ["RAFIKI_DEVICE_DATASET_MAX_MB"] = env_path
    mod, name = cls_name.split(":")
    r = T.train_one("jax", getattr(importlib.import_module(mod), name), *args)
    r["blob"] = r.pop("model").dump_parameters()
    out.append(r)
pickle.dump(out, open(sys.argv[2], "wb"))
"""


def jax_side_without_excess_precision(jobs, tmp_path):
    """Run JAX trials in a fresh process with XLA's CPU excess precision
    off (``--xla_allow_excess_precision=false``), so XLA rounds to bf16
    where flax's ``dtype=bfloat16`` says each layer does, as the port
    does. ``jobs``: ``(path, "module:class", train_one args)``."""
    import os
    import subprocess
    import sys

    src, dst = tmp_path / "jobs.pkl", tmp_path / "out.pkl"
    src.write_bytes(pickle.dumps([("2048" if p == "fast" else "0", c, a) for p, c, a in jobs]))
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_allow_excess_precision=false")
    out = subprocess.run([sys.executable, "-c", _JAX_SIDE, str(src), str(dst)], env=env,
                         cwd=repo, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return pickle.loads(dst.read_bytes())


# bf16 compute (the models as they ship), the same runs as above. With
# XLA's default excess precision on the CPU, JAX skips bf16 roundings
# the port makes and the gap is 3-18x wider (grad norm 1.0e-2 against
# 5.7e-4 after one step), so the JAX side runs with it off. Readings
# then (fast and feed alike): after 1 step loss 9.8e-6 rel, grad norm
# 5.7e-4, update norm 3.2e-5, param norm 1.6e-6, params 0.107 of the
# distance moved, eval score 0.02 apart; after 5 steps loss 6.7e-3,
# grad norm 5.5e-3, update norm 1.7e-5, param norm 8.3e-6, params 0.156,
# eval score 0.04 apart. The largest param difference is 2 lr per step
# (an element whose bf16 gradient rounds to the other sign), so it is
# no criterion here. Bounds: about 3x the readings.
BF16_TOL = {
    1: {"loss_rel": 3e-5, "acc": 1 / 64, "health_grad_norm_rel": 2e-3,
        "health_update_norm_rel": 1e-4, "health_param_norm_rel": 5e-6,
        "param_rel_l2": 0.3, "score": 0.06},
    5: {"loss_rel": 2e-2, "acc": 2 / 64, "health_grad_norm_rel": 1.5e-2,
        "health_update_norm_rel": 5e-5, "health_param_norm_rel": 3e-5,
        "param_rel_l2": 0.45, "score": 0.12},
}
BF16_CASES = [(path, steps) for path in ("fast", "feed") for steps in (1, 5)]
SLICE_KNOBS = dict(VGG_KNOBS, epochs=2)
SLICE_ARGS = (IMAGES_8.format(n=320, seed=0), IMAGES_8.format(n=100, seed=1))


@pytest.fixture(scope="module")
def vgg_bf16_jax_runs(tmp_path_factory):
    """The JAX side of every bf16 VGG comparison, in one fresh process."""
    blob = vgg_blob()
    jobs = [(path, "tests.test_torch_train:JaxVgg", (VGG_KNOBS, blob, IMAGES_8.format(n=64 * steps, seed=0),
                              IMAGES_8.format(n=100, seed=1)))
            for path, steps in BF16_CASES]
    jobs.append(("fast", "tests.test_torch_train:JaxVgg", (SLICE_KNOBS, blob) + SLICE_ARGS))
    jobs.append(("fast", "tests.test_torch_train:JaxVggF32", (SLICE_KNOBS, blob) + SLICE_ARGS))
    runs = jax_side_without_excess_precision(jobs, tmp_path_factory.mktemp("bf16"))
    return blob, dict(zip(BF16_CASES + ["slice", "slice_f32"], runs))


@pytest.mark.parametrize("path,steps", BF16_CASES)
def test_vgg_training_matches_jax_in_bf16(path, steps, vgg_bf16_jax_runs, monkeypatch):
    blob, ref = vgg_bf16_jax_runs
    set_path(monkeypatch, path)
    got = train_one("port", Vgg, VGG_KNOBS, blob, IMAGES_8.format(n=64 * steps, seed=0),
                    IMAGES_8.format(n=100, seed=1))
    check_readings(readings(ref[(path, steps)], got, blob_params(blob)), BF16_TOL[steps])


# -- the slice through the model contract ---------------------------------------

# Served probabilities of the same bf16 params in the two packages (the
# serving slice's bound, test_torch_vgg.BF16_PROB_ATOL).
SERVE_PROB_ATOL = 5e-3
# A trained model against its own bf16-stored blob: the GroupNorm scales
# and biases, which the forward uses in float32, lose their low bits.
# Reading 6.4e-3 (VGG11 w0.25 after 10 steps).
BLOB_PROB_ATOL = 1e-2


def test_vgg_slice_train_evaluate_dump_and_serve_in_jax(vgg_bf16_jax_runs):
    """``train -> evaluate -> dump_parameters`` in both packages from the
    same params (bf16 compute, dropout 0, same planned steps, 2 epochs
    of 5 steps; the JAX side without excess precision, as above), then
    the port's blob served by the JAX package's ``Vgg`` and by the
    port's."""
    blob, runs = vgg_bf16_jax_runs
    ref, ref_f32 = runs["slice"], runs["slice_f32"]
    got = train_one("port", Vgg, SLICE_KNOBS, blob, *SLICE_ARGS)
    assert [v["epoch"] for v in got["values"]] == [0, 1]
    port_blob = got["model"].dump_parameters()
    served = JaxVgg(**SLICE_KNOBS)
    served.load_parameters(port_blob)
    reloaded, jax_trained, jax_f32 = (Vgg(device="cpu", **SLICE_KNOBS) for _ in range(3))
    reloaded.load_parameters(port_blob)
    jax_trained.load_parameters(ref["blob"])
    jax_f32.load_parameters(ref_f32["blob"])
    queries = np.random.default_rng(9).uniform(0, 1, size=(20, 8, 8, 3)).astype(np.float32)
    p_served = np.asarray(served.predict(queries.tolist()))
    p_port = np.asarray(reloaded.predict(queries.tolist()))
    r = {
        "served_jax_vs_port": float(np.abs(p_served - p_port).max()),
        "blob_vs_trained": float(np.abs(p_port - got["model"].predict_proba(queries)).max()),
        "port_vs_jax_trained": float(np.abs(p_port - jax_trained.predict_proba(queries)).max()),
        "port_vs_jax_trained_mean": float(np.abs(p_port - jax_trained.predict_proba(queries)).mean()),
        "jax_bf16_vs_f32": float(np.abs(jax_f32.predict_proba(queries) - jax_trained.predict_proba(queries)).max()),
        "jax_bf16_vs_f32_mean": float(np.abs(jax_f32.predict_proba(queries) - jax_trained.predict_proba(queries)).mean()),
        "score": abs(got["score"] - ref["score"]),
        "served_score": abs(served.evaluate(SLICE_ARGS[1]) - reloaded.evaluate(SLICE_ARGS[1])),
    }
    print(r)
    assert p_served.shape == (20, 10)
    # The same bf16 params served by the two packages (XLA's default
    # flags in this process).
    assert r["served_jax_vs_port"] <= SERVE_PROB_ATOL
    # The served model is the trained one, up to the bf16 storage of its
    # GroupNorm scales and biases in the blob (the forward rounds every
    # other leaf to bf16 anyway).
    assert r["blob_vs_trained"] <= BLOB_PROB_ATOL
    # The two trainings: the port's bf16 run sits no further from the
    # JAX package's bf16 run than that run sits from the JAX package's
    # own float32 run on the same steps. Readings: 8.2e-2 max / 2.2e-2
    # mean against 1.7e-1 / 3.9e-2; eval scores equal, served scores one
    # example of 100 apart.
    for stat in ("", "_mean"):
        assert r["port_vs_jax_trained" + stat] <= r["jax_bf16_vs_f32" + stat]
    assert r["score"] <= 0.03 and r["served_score"] <= 0.03


def test_init_parameters_draws_what_train_starts_from():
    """The loop's own init and ``init_parameters`` give the same weights
    for the same seed; a loaded model continues training from its
    params, and a dataset of another architecture is refused."""
    a, b = Vgg(device="cpu", **VGG_KNOBS), Vgg(device="cpu", **VGG_KNOBS)
    a.init_parameters(10, (8, 8, 3))
    b._build_loop(10, (8, 8, 3))
    for (ka, va), (kb, vb) in zip(a._module.state_dict().items(), b._module.state_dict().items()):
        assert ka == kb
        torch.testing.assert_close(va, vb, rtol=0, atol=0)
    start = {k: v.clone() for k, v in a._module.state_dict().items()}
    a.train(IMAGES_8.format(n=64, seed=0))
    assert a._loop.state[2] == 1  # one step taken, on the installed params
    assert any(not torch.equal(start[k], v) for k, v in a._module.state_dict().items())
    with pytest.raises(ValueError, match="does not match"):
        a.train("synthetic://images?classes=10&w=4&h=4&c=3&n=64&seed=0")
    with pytest.raises(RuntimeError, match="no parameters"):
        Vgg(device="cpu", **VGG_KNOBS).evaluate(IMAGES_8.format(n=64, seed=1))


def test_nonfinite_training_raises_divergence_error_in_both_packages(tmp_path, monkeypatch):
    """A NaN pixel in the training set makes the step's loss and grads
    non-finite: both packages stop the trial with a DivergenceError
    whose verdict says so."""
    monkeypatch.setenv("RAFIKI_HEALTH_CAPSULE", "0")
    ds = port_dataset.synthetic_images(classes=10, n=64, w=8, h=8, c=3, seed=0)
    ds.x[5, 2, 2, 1] = np.nan
    path = str(tmp_path / "nan.npz")
    np.savez(path, x=ds.x, y=ds.y)
    with pytest.raises(JaxDivergenceError) as want:
        JaxVgg(**VGG_KNOBS).train(path)
    with pytest.raises(DivergenceError) as got:
        Vgg(device="cpu", **VGG_KNOBS).train(path)
    assert got.value.verdict["divergence"] == want.value.verdict["divergence"] == "nonfinite"
    assert got.value.verdict["bad_step"] == want.value.verdict["bad_step"] == 0
