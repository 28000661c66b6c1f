"""Trial packing in the port against its serial path and against the
JAX package's pack, on the CPU.

k trials of one program train as one stacked program
(``rafiki_tpu_torch/ops/train.py PackedTrainLoop``,
``TorchModel.train_packed``) and each member must end where a serial
trial of it ends: the same histories, params and scores. Models: the
JAX package's PackFF shape (FeedForward 2 x 128 on 8x8x3 images, batch
64, 2 epochs) and VGG11 w0.25 for a few steps, with dropout, for the
conv and dropout paths. The pack's pieces (per-member Adam, the health
bundle, dropout under vmap, the pack half of the health monitor), its
elastic membership (evict, admit, a straggler and a backfill), packing
keys, and the worker and scheduler that drive it are checked one by
one. Each tolerance stands next to the readings that set it.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from rafiki_tpu.model.dataset import dataset_utils as jax_dataset_utils
from rafiki_tpu.models.ff import FeedForward as JaxFF, _Mlp as JaxMlp
from rafiki_tpu.models.vgg import Vgg as JaxVgg, _Vgg as JaxVggModule
from rafiki_tpu.obs.health import sentinel as jax_sentinel
from rafiki_tpu.obs.health.detector import HealthMonitor as JaxHealthMonitor
from rafiki_tpu.scheduler import LocalScheduler as JaxLocalScheduler
from rafiki_tpu.store import MetaStore as JaxMetaStore, ParamsStore as JaxParamsStore
from rafiki_tpu.utils.serial import load_pytree
from rafiki_tpu_torch import telemetry
from rafiki_tpu_torch.convert import flax_to_state_dict, state_dict_to_flax
from rafiki_tpu_torch.model.base import load_model_class
from rafiki_tpu_torch.model.dataset import Dataset, dataset_utils
from rafiki_tpu_torch.models.ff import FeedForward, _Mlp
from rafiki_tpu_torch.models.vgg import Vgg, _Vgg
from rafiki_tpu_torch.obs.health import sentinel
from rafiki_tpu_torch.obs.health.detector import HealthMonitor
from rafiki_tpu_torch.ops import train as port_train
from rafiki_tpu_torch.ops.optim import ScaleByAdamState, scale_by_adam
from rafiki_tpu_torch.parallel.ensemble import StackedEnsemble
from rafiki_tpu_torch.scheduler import LocalScheduler
from rafiki_tpu_torch.store import MetaStore, ParamsStore
from rafiki_tpu_torch.utils.serial import load_flat
from rafiki_tpu_torch.worker import train as worker_train
from rafiki_tpu_torch.worker.train import PackedTrialRunner, TrainWorker
from tests.test_torch_train import F32_TOL, flax_init_blob

# See test_torch_train.py: two intra-op threads per xdist worker.
torch.set_num_threads(2)

IMAGES_8 = "synthetic://images?classes=10&w=8&h=8&c=3&n={n}&seed={seed}"
TRAIN = IMAGES_8.format(n=256, seed=0)
VAL = IMAGES_8.format(n=100, seed=1)  # 100 vs batch 64: the padded remainder is scored too
VGG_TRAIN = IMAGES_8.format(n=128, seed=0)
FF_KNOBS = dict(hidden_layers=2, hidden_units=128, batch_size=64, epochs=2, seed=0)
VGG_KNOBS = dict(depth=11, width_mult=0.25, batch_size=64, epochs=2, seed=0)
# (learning rate, dropout, seed) of the four members.
MEMBERS = [(1e-2, 0.1, 0), (3e-3, 0.3, 5), (1e-3, 0.0, 7), (3e-2, 0.2, 11)]
CPU = [torch.device("cpu")]


def _counter(name: str) -> float:
    return telemetry.snapshot()["counters"].get(name, 0.0)


def _port_model(template, lr, dropout, seed, **over):
    if template == "ff":
        m = FeedForward(device="cpu", **dict(FF_KNOBS, learning_rate=lr, **over))
    else:
        m = Vgg(device="cpu", **dict(VGG_KNOBS, learning_rate=lr, dropout=dropout, **over))
    m._seed = seed  # the seed knob is fixed at 0; trials differ in their seed
    return m


def _params(model):
    return {k: v.detach().clone() for k, v in state_dict_to_flax(model._module).items()}


# -- the pack's pieces --------------------------------------------------------


def test_packed_adam_is_each_members_serial_adam_at_its_own_step():
    """Three members at steps 0, 2 and 5 (as after backfills): each
    member's packed update equals its serial update bit for bit, with the
    same float32 bias corrections."""
    rng = np.random.default_rng(0)
    shapes = [(3, 3, 4, 8), (8,), (16, 10)]
    opt = scale_by_adam()

    def grads():
        return [torch.from_numpy((rng.normal(size=s) * 10.0 ** rng.integers(-9, 1, size=s))
                                 .astype(np.float32)) for s in shapes]

    serial = [opt.init(None) for _ in range(3)]
    for i, lead in enumerate((0, 2, 5)):
        for _ in range(lead):
            _, serial[i] = opt.update(grads(), serial[i])
    packed = ScaleByAdamState(
        count=tuple(s.count for s in serial),
        mu=[torch.stack([s.mu[j] if s.mu else torch.zeros(shapes[j]) for s in serial])
            for j in range(len(shapes))],
        nu=[torch.stack([s.nu[j] if s.nu else torch.zeros(shapes[j]) for s in serial])
            for j in range(len(shapes))])
    for _ in range(3):
        g = [grads() for _ in range(3)]
        got, packed = opt.update([torch.stack([g[i][j] for i in range(3)])
                                  for j in range(len(shapes))], packed)
        for i in range(3):
            want, serial[i] = opt.update(g[i], serial[i])
            for j, w in enumerate(want):
                assert torch.equal(got[i][j], w)
    assert packed.count == (3, 5, 8)


def test_bundle_packed_is_each_members_serial_bundle():
    """The packed health bundle against the serial bundle of each member,
    one member with non-finite gradients and loss: each member's norms
    are reduced by the serial ops, so they are equal, as are the counts."""
    rng = np.random.default_rng(1)
    k, shapes = 3, [(4, 5), (7,), (2, 3, 3)]

    def leaves():
        return [torch.from_numpy(rng.normal(size=(k,) + s).astype(np.float32)) for s in shapes]

    grads, updates, params = leaves(), leaves(), leaves()
    grads[0][1, 2, 3] = float("nan")
    grads[2][1, 0, 0, 0] = float("inf")
    losses = torch.tensor([1.5, float("nan"), 0.25])
    got = sentinel.bundle_packed(losses, grads, [[u[i] for u in updates] for i in range(k)],
                                 params)
    for i in range(k):
        want = sentinel.bundle(losses[i], [g[i] for g in grads], [u[i] for u in updates],
                               [p[i] for p in params])
        assert int(got["health_nonfinite"][i]) == int(want["health_nonfinite"])
        for key in ("health_grad_norm", "health_update_norm", "health_param_norm"):
            assert float(got[key][i]) == float(want[key]) or (
                np.isnan(float(got[key][i])) and np.isnan(float(want[key])))
    assert got["health_nonfinite"].tolist() == [0, 3, 0]
    # The packed reduction of the epoch series, as the JAX package's.
    series = {key: torch.stack([got[key], got[key] * 2]) for key in got}
    want = jax_sentinel.reduce_epoch({key: jnp.asarray(v.numpy()) for key, v in series.items()})
    for key, v in sentinel.reduce_epoch(series).items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(want[key]))


def test_packed_dropout_draws_each_members_serial_mask():
    """Under vmap each member's mask comes from its own generator, in the
    serial order: member i's output equals serial dropout with a
    generator of the same seed, call after call."""
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(3, 16, 40)).astype(np.float32))
    rates = torch.tensor([0.1, 0.5, 0.0])
    seeds = (3, 4, 5)
    gens = port_train.PackedGenerators(torch.Generator().manual_seed(s) for s in seeds)
    serial = [torch.Generator().manual_seed(s) for s in seeds]
    fn = torch.func.vmap(lambda xi, ri: port_train.dropout(xi, ri, gens, deterministic=False))
    for _ in range(2):
        got = fn(x, rates)
        for i in range(3):
            want = port_train.dropout(x[i], rates[i], serial[i], deterministic=False)
            assert torch.equal(got[i], want)
    with pytest.raises(ValueError, match="batched"):
        port_train.dropout(x[0], 0.5, gens, deterministic=False)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_stacked_forward_bit_matches_serial_with_nonzero_biases(dtype):
    """The stacked serving forward (and a pack's forward) against the
    serial forwards, with trained-like non-zero dense biases. Before the
    per-member ``ops/layers.py linear``, vmap ran the dense layers as a
    bf16 matmul plus a separate bias add (two roundings) where the serial
    ``addmm`` rounds once: 3.5e-3 apart on probabilities in bf16 (ROADMAP
    Queue 3). Now equal."""
    modules = []
    for s in range(3):
        mod = _Vgg(11, 0.25, 10, (32, 32, 3), dtype=dtype)
        gen = torch.Generator().manual_seed(100 + s)
        with torch.no_grad():
            for p in mod.parameters():
                p.copy_(torch.randn(p.shape, generator=gen) * (0.1 if p.dim() == 1 else 0.2))
        modules.append(mod.eval())
    x = torch.from_numpy(np.random.default_rng(0).uniform(size=(5, 32, 32, 3)).astype(np.float32))
    with torch.inference_mode():
        serial = np.stack([port_train.predict(m, x).numpy() for m in modules])
    np.testing.assert_array_equal(StackedEnsemble(modules).predict_proba(x), serial)


# -- packed against serial, in the port ----------------------------------------


def _serial_trials(template, members, train, **over):
    out = []
    for lr, dropout, seed in members:
        m = _port_model(template, lr, dropout, seed, **over)
        logs = []
        with port_train_logger().capture(logs.append):
            m.train(train)
        out.append({"model": m, "history": [e["values"] for e in logs if e["type"] == "values"],
                    "score": m.evaluate(VAL), "params": _params(m)})
    return out


def port_train_logger():
    from rafiki_tpu_torch.model.log import logger

    return logger


@pytest.mark.parametrize("path", ["fast", "feed"])
@pytest.mark.parametrize("template", ["ff", "vgg"])
def test_pack4_matches_serial_trials(template, path, monkeypatch):
    """Four members (different seeds, lrs and, for VGG, dropout rates)
    trained as one pack against four serial trials, on the device-
    resident epoch and on the batch-feeding one. Readings: histories,
    final params and scores equal, bf16 compute, FF and VGG alike (each
    member's convs and dense layers run as the serial ones, and its
    dropout mask comes from its own generator). The bound is the
    reading: exact."""
    monkeypatch.setenv("RAFIKI_DEVICE_DATASET_MAX_MB", "2048" if path == "fast" else "0")
    train = TRAIN if template == "ff" else VGG_TRAIN
    serial = _serial_trials(template, MEMBERS, train)
    models = [_port_model(template, lr, d, s) for lr, d, s in MEMBERS]
    keys = {repr(m.packing_key(m._prepared_dataset(train))) for m in models}
    assert len(keys) == 1, "lr, dropout and seed must be dynamic: one packing key"
    histories = type(models[0]).train_packed(models, train)
    scores = type(models[0]).evaluate_packed(models, VAL)
    assert all(isinstance(m._loop, port_train.PackedSliceLoop) for m in models)
    for m, h, score, want in zip(models, histories, scores, serial):
        assert [{k: v for k, v in e.items()} for e in h] == want["history"]
        assert score == want["score"]
        got = _params(m)
        assert all(torch.equal(got[k], want["params"][k]) for k in got)
    # A packed member is an ordinary trial: its blob loads into a fresh
    # model, which scores what the pack scored.
    blob = models[1].dump_parameters()
    m2 = type(models[1])(device="cpu", **models[1].knobs)
    m2.load_parameters(blob)
    assert abs(m2.evaluate(VAL) - scores[1]) < 1e-6
    np.testing.assert_array_equal(models[1].predict_proba(np.zeros((3, 8, 8, 3), np.float32)),
                                  serial[1]["model"].predict_proba(np.zeros((3, 8, 8, 3),
                                                                            np.float32)))


def test_shape_knob_splits_the_bucket_and_train_packed_refuses_a_mix():
    a, b = _port_model("ff", 1e-2, 0.0, 0), _port_model("ff", 1e-3, 0.0, 0, hidden_units=64)
    ka = repr(a.packing_key(a._prepared_dataset(TRAIN)))
    kb = repr(b.packing_key(b._prepared_dataset(TRAIN)))
    assert ka != kb
    with pytest.raises(ValueError, match="packing key"):
        FeedForward.train_packed([a, b], TRAIN)
    a._start_epoch = 1  # restored from a checkpoint: it resumes serially
    with pytest.raises(ValueError, match="resume from checkpoint"):
        FeedForward.train_packed([a], TRAIN, checkpoint_sink=lambda *a: None)
    a._start_epoch = 0
    # A kill predicate is consulted at each epoch boundary the budget
    # does not end (the early kill; tests/test_torch_curve_kill.py).
    calls = []
    hist = FeedForward.train_packed(
        [a], TRAIN, kill_predicate=lambda mi, e, m: calls.append((mi, e)) or False)
    assert len(hist) == 1 and len(hist[0]) == a.epochs
    assert calls == [(0, e) for e in range(a.epochs - 1)]


# -- packing keys against the JAX package's -----------------------------------

KEY_GRID = {
    "ff": [dict(FF_KNOBS, learning_rate=1e-2), dict(FF_KNOBS, learning_rate=1e-3),
           dict(FF_KNOBS, learning_rate=1e-3, hidden_units=64),
           dict(FF_KNOBS, learning_rate=3e-3, hidden_layers=1),
           dict(FF_KNOBS, learning_rate=3e-3, batch_size=32),
           dict(FF_KNOBS, learning_rate=3e-3, epochs=3),
           dict(FF_KNOBS, learning_rate=5e-2, hidden_units=64)],
    "vgg": [dict(VGG_KNOBS, learning_rate=1e-3, dropout=0.0),
            dict(VGG_KNOBS, learning_rate=3e-3, dropout=0.4),
            dict(VGG_KNOBS, learning_rate=1e-3, dropout=0.1, batch_size=128),
            dict(VGG_KNOBS, learning_rate=1e-3, dropout=0.1, width_mult=0.5),
            dict(VGG_KNOBS, learning_rate=1e-3, dropout=0.1, depth=13),
            dict(VGG_KNOBS, learning_rate=2e-3, dropout=0.2, epochs=1)],
}


def _partition(keys):
    first = {}
    return [first.setdefault(k, i) for i, k in enumerate(keys)]


@pytest.mark.parametrize("template", ["ff", "vgg"])
def test_packing_keys_bucket_as_the_jax_packages(template):
    grid = KEY_GRID[template]
    jax_cls, port_cls = (JaxFF, FeedForward) if template == "ff" else (JaxVgg, Vgg)
    ds_jax = jax_dataset_utils.load(TRAIN)
    ds = dataset_utils.load(TRAIN)
    want = _partition([repr(jax_cls(**kn).packing_key(ds_jax)) for kn in grid])
    got = _partition([repr(port_cls(device="cpu", **kn).packing_key(ds)) for kn in grid])
    assert got == want
    assert len(set(got)) >= len(grid) - 2  # the grid has real splits


# -- the port's pack against the JAX package's ---------------------------------

FF_INIT = flax_init_blob(JaxMlp(hidden_layers=2, hidden_units=128, num_classes=10,
                                dtype=jnp.float32), (8, 8, 3))
VGG_INIT = flax_init_blob(JaxVggModule(depth=11, width_mult=0.25, num_classes=10, dropout=0.0,
                                       dtype=jnp.float32), (8, 8, 3))


def _jax_const_init(blob):
    tree = load_pytree(pickle.loads(blob)["packed"])
    return lambda rng: jax.tree.map(jnp.asarray, tree)


def _port_const_init(blob, module):
    sd = flax_to_state_dict(load_flat(pickle.loads(blob)["packed"]), module)

    def init_fn(_generator):
        module.load_state_dict(sd)
        return module

    return init_fn


class _StopMixin:
    """Stops after epoch 0 when the learning rate is STOP_LR."""

    STOP_LR = None

    def should_stop_early(self, epoch, metrics):
        return self.learning_rate == self.STOP_LR and epoch == 0


class JaxFFConst(_StopMixin, JaxFF):
    """float32 FF whose every member starts from FF_INIT."""

    def build_module(self, num_classes, input_shape):
        return JaxMlp(hidden_layers=2, hidden_units=128, num_classes=num_classes,
                      dtype=jnp.float32)

    def _loop_fns(self, num_classes, input_shape):
        return dict(super()._loop_fns(num_classes, input_shape), init_fn=_jax_const_init(FF_INIT))


class PortFFConst(_StopMixin, FeedForward):
    def build_module(self, num_classes, input_shape):
        return _Mlp(2, 128, num_classes, input_shape, dtype=torch.float32)

    def _loop_fns(self, num_classes, input_shape):
        fns = super()._loop_fns(num_classes, input_shape)
        return dict(fns, init_fn=_port_const_init(FF_INIT, fns["module"]))


class JaxVggConst(_StopMixin, JaxVgg):
    def build_module(self, num_classes, input_shape):
        return JaxVggModule(depth=11, width_mult=0.25, num_classes=num_classes,
                            dropout=0.0, dtype=jnp.float32)

    def _loop_fns(self, num_classes, input_shape):
        return dict(super()._loop_fns(num_classes, input_shape),
                    init_fn=_jax_const_init(VGG_INIT))


class PortVggConst(_StopMixin, Vgg):
    def build_module(self, num_classes, input_shape):
        return _Vgg(11, 0.25, num_classes, input_shape, dtype=torch.float32)

    def _loop_fns(self, num_classes, input_shape):
        fns = super()._loop_fns(num_classes, input_shape)
        return dict(fns, init_fn=_port_const_init(VGG_INIT, fns["module"]))


def _jax_params(model):
    tree = model._loop.params
    return {k: np.asarray(v) for k, v in flatten_dict(jax.device_get(tree), sep="/").items()}


def _pack_readings(ref, got, start):
    """The largest gaps over the members: per-epoch loss (relative) and
    accuracy, eval score, and final params (max abs and relative to the
    distance they moved)."""
    r = {"loss_rel": 0.0, "acc": 0.0, "score": 0.0, "param_max_abs": 0.0, "param_rel_l2": 0.0}
    for a, b in zip(ref, got):
        assert len(a["history"]) == len(b["history"])
        for ea, eb in zip(a["history"], b["history"]):
            assert ea["epoch"] == eb["epoch"]
            r["loss_rel"] = max(r["loss_rel"], abs(ea["loss"] - eb["loss"]) / abs(ea["loss"]))
            r["acc"] = max(r["acc"], abs(ea["acc"] - eb["acc"]))
        r["score"] = max(r["score"], abs(a["score"] - b["score"]))
        pa, pb = a["params"], b["params"]
        r["param_max_abs"] = max(r["param_max_abs"],
                                 max(float(np.abs(pa[k] - pb[k]).max()) for k in pa))
        num = np.sqrt(sum(float(((pa[k] - pb[k]) ** 2).sum()) for k in pa))
        den = np.sqrt(sum(float(((pa[k] - start[k]) ** 2).sum()) for k in pa))
        r["param_rel_l2"] = max(r["param_rel_l2"], float(num / den))
    return r


def _run_pack(side, template, members, train, epochs, stop_lr=None, backfill=None):
    """One ``train_packed`` + ``evaluate_packed`` in one package. Returns
    per-member rows, the ``on_evict`` calls and the start params."""
    if side == "jax":
        cls = JaxFFConst if template == "ff" else JaxVggConst
    else:
        cls = PortFFConst if template == "ff" else PortVggConst
    knobs = dict(FF_KNOBS if template == "ff" else dict(VGG_KNOBS, dropout=0.0), epochs=epochs)

    def make(lr, seed):
        m = cls(**dict(knobs, learning_rate=lr)) if side == "jax" else \
            cls(device="cpu", **dict(knobs, learning_rate=lr))
        m._seed = seed
        return m

    cls.STOP_LR = stop_lr
    models = [make(lr, s) for lr, _, s in members]
    evicted = []
    queue = [make(lr, s) for lr, s in (backfill or [])]
    histories = cls.train_packed(
        models, train, on_evict=lambda *a: evicted.append(a),
        backfill=(lambda n: [queue.pop(0) for _ in range(min(n, len(queue)))]) if backfill
        else None)
    scores = cls.evaluate_packed(models, VAL)
    params = [_jax_params(m) if side == "jax" else {k: v.numpy() for k, v in _params(m).items()}
              for m in models]
    rows = [{"history": h, "score": s, "params": p} for h, s, p in zip(histories, scores, params)]
    return rows, evicted


# The members of the cross-package packs stay at the learning rates the
# serial float32 parity test holds (test_torch_train, lr 1e-3): the two
# packages' float32 rounding grows with the rate and the step count
# alike in a pack and in a serial trial. Readings of one-member packs
# (each the port's serial trial, bit for bit) against the JAX package:
# VGG, 4 steps, loss 4.4e-5 rel and params 9.9e-3 max abs at lr 3e-2,
# 2.5e-7 and 2.5e-4 at lr 1e-2; FF, 12 steps, loss 2.9e-6 and 3.4e-6 at
# lr 1e-2 and 3e-2, at most 2.3e-7 from lr 3e-3 down.
XPKG_MEMBERS = [(1e-3, 0.0, 0), (3e-3, 0.0, 5), (2e-3, 0.0, 7), (5e-4, 0.0, 11)]


@pytest.mark.parametrize("template", ["ff", "vgg"])
def test_port_pack_matches_jax_pack_in_float32(template):
    """The same four members through both packages' ``train_packed`` and
    ``evaluate_packed``: float32, dropout 0, every member from the same
    flax-drawn params (their seeds still differ, so each member shuffles
    its own way). Held to test_torch_train's F32_TOL; readings (max over
    the members): FF loss 1.6e-7 rel, params 4.7e-6 max abs and 4.8e-6 of
    the distance moved; VGG 2.3e-7, 5.3e-5 and 4.8e-5; accuracies and
    scores equal."""
    train = TRAIN if template == "ff" else VGG_TRAIN
    blob = FF_INIT if template == "ff" else VGG_INIT
    members = XPKG_MEMBERS
    start = {k: v.float().numpy() for k, v in load_flat(pickle.loads(blob)["packed"]).items()}
    ref, _ = _run_pack("jax", template, members, train, epochs=2)
    got, _ = _run_pack("port", template, members, train, epochs=2)
    r = _pack_readings(ref, got, start)
    print(template, r)
    for key in r:
        assert r[key] <= F32_TOL[key], (key, r)


def test_straggler_and_backfill_match_the_jax_pack():
    """A 3-epoch pack in both packages: the member at lr 3e-3 stops early
    after epoch 0 (evicted into a serial loop), a backfilled member takes
    its slot at its own epoch 0, the first members leave ``finished``
    while it trains on, and it ends the pack alone. The evictions and
    every member's history, score and params agree, within F32_TOL
    (readings: loss 2.3e-7 rel, params 4.7e-6 max abs and 3.5e-6 of the
    distance moved, accuracies and scores equal)."""
    members = [XPKG_MEMBERS[i] for i in (0, 1, 3)]
    start = {k: v.float().numpy() for k, v in load_flat(pickle.loads(FF_INIT)["packed"]).items()}
    args = ("ff", members, TRAIN, 3)
    kw = dict(stop_lr=3e-3, backfill=[(2e-3, 21)])
    ref, ref_ev = _run_pack("jax", *args, **kw)
    got, got_ev = _run_pack("port", *args, **kw)
    assert got_ev == ref_ev == [(1, 0, "early_stop"), (2, 2, "finished"), (0, 2, "finished")]
    assert [len(r["history"]) for r in got] == [len(r["history"]) for r in ref] == [3, 1, 3, 3]
    r = _pack_readings(ref, got, start)
    print(r)
    for key in r:
        assert r[key] <= F32_TOL[key], (key, r)


# -- elastic membership, in the port --------------------------------------------


def _loop_parts(template, members, train_uri):
    ms = [_port_model(template, lr, d, s) for lr, d, s in members]
    ds = dataset_utils.load(train_uri)
    for m in ms:
        m.packing_key(ds)  # plans the steps the warmup is derived from
    return ms, [m._loop_fns(ds.classes, tuple(ds.x.shape[1:])) for m in ms], ds


def _serial_loop(fns, seed):
    return port_train.TrainLoop(fns["init_fn"], fns["apply_eval"], fns["loss_fn"],
                                fns["optimizer"], seed=seed, hyper=fns["hyper"], device="cpu")


def _loop_params(module):
    return {n: p.detach().clone() for n, p in module.named_parameters()}


@pytest.mark.parametrize("template", ["ff", "vgg"])
def test_evicted_member_carries_on_as_its_serial_trial(template):
    """A member evicted after epoch 0 and adopted by
    ``TrainLoop(initial_state=...)`` trains epoch 1 exactly as a serial
    run of its trial does; its pack-mates go on exactly as theirs."""
    train = TRAIN if template == "ff" else VGG_TRAIN
    ms, fns, ds = _loop_parts(template, MEMBERS[:3], train)
    seeds = [s for _, _, s in MEMBERS[:3]]
    packed = port_train.PackedTrainLoop(
        fns[0]["init_fn"], fns[0]["apply_eval"], fns[0]["loss_fn"], fns[0]["optimizer"],
        seeds=seeds, hypers=[f["hyper"] for f in fns], device="cpu")
    packed.run_epoch(ds, 64, seeds)
    detached = port_train.TrainLoop(None, fns[1]["apply_eval"], fns[1]["loss_fn"],
                                    fns[1]["optimizer"], initial_state=packed.evict(1),
                                    device="cpu")
    assert packed.k == 2 and packed.health.k == 2
    got_rest = packed.run_epoch(ds, 64, [seeds[0] + 1, seeds[2] + 1])
    got = detached.run_epoch(ds, 64, seeds[1] + 1)
    for i, f in enumerate(fns):
        loop = _serial_loop(f, seeds[i])
        loop.run_epoch(ds, 64, seeds[i])
        want = loop.run_epoch(ds, 64, seeds[i] + 1)
        if i == 1:
            assert got == want
            params = _loop_params(detached.params)
        else:
            assert got_rest[0 if i == 0 else 1] == want
            params = packed.trial_params(0 if i == 0 else 1)
        ref = _loop_params(loop.params)
        assert all(torch.equal(params[n], ref[n]) for n in ref)


def test_admitted_member_is_a_fresh_serial_trial():
    """A member admitted after the pack's first epoch trains its epoch 0
    and 1 exactly as a fresh serial trial does (its own init draw,
    generator and Adam count from 0), next to members at epoch 1 and 2."""
    ms, fns, ds = _loop_parts("vgg", MEMBERS[:3], VGG_TRAIN)
    seeds = [s for _, _, s in MEMBERS[:3]]
    packed = port_train.PackedTrainLoop(
        fns[0]["init_fn"], fns[0]["apply_eval"], fns[0]["loss_fn"], fns[0]["optimizer"],
        seeds=seeds[:2], hypers=[f["hyper"] for f in fns[:2]], device="cpu")
    packed.run_epoch(ds, 64, seeds[:2])
    assert packed.admit(seeds[2], fns[2]["hyper"]) == 2
    assert packed.state.opt.count[2] == 0 and packed.state.steps[2] == 0
    rows = [packed.run_epoch(ds, 64, [seeds[0] + 1, seeds[1] + 1, seeds[2] + e])
            for e in range(2)]
    fresh = _serial_loop(fns[2], seeds[2])
    assert [r[2] for r in rows] == [fresh.run_epoch(ds, 64, seeds[2] + e) for e in range(2)]
    ref = _loop_params(fresh.params)
    assert all(torch.equal(packed.trial_params(2)[n], ref[n]) for n in ref)
    with pytest.raises(ValueError, match="hyper keys"):
        packed.admit(3, {"lr": 1e-3})


# -- health, pack half --------------------------------------------------------


def test_observe_pack_verdicts_evictions_and_admissions_match_jax(monkeypatch):
    """The same scripted per-member health rows through both monitors:
    member 1 explodes (held for the hysteresis), member 2 goes non-finite,
    a member is evicted and another admitted between epochs. Verdict
    kinds, members and diagnoses agree."""
    monkeypatch.setenv("RAFIKI_HEALTH_CAPSULE", "0")
    ref, port = JaxHealthMonitor("k", k=3), HealthMonitor("k", k=3)
    rng = np.random.default_rng(5)
    script = []
    for epoch in range(9):
        rows = [{"health_grad_norm": float(rng.uniform(0.8, 1.2)), "health_nonfinite": 0,
                 "health_bad_step": -1, "health_update_norm": 0.1} for _ in range(3)]
        if epoch in (5, 6):
            rows[1]["health_grad_norm"] = 90.0
        if epoch == 4:
            rows[2].update(health_grad_norm=float("nan"), health_nonfinite=4, health_bad_step=2)
        script.append(rows)
    out = []
    for epoch, rows in enumerate(script):
        a = ref.observe_pack([dict(r) for r in rows], epoch_seeds=[epoch] * 3)
        b = port.observe_pack([dict(r) for r in rows], epoch_seeds=[epoch] * 3)
        assert len(a) == len(b) == 3
        for va, vb in zip(a, b):
            assert (va is None) == (vb is None)
            if va is not None:
                assert (va["divergence"], va["member"], va["diagnosis"], va["bad_step"]) == \
                    (vb["divergence"], vb["member"], vb["diagnosis"], vb["bad_step"])
                out.append((epoch, vb["member"], vb["divergence"]))
        if epoch == 6:
            for mon in (ref, port):
                mon.evict_member(1)
                mon.admit_member()
    assert out == [(4, 2, "nonfinite"), (6, 1, "explosion")]
    assert port.k == ref.k == 3


# -- the worker and the scheduler -----------------------------------------------

PACK_SRC = b"""
from rafiki_tpu_torch.model.base import TorchModel
from rafiki_tpu_torch.model.knobs import FixedKnob, FloatKnob
from rafiki_tpu_torch.models.ff import _Mlp


class PackFF(TorchModel):
    @staticmethod
    def get_knob_config():
        return {
            "learning_rate": FloatKnob(1e-3, 1e30, is_exp=True),
            "batch_size": FixedKnob(64),
            "epochs": FixedKnob(2),
            "seed": FixedKnob(0),
        }

    def build_module(self, num_classes, input_shape):
        return _Mlp(2, 128, num_classes, input_shape)
"""
LRS = [1e-2, 3e-3, 1e-3, 3e-2]


class _ScriptedAdvisor:
    """Proposes LRS in turn (or ``lrs``); records the feedback."""

    def __init__(self, lrs=LRS):
        self._i = 0
        self._lrs = list(lrs)
        self.fed = []

    def propose(self):
        lr = self._lrs[self._i % len(self._lrs)]
        self._i += 1
        return dict(batch_size=64, epochs=2, seed=0, learning_rate=float(lr))

    def propose_batch(self, n):
        return [self.propose() for _ in range(n)]

    def feedback(self, score, knobs):
        self.fed.append((round(float(score), 6), dict(knobs)))


def _mk_worker(tmp_path, trial_pack, n_trials=8, lrs=LRS, train=TRAIN, devices=CPU):
    store = MetaStore(tmp_path / "meta.sqlite3")
    params = ParamsStore(tmp_path / "params")
    cls = load_model_class(PACK_SRC, "PackFF")
    model = store.create_model("packff", "IMAGE_CLASSIFICATION", None, PACK_SRC, "PackFF")
    job = store.create_train_job("app", "IMAGE_CLASSIFICATION", None, train, VAL,
                                 {"MODEL_TRIAL_COUNT": n_trials})
    sub = store.create_sub_train_job(job["id"], model["id"])
    adv = _ScriptedAdvisor(lrs)
    worker = TrainWorker(store, params, sub["id"], cls, adv, train, VAL,
                         {"MODEL_TRIAL_COUNT": n_trials}, devices=devices,
                         async_persist=False, trial_pack=trial_pack)
    return store, params, worker, adv, sub


def test_worker_trial_pack4_keeps_the_per_trial_contract(tmp_path):
    store, params, worker, adv, sub = _mk_worker(tmp_path, trial_pack=4)
    rounds0, packed0 = _counter("worker.packed_rounds"), _counter("worker.packed_trials")
    assert worker.run() == 8
    trials = store.get_trials_of_sub_train_job(sub["id"])
    assert len(trials) == 8
    assert all(t["status"] == "COMPLETED" and t["score"] is not None and t["params_id"]
               for t in trials)
    for t in trials:
        entries = store.get_trial_logs(t["id"])
        assert any(e.get("type") == "plot" for e in entries)
        assert [e["values"]["epoch"] for e in entries if e.get("type") == "values"] == [0, 1]
    # One feedback per trial, with the row's score, in creation order.
    assert [(round(t["score"], 6), t["knobs"]["learning_rate"]) for t in trials] == \
        [(s, kn["learning_rate"]) for s, kn in adv.fed]
    # A packed trial's blob is an ordinary trial's: it loads and scores.
    cls = load_model_class(PACK_SRC, "PackFF")
    for t in trials[:2]:
        m = cls(device="cpu", **t["knobs"])
        m.load_parameters(params.load(t["params_id"]))
        assert abs(m.evaluate(VAL) - t["score"]) <= 0.02  # the blob's bf16 rounding
    assert _counter("worker.packed_rounds") == rounds0 + 2
    assert _counter("worker.packed_trials") == packed0 + 8
    # The pack equals the serial path trial by trial (one trial's score).
    serial = cls(device="cpu", **trials[2]["knobs"])
    serial.train(TRAIN)
    assert serial.evaluate(VAL) == trials[2]["score"]


def test_worker_pack1_is_the_default_and_serial(tmp_path):
    store, _, worker, adv, sub = _mk_worker(tmp_path, trial_pack=None, n_trials=3)
    assert worker.trial_pack == 1
    rounds0, packed0 = _counter("worker.packed_rounds"), _counter("worker.packed_trials")
    assert worker.run() == 3
    trials = store.get_trials_of_sub_train_job(sub["id"])
    assert all(t["status"] == "COMPLETED" for t in trials)
    assert (_counter("worker.packed_rounds"), _counter("worker.packed_trials")) == \
        (rounds0, packed0)
    assert len(adv.fed) == 3


def test_worker_pack_env_default(tmp_path, monkeypatch):
    monkeypatch.setenv("RAFIKI_TRIAL_PACK", "4")
    assert _mk_worker(tmp_path, trial_pack=None, n_trials=1)[2].trial_pack == 4
    monkeypatch.delenv("RAFIKI_TRIAL_PACK")
    assert _mk_worker(tmp_path, trial_pack=None, n_trials=1)[2].trial_pack == 1


@pytest.mark.parametrize("case", ["eligible", "preprocess", "masked", "processes", "devices"])
def test_packer_eligibility(case, tmp_path, monkeypatch):
    if case == "devices":
        # Several devices train each trial on an in-process dp mesh, which
        # a pack does not take: the packer is ineligible and the worker
        # trains its trials one by one, each at width 2.
        store, _, worker, _, sub = _mk_worker(tmp_path, trial_pack=4, n_trials=2,
                                              devices=CPU * 2)
        assert not PackedTrialRunner(worker, 4).eligible()
        widths, run_epoch = [], port_train.TrainLoop.run_epoch

        def spy(self, *args, **kwargs):
            widths.append(self.plan.mesh.world_size)
            return run_epoch(self, *args, **kwargs)

        monkeypatch.setattr(port_train.TrainLoop, "run_epoch", spy)
        rounds0 = _counter("worker.packed_rounds")
        assert worker.run() == 2
        assert all(t["status"] == "COMPLETED" for t in store.get_trials_of_sub_train_job(sub["id"]))
        assert widths == [2] * 4 and _counter("worker.packed_rounds") == rounds0
        return
    _, _, worker, _, _ = _mk_worker(tmp_path, trial_pack=4, n_trials=1)
    if case == "preprocess":
        class Pre(worker.model_class):
            def preprocess(self, x):
                return x * 1.0

        worker.model_class = Pre
    elif case == "masked":
        ds = dataset_utils.load(TRAIN)
        masked = Dataset(ds.x, ds.y, ds.classes, np.ones(ds.x.shape[:2], bool), ds.meta)
        monkeypatch.setattr(worker_train.dataset_utils, "load", lambda uri: masked)
    elif case == "processes":
        monkeypatch.setenv("RAFIKI_NUM_PROCESSES", "2")
    assert PackedTrialRunner(worker, 4).eligible() == (case == "eligible")
    assert not PackedTrialRunner(worker, 1).eligible()


def test_nonfinite_member_is_evicted_alone_and_only_its_trial_errors(tmp_path, monkeypatch):
    """One member at lr 1e30 overflows to non-finite values in its first
    epoch: the pack evicts it alone ("diverged"), the worker marks its
    trial ERRORED with the diagnosis and feeds the floor score, and the
    three pack-mates complete as their serial trials would."""
    monkeypatch.setenv("RAFIKI_HEALTH_CAPSULE", "0")
    store, _, worker, adv, sub = _mk_worker(tmp_path, trial_pack=4, n_trials=4,
                                            lrs=[1e-2, 1e30, 3e-3, 1e-3])
    contained0 = _counter("health.contained")
    assert worker.run() == 4
    trials = store.get_trials_of_sub_train_job(sub["id"])
    status = {t["knobs"]["learning_rate"]: t for t in trials}
    bad = status[1e30]
    assert bad["status"] == "ERRORED" and bad["error"].startswith("diverged: non-finite")
    assert bad["params_id"] is None
    assert all(t["status"] == "COMPLETED" for lr, t in status.items() if lr != 1e30)
    assert (0.0, bad["knobs"]) in adv.fed
    assert _counter("health.contained") == contained0 + 1
    assert sum(e["type"] == "values" for e in store.get_trial_logs(bad["id"])) == 1


def test_failing_pack_errors_every_member_and_reruns_nothing(tmp_path, monkeypatch):
    """A packed step that raises fails the whole pack: every member is
    ERRORED with the traceback and the advisor hears the floor score for
    each; no member is retried one by one."""
    def boom(self, *args, **kwargs):
        raise RuntimeError("injected pack failure")

    monkeypatch.setattr(port_train.PackedTrainLoop, "run_epoch", boom)
    store, _, worker, adv, sub = _mk_worker(tmp_path, trial_pack=4, n_trials=4)
    ok0 = _counter("worker.trials_succeeded")
    assert worker.run() == 4
    trials = store.get_trials_of_sub_train_job(sub["id"])
    assert len(trials) == 4
    assert all(t["status"] == "ERRORED" and "injected pack failure" in t["error"]
               for t in trials)
    assert [s for s, _ in adv.fed] == [0.0] * 4
    assert _counter("worker.trials_succeeded") == ok0


SCHED_TEMPLATE = """
{imports}

INIT = {init!r}


class PackFF({base}):
    @staticmethod
    def get_knob_config():
        return {{
            "learning_rate": FloatKnob(1e-3, 3e-2, is_exp=True),
            "batch_size": FixedKnob(32),
            "epochs": FixedKnob(2),
            "seed": FixedKnob(0),
        }}

    def build_module(self, num_classes, input_shape):
        return {module}

    def _loop_fns(self, num_classes, input_shape):
        # Every trial starts from INIT, in both packages.
        fns = super()._loop_fns(num_classes, input_shape)
        {init_fn}
        return fns
"""
SCHED_JAX = dict(
    imports="""import pickle
import jax
import jax.numpy as jnp
from rafiki_tpu.model.base import JaxModel
from rafiki_tpu.model.knobs import FixedKnob, FloatKnob
from rafiki_tpu.models.ff import _Mlp
from rafiki_tpu.utils.serial import load_pytree""",
    base="JaxModel",
    module="_Mlp(hidden_layers=1, hidden_units=32, num_classes=num_classes, dtype=jnp.float32)",
    init_fn="""tree = load_pytree(pickle.loads(INIT)["packed"])
        fns["init_fn"] = lambda rng: jax.tree.map(jnp.asarray, tree)""")
SCHED_PORT = dict(
    imports="""import pickle
import torch
from rafiki_tpu_torch.convert import flax_to_state_dict
from rafiki_tpu_torch.model.base import TorchModel
from rafiki_tpu_torch.model.knobs import FixedKnob, FloatKnob
from rafiki_tpu_torch.models.ff import _Mlp
from rafiki_tpu_torch.utils.serial import load_flat""",
    base="TorchModel",
    module="_Mlp(1, 32, num_classes, input_shape, dtype=torch.float32)",
    init_fn="""sd = flax_to_state_dict(load_flat(pickle.loads(INIT)["packed"]), fns["module"])

        def init_fn(_generator, module=fns["module"]):
            module.load_state_dict(sd)
            return module

        fns["init_fn"] = init_fn""")
SCHED_TRAIN = "synthetic://images?classes=5&n=256&w=8&h=8&seed=0"
SCHED_VAL = "synthetic://images?classes=5&n=128&w=8&h=8&seed=1"


def test_scheduler_trial_pack4_job_matches_the_jax_schedulers(tmp_path):
    """The same 6-trial job (random advisor, seed 0: the same proposals in
    both packages; one packing key) through both schedulers with
    ``trial_pack=4``: a pack of 4, then a pack of 2. Trial count,
    statuses and scores agree (readings: scores equal), and the port
    counted two packed rounds."""
    init = flax_init_blob(JaxMlp(hidden_layers=1, hidden_units=32, num_classes=5,
                                 dtype=jnp.float32), (8, 8, 1), num_classes=5)
    runs = {}
    rounds0 = _counter("worker.packed_rounds")
    for side, store, params, sched, fmt, devices in (
            ("jax", JaxMetaStore(tmp_path / "j.sqlite3"), JaxParamsStore(tmp_path / "jp"),
             JaxLocalScheduler, SCHED_JAX, jax.devices("cpu")[:1]),
            ("port", MetaStore(tmp_path / "p.sqlite3"), ParamsStore(tmp_path / "pp"),
             LocalScheduler, SCHED_PORT, CPU)):
        src = SCHED_TEMPLATE.format(init=init, **fmt).encode()
        model = store.create_model("packff", "IMAGE_CLASSIFICATION", None, src, "PackFF")
        job = store.create_train_job("app", "IMAGE_CLASSIFICATION", None, SCHED_TRAIN,
                                     SCHED_VAL, {"MODEL_TRIAL_COUNT": 6})
        store.create_sub_train_job(job["id"], model["id"])
        runs[side] = sched(store, params).run_train_job(
            job["id"], n_workers=1, devices=devices, advisor_kind="random", trial_pack=4)
    got, want = runs["port"], runs["jax"]
    assert got.status == want.status == "COMPLETED"
    assert len(got.trials) == len(want.trials) == 6
    assert [t["status"] for t in got.trials] == [t["status"] for t in want.trials]
    assert [t["knobs"] for t in got.trials] == [t["knobs"] for t in want.trials]
    scores = [(t["score"], u["score"]) for t, u in zip(got.trials, want.trials)]
    print(scores)
    assert max(abs(a - b) for a, b in scores) <= F32_TOL["score"], scores
    assert max(s for s, _ in scores) > 0.5  # the job learned: chance is 0.2
    assert _counter("worker.packed_rounds") == rounds0 + 2
