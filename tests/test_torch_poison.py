"""The chaos ``train.nan`` poison column in the port's train step, on the
CPU.

The JAX package multiplies every step's gradients by an all-ones column
(a NaN at the poisoned step); the port multiplies only in an epoch
whose column holds a value other than 1 (``rafiki_tpu_torch/ops/
train.py``). Here, with FeedForward and a narrow VGG in float32: a
step multiplied by an all-ones column is the plain step bit for bit,
serial and in a k=2 pack; with ``train.nan`` armed, the port's epoch
reduction names the same bad step and non-finite counts at it as the
JAX package's on the same params, data and spec; and in a pack, the
members the poison missed end bit-equal to their serial runs.
"""

import numpy as np
import pytest
import torch

from rafiki_tpu import chaos as jax_chaos
from rafiki_tpu.obs.health import DivergenceError as JaxDivergenceError
from rafiki_tpu.ops import train as jax_train
from rafiki_tpu_torch import chaos
from rafiki_tpu_torch.model.base import TorchModel
from rafiki_tpu_torch.model.dataset import dataset_utils
from rafiki_tpu_torch.obs.health import DivergenceError
from rafiki_tpu_torch.ops import train as port_train
from tests.test_torch_pack import (FF_KNOBS, TRAIN, VGG_KNOBS, VGG_TRAIN, JaxFFConst,
                                   JaxVggConst, PortFFConst, PortVggConst)

torch.set_num_threads(2)

CPU = torch.device("cpu")
TEMPLATES = {"ff": (PortFFConst, JaxFFConst, dict(FF_KNOBS), TRAIN),
             "vgg": (PortVggConst, JaxVggConst, dict(VGG_KNOBS, dropout=0.0), VGG_TRAIN)}
SEEDS = (0, 5, 7, 11)
LRS = (1e-3, 2e-3, 5e-4, 1e-3)


@pytest.fixture(autouse=True)
def _no_plane(monkeypatch):
    for cls in (PortFFConst, PortVggConst, JaxFFConst, JaxVggConst):
        monkeypatch.setattr(cls, "STOP_LR", None)
    chaos.uninstall()
    jax_chaos.uninstall()
    yield
    chaos.uninstall()
    jax_chaos.uninstall()


def _port(template, lr, seed):
    cls, _, knobs, _ = TEMPLATES[template]
    m = cls(device="cpu", **dict(knobs, learning_rate=lr))
    m._seed = seed
    return m


def _parts(template, k):
    """k float32 members, their loop closures and the train dataset."""
    train = TEMPLATES[template][3]
    ms = [_port(template, LRS[i], SEEDS[i]) for i in range(k)]
    ds = dataset_utils.load(train)
    for m in ms:
        m.packing_key(ds)  # plans the steps the warmup is derived from
    return ms, [m._loop_fns(*m._dataset_arch(ds)) for m in ms], ds


def _epoch_idx(ds, seed, batch):
    n = ds.size // batch
    return np.random.default_rng(seed).permutation(ds.size)[: n * batch].reshape(n, batch)


def _same(a, b):
    return set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("template", ["ff", "vgg"])
def test_an_all_ones_column_is_the_plain_step_bit_for_bit(template):
    """Two epochs of a serial trial and of a k=2 pack, once with no
    column and once multiplied by an all-ones column: the params, the
    moments and every step's metrics are the same bits."""
    ms, fns, ds = _parts(template, 2)
    batch = ms[0].batch_size
    X, Y = port_train.get_device_dataset(ds, CPU)

    def serial(poisoned):
        f = fns[0]
        loop = port_train.TrainLoop(f["init_fn"], f["apply_eval"], f["loss_fn"], f["optimizer"],
                                    seed=SEEDS[0], hyper=f["hyper"], device="cpu")
        series = []
        for epoch in range(2):
            idx = _epoch_idx(ds, SEEDS[0] + epoch, batch)
            ones = np.ones(len(idx), np.float32) if poisoned else None
            loop.state, s = loop.program.train_steps(
                loop.state, port_train.ResidentFeed(X, Y, torch.from_numpy(idx)), poison=ones)
            series.append(s)
        params = {n: p.detach().clone() for n, p in loop.params.named_parameters()}
        return params, loop.state[1], series

    def packed(poisoned):
        loop = port_train.PackedTrainLoop(
            fns[0]["init_fn"], fns[0]["apply_eval"], fns[0]["loss_fn"], fns[0]["optimizer"],
            seeds=SEEDS[:2], hypers=[f["hyper"] for f in fns], device="cpu")
        series = []
        for epoch in range(2):
            idx = np.stack([_epoch_idx(ds, s + epoch, batch) for s in SEEDS[:2]], axis=1)
            ones = np.ones(idx.shape[:2], np.float32) if poisoned else None
            series.append(loop.program.train_steps(
                loop.state, port_train.ResidentFeed(X, Y, torch.from_numpy(idx)), poison=ones))
        params = {n: p.detach().clone() for n, p in loop.state.params.items()}
        return params, loop.state.opt, series

    for run in (serial, packed):
        plain, ones = run(False), run(True)
        assert _same(plain[0], ones[0])
        assert all(torch.equal(a, b) for a, b in zip(plain[1].mu, ones[1].mu))
        assert all(torch.equal(a, b) for a, b in zip(plain[1].nu, ones[1].nu))
        for a, b in zip(plain[2], ones[2]):
            assert _same(a, b)


def _spy(monkeypatch, loop_cls, seen):
    """Record each epoch's health dict before the loop strips it."""
    check = loop_cls._health_check

    def spy(self, out, *args, **kwargs):
        seen.append({k: v for k, v in out.items() if k.startswith("health_")})
        return check(self, out, *args, **kwargs)

    monkeypatch.setattr(loop_cls, "_health_check", spy)


@pytest.mark.parametrize("template", ["ff", "vgg"])
def test_a_poisoned_epoch_reduces_as_the_jax_packages(template, monkeypatch):
    """The same float32 params, data and spec in both packages: the trial
    fails at the poisoned epoch, and its bad step and the non-finite
    count at the bad step (every gradient element) are the JAX
    package's; so is the epoch's non-finite total where the bad step is
    the epoch's last (VGG, 2 steps).

    After the bad step the totals part (FF, 4 steps; ROADMAP Queue 3):
    the params are NaN, and ``jax.nn.relu``'s gradient at a NaN input is
    0 (``select(x > 0, g, 0)``) where torch's passes the upstream
    gradient, so the JAX package finds the gradients below a NaN relu
    finite. The port's total is every gradient element of each step
    from the bad step on, plus the NaN losses after it; the JAX
    package's is lower."""
    port_cls, jax_cls, knobs, train = TEMPLATES[template]
    seen = {"jax": [], "port": []}
    _spy(monkeypatch, jax_train.TrainLoop, seen["jax"])
    _spy(monkeypatch, port_train.TrainLoop, seen["port"])
    spec = "seed=3;train.nan:nan:times=1"
    jax_chaos.install(jax_chaos.FaultPlane.from_spec(spec))
    chaos.install(chaos.FaultPlane.from_spec(spec))
    with pytest.raises(JaxDivergenceError) as want:
        jax_cls(**dict(knobs, learning_rate=1e-3)).train(train)
    port = port_cls(device="cpu", **dict(knobs, learning_rate=1e-3))
    with pytest.raises(DivergenceError) as got:
        port.train(train)
    n_steps = dataset_utils.load(train).size // knobs["batch_size"]
    bad = n_steps // 2
    assert got.value.verdict["bad_step"] == want.value.verdict["bad_step"] == bad
    [a], [b] = seen["jax"], seen["port"]
    n_params = sum(p.numel() for p in port._module.parameters())
    assert int(a["health_bad_step"]) == int(b["health_bad_step"]) == bad
    assert int(a["health_bad_nonfinite"]) == int(b["health_bad_nonfinite"]) == n_params
    after = n_steps - bad - 1
    assert int(b["health_nonfinite"]) == got.value.verdict["nonfinite"] == \
        n_params * (1 + after) + after
    if after == 0:
        assert int(a["health_nonfinite"]) == int(b["health_nonfinite"])
    else:
        assert n_params < int(a["health_nonfinite"]) < int(b["health_nonfinite"])
    assert np.isnan(b["health_bad_grad_norm"]) and np.isnan(a["health_bad_grad_norm"])
    assert [s[:2] for s in chaos.active().schedule()] == \
        [s[:2] for s in jax_chaos.active().schedule()] == [("train.nan", "nan")]


@pytest.mark.parametrize("template", ["ff", "vgg"])
def test_the_poison_misses_every_other_pack_member(template):
    """Member 2 of a k=4 pack is poisoned in epoch 0: it alone diverges
    and is evicted, and members 0, 1 and 3 end bit-equal to their serial
    runs."""
    chaos.install(chaos.FaultPlane.from_spec("seed=3;train.nan:nan:times=1:match=@m2"))
    train = TEMPLATES[template][3]
    members = [_port(template, LRS[i], SEEDS[i]) for i in range(4)]
    TorchModel.train_packed(members, train)
    fired = chaos.active().schedule()
    chaos.uninstall()
    assert len(fired) == 1 and fired[0][3].endswith("@m2")
    verdicts = [getattr(m, "_health_verdict", None) for m in members]
    assert [v is None for v in verdicts] == [True, True, False, True]
    assert verdicts[2]["divergence"] == "nonfinite" and verdicts[2]["member"] == 2
    for i in (0, 1, 3):
        ref = _port(template, LRS[i], SEEDS[i])
        ref.train(train)
        got = dict(members[i]._module.named_parameters())
        want = dict(ref._module.named_parameters())
        assert _same({k: v.detach() for k, v in got.items()},
                     {k: v.detach() for k, v in want.items()}), f"member {i}"


def test_a_quiet_plane_leaves_the_epoch_unpoisoned():
    """An active plane that does not fire gives no column (the epoch runs
    the plain step); a hit gives ones with one NaN at step n // 2, per
    hit member in a pack."""
    ms, fns, ds = _parts("ff", 2)
    f = fns[0]
    loop = port_train.TrainLoop(f["init_fn"], f["apply_eval"], f["loss_fn"], f["optimizer"],
                                seed=0, hyper=f["hyper"], device="cpu")
    packed = port_train.PackedTrainLoop(f["init_fn"], f["apply_eval"], f["loss_fn"],
                                        f["optimizer"], seeds=[0, 1],
                                        hypers=[g["hyper"] for g in fns], device="cpu")
    assert loop._chaos_poison(4) is None and packed._chaos_poison(4) is None
    chaos.install(chaos.FaultPlane.from_spec("train.nan:nan:match=no-such-key"))
    assert loop._chaos_poison(4) is None and packed._chaos_poison(4) is None
    chaos.install(chaos.FaultPlane.from_spec("train.nan:nan:match=@m1"))
    column = packed._chaos_poison(4)
    assert column.shape == (4, 2) and np.isnan(column[2, 1])
    assert np.count_nonzero(np.isnan(column)) == 1 and np.nansum(column) == 7
    chaos.install(chaos.FaultPlane.from_spec("train.nan:nan"))
    column = loop._chaos_poison(5)
    assert column.dtype == np.float32 and np.isnan(column[2]) and np.nansum(column) == 4
