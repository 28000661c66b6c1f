"""The port's program cache and its device-scalar step, on the CPU.

The same trial sequences run in both packages and must move
``program_cache_stats()`` alike and share programs alike (the JAX side
mirrors ``tests/test_program_cache.py``): two FeedForward trials of one
signature, VGG11 w0.25 trials differing only in dropout and learning
rate, a shape-knob change, a 4-trial ``TrainWorker`` job of one
signature, and a pack's width after evict and admit. Then the cache's
own contract (one build under concurrent callers, no lock left by a
raising builder, the LRU cap, ``clear_program_cache``), and the step
body that reads its per-step scalars from a device table: driven over
several epochs through one cached ``Program`` by two trials of other
lr, warmup and dropout, serially and as a pack, it gives the params,
moments, generator states and metrics of the eager arithmetic with
host-float learning rates and bias corrections, which ``_old_epochs``
writes out inline.
"""

import threading
import time

import numpy as np
import pytest
import torch

from rafiki_tpu.models.ff import FeedForward as JaxFF
from rafiki_tpu.models.vgg import Vgg as JaxVgg
from rafiki_tpu.ops import train as jax_train
from rafiki_tpu_torch import telemetry
from rafiki_tpu_torch.model.dataset import dataset_utils
from rafiki_tpu_torch.models.ff import FeedForward
from rafiki_tpu_torch.models.vgg import Vgg
from rafiki_tpu_torch.ops import train as port_train

# See test_torch_train.py: two intra-op threads per xdist worker.
torch.set_num_threads(2)

TRAIN = "synthetic://images?classes=4&n=128&w=8&h=8&c=1&seed=0"
VAL = "synthetic://images?classes=4&n=64&w=8&h=8&c=1&seed=1"
VGG_TRAIN = "synthetic://images?classes=4&n=128&w=8&h=8&c=3&seed=0"
VGG_VAL = "synthetic://images?classes=4&n=64&w=8&h=8&c=3&seed=1"
PACKAGES = {"jax": (jax_train, JaxFF, JaxVgg), "port": (port_train, FeedForward, Vgg)}


@pytest.fixture(autouse=True, scope="module")
def _cold_caches_after():
    """Leave both packages' process-wide program caches empty: a later
    test file in this worker (``tests/test_program_cache.py``) counts a
    build of the programs these tests build as its own miss."""
    yield
    jax_train.clear_program_cache()
    port_train.clear_program_cache()


def _ff_knobs(**over):
    knobs = dict(hidden_layers=1, hidden_units=32, learning_rate=1e-3, batch_size=32,
                 epochs=1, seed=0)
    knobs.update(over)
    return knobs


def _make(pkg, cls, knobs):
    return cls(**knobs) if pkg == "jax" else cls(device="cpu", **knobs)


def _run(pkg, cls, knobs, train=TRAIN, val=VAL):
    m = _make(pkg, cls, knobs)
    m.train(train)
    m.evaluate(val)
    return m


def _delta(before, after):
    return {k: after[k] - before[k] for k in ("hits", "misses", "evictions")}


def _both(scenario):
    return {pkg: scenario(pkg, *mods) for pkg, mods in PACKAGES.items()}


def test_second_same_signature_trial_reuses_the_program():
    """Trial 2 (another lr and epoch count) is a cache hit in both
    packages: the same program object, one hit, no miss."""
    def scenario(pkg, ops, ff, _):
        m1 = _run(pkg, ff, _ff_knobs())
        before = ops.program_cache_stats()
        m2 = _run(pkg, ff, _ff_knobs(learning_rate=3e-2, epochs=2))
        out = dict(_delta(before, ops.program_cache_stats()),
                   same=m2._loop.program is m1._loop.program)
        m1.destroy(), m2.destroy()
        return out

    got = _both(scenario)
    assert got["port"] == got["jax"] == {"hits": 1, "misses": 0, "evictions": 0, "same": True}


def test_vgg_dropout_and_lr_share_one_program():
    """VGG's dropout rate and learning rate reach the step as data, so
    sweeping them reuses one program in both packages."""
    base = dict(depth=11, width_mult=0.25, dropout=0.1, learning_rate=1e-3, batch_size=64,
                epochs=1, seed=0)

    def scenario(pkg, ops, _, vgg):
        m1 = _run(pkg, vgg, base, VGG_TRAIN, VGG_VAL)
        before = ops.program_cache_stats()
        m2 = _run(pkg, vgg, dict(base, dropout=0.45, learning_rate=2e-2), VGG_TRAIN, VGG_VAL)
        out = dict(_delta(before, ops.program_cache_stats()),
                   same=m2._loop.program is m1._loop.program)
        m1.destroy(), m2.destroy()
        return out

    got = _both(scenario)
    assert got["port"] == got["jax"] == {"hits": 1, "misses": 0, "evictions": 0, "same": True}


def test_shape_knob_change_builds_a_new_program():
    def scenario(pkg, ops, ff, _):
        m1 = _run(pkg, ff, _ff_knobs())
        before = ops.program_cache_stats()
        m2 = _run(pkg, ff, _ff_knobs(hidden_units=64))
        out = dict(_delta(before, ops.program_cache_stats()),
                   same=m2._loop.program is m1._loop.program)
        m1.destroy(), m2.destroy()
        return out

    got = _both(scenario)
    assert got["port"] == got["jax"] == {"hits": 0, "misses": 1, "evictions": 0, "same": False}


class _OneSigAdvisor:
    """Proposals in one shape bucket: only the learning rate varies."""

    def __init__(self):
        self._i = 0

    def propose(self):
        self._i += 1
        return _ff_knobs(learning_rate=10.0 ** -(1 + self._i % 3))

    def feedback(self, score, knobs):
        pass


def test_worker_trials_hit_the_program_cache(tmp_path):
    """A 4-trial job on one worker builds at most one program for its
    one signature and hits it at least three times, in both packages."""
    from rafiki_tpu.model.base import load_model_class as jax_load
    from rafiki_tpu.store import MetaStore as JaxMetaStore, ParamsStore as JaxParamsStore
    from rafiki_tpu.worker.train import TrainWorker as JaxTrainWorker
    from rafiki_tpu_torch.model.base import load_model_class
    from rafiki_tpu_torch.store import MetaStore, ParamsStore
    from rafiki_tpu_torch.worker.train import TrainWorker

    sides = {"jax": (JaxMetaStore, JaxParamsStore, JaxTrainWorker, jax_load, "rafiki_tpu", {}),
             "port": (MetaStore, ParamsStore, TrainWorker, load_model_class, "rafiki_tpu_torch",
                      {"devices": [torch.device("cpu")]})}

    def scenario(pkg, ops, _ff, _vgg):
        meta_cls, params_cls, worker_cls, load, root, extra = sides[pkg]
        store = meta_cls(tmp_path / f"{pkg}.sqlite3")
        params = params_cls(tmp_path / f"{pkg}-params")
        src = open(f"{root}/models/ff.py", "rb").read()
        model = store.create_model("ff", "IMAGE_CLASSIFICATION", None, src, "FeedForward")
        job = store.create_train_job("app", "IMAGE_CLASSIFICATION", None, TRAIN, VAL,
                                     {"MODEL_TRIAL_COUNT": 4})
        sub = store.create_sub_train_job(job["id"], model["id"])
        worker = worker_cls(store, params, sub["id"], load(src, "FeedForward"),
                            _OneSigAdvisor(), TRAIN, VAL, {"MODEL_TRIAL_COUNT": 4},
                            async_persist=False, **extra)
        before = ops.program_cache_stats()
        n = worker.run()
        return dict(_delta(before, ops.program_cache_stats()), trials=n)

    got = _both(scenario)
    for side in got.values():
        assert side["trials"] == 4 and side["misses"] <= 1 and side["hits"] >= 3
    assert got["port"] == got["jax"]


def test_pack_width_after_evict_and_admit():
    """A pack of three fetches the width-3 program, evict fetches the
    width-2 one, admit the width-3 one again (a hit, the same object) in
    both packages, whose packed keys carry the width."""
    def scenario(pkg, ops, ff, _):
        m = _make(pkg, ff, _ff_knobs())
        ds = dataset_utils.load(TRAIN)
        num_classes, shape = ds.classes, tuple(ds.x.shape[1:])
        m._planned_steps = 4
        fns = m._loop_fns(num_classes, shape)
        hypers = [dict(fns["hyper"], lr=lr) for lr in (1e-3, 3e-3, 1e-2)]
        key = ("pack-width-test", pkg)
        kwargs = {} if pkg == "jax" else {"device": "cpu"}
        before = ops.program_cache_stats()
        packed = ops.PackedTrainLoop(fns["init_fn"], fns["apply_eval"], fns["loss_fn"],
                                     fns["optimizer"], seeds=[0, 1, 2], hypers=hypers,
                                     program_key=key, **kwargs)
        first = packed.program
        after_init = _delta(before, ops.program_cache_stats())
        packed.evict(1)
        narrow = packed.program
        packed.admit(5, hypers[1])
        out = {"init": after_init, "all": _delta(before, ops.program_cache_stats()),
               "narrow_differs": narrow is not first, "readmitted_same": packed.program is first,
               "keys": (ops.packed_program_key(key, 3, True), packed._perf_key)}
        return out

    got = _both(scenario)
    for side in got.values():
        assert side["keys"][0] == side["keys"][1]
        side["keys"] = side["keys"][0][:2] + side["keys"][0][3:]
    assert got["port"] == got["jax"] == {
        "init": {"hits": 0, "misses": 1, "evictions": 0},
        "all": {"hits": 1, "misses": 2, "evictions": 0},
        "narrow_differs": True, "readmitted_same": True, "keys": ("packed", 3, True)}


# -- the cache's own contract --------------------------------------------------


@pytest.fixture()
def fresh_cache():
    port_train.clear_program_cache()
    yield
    port_train.clear_program_cache()


def test_concurrent_callers_build_once(fresh_cache):
    built = []

    def builder():
        time.sleep(0.05)
        built.append(object())
        return built[-1]

    got = [None] * 8
    barrier = threading.Barrier(len(got))

    def call(i):
        barrier.wait(timeout=10)
        got[i] = port_train.get_program("concurrent", builder)

    threads = [threading.Thread(target=call, args=(i,), daemon=True) for i in range(len(got))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert len(built) == 1 and all(g is built[0] for g in got)
    stats = port_train.program_cache_stats()
    assert (stats["misses"], stats["hits"], stats["size"]) == (1, len(got) - 1, 1)
    assert port_train._build_locks == {}


def test_a_raising_builder_leaves_no_lock(fresh_cache):
    def bad():
        raise RuntimeError("no such knob")

    with pytest.raises(RuntimeError, match="no such knob"):
        port_train.get_program("bad", bad)
    assert port_train._build_locks == {}
    assert port_train.program_cache_stats()["misses"] == 0
    prog = object()
    assert port_train.get_program("bad", lambda: prog) is prog
    assert port_train.get_program("bad", lambda: object()) is prog  # the builder is ignored


def test_the_cache_evicts_the_least_recently_used_at_64(fresh_cache):
    progs = {i: port_train.get_program(("lru", i), object) for i in range(64)}
    port_train.get_program(("lru", 0), object)  # key 0 is now the most recent
    port_train.get_program(("lru", 64), object)
    stats = port_train.program_cache_stats()
    assert (stats["size"], stats["evictions"], stats["misses"], stats["hits"]) == (64, 1, 65, 1)
    assert port_train.get_program(("lru", 0), object) is progs[0]
    assert port_train.get_program(("lru", 1), object) is not progs[1]  # evicted, built again
    assert stats["last_miss_ts"] > 0.0
    assert telemetry.snapshot()["program_cache"]["size"] == 64


def test_clear_program_cache_resets_the_stats(fresh_cache):
    port_train.get_program("a", object)
    port_train.get_program("a", object)
    port_train.clear_program_cache()
    assert port_train.program_cache_stats() == {"hits": 0, "misses": 0, "evictions": 0,
                                                "last_miss_ts": 0.0, "size": 0}


# -- the device-scalar step against the eager arithmetic it replaced -----------

B1, B2, EPS = 0.9, 0.999, 1e-8
_COUNT_MAX = int(np.iinfo(np.int32).max)
# (seed, lr, warmup, dropout) of two trials; three epochs of four steps
# each take both past their warmup.
TRIALS = [(0, 3e-3, 6.0, 0.3), (5, 1e-2, 2.0, 0.1)]
EPOCHS = 3
BATCH = 64
STEP_TRAIN = "synthetic://images?classes=4&n=256&w=8&h=8&c=3&seed=0"


def _old_adam(grads, mu, nu, count):
    """``ops/optim.py ScaleByAdam.update`` as the port had it: bias
    corrections as host floats."""
    if mu is None:
        mu = [torch.zeros_like(g) for g in grads]
        nu = [torch.zeros_like(g) for g in grads]
    torch._foreach_mul_(mu, B1)
    torch._foreach_add_(mu, torch._foreach_mul(grads, 1.0 - B1))
    sq = torch._foreach_mul(grads, grads)
    torch._foreach_mul_(sq, 1.0 - B2)
    torch._foreach_mul_(nu, B2)
    torch._foreach_add_(nu, sq)
    count = min(count + 1, _COUNT_MAX)
    bc1 = float(np.float32(1.0) - np.float32(B1) ** np.float32(count))
    bc2 = float(np.float32(1.0) - np.float32(B2) ** np.float32(count))
    denom = torch._foreach_div(nu, bc2)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, EPS)
    updates = torch._foreach_div(mu, bc1)
    torch._foreach_div_(updates, denom)
    return updates, mu, nu, count


def _old_epochs(fns, seed, hyper, ds):
    """The eager loop with host scalars: each step's ``-effective_lr``
    and bias corrections host floats computed from the host counts."""
    from rafiki_tpu_torch.obs.health import sentinel

    module = fns["init_fn"](torch.Generator().manual_seed(seed))
    generator = torch.Generator().manual_seed(seed)
    hyper = {k: torch.tensor(v, dtype=torch.float32) for k, v in hyper.items()}
    params = list(module.parameters())
    mu = nu = None
    count = step = 0
    X, Y = torch.from_numpy(ds.x), torch.from_numpy(ds.y)
    history = []
    for epoch in range(EPOCHS):
        n = ds.size // BATCH
        perm = np.random.default_rng(seed + epoch).permutation(ds.size)[: n * BATCH]
        rows = []
        for ib in torch.from_numpy(perm.reshape(n, BATCH)):
            with torch.enable_grad():
                loss, metrics = fns["loss_fn"](module, {"x": X[ib], "y": Y[ib]}, generator, hyper)
                grads = torch.autograd.grad(loss, params)
            with torch.no_grad():
                updates, mu, nu, count = _old_adam(grads, mu, nu, count)
                lr = float(port_train.effective_lr(hyper, step))
                torch._foreach_mul_(updates, -lr)
                torch._foreach_add_(params, updates)
                health = sentinel.bundle(loss.detach(), grads, updates, params)
            step += 1
            rows.append(dict({k: v.detach() for k, v in metrics.items()}, loss=loss.detach(),
                             **health))
        series = {k: torch.stack([r[k] for r in rows]) for k in rows[0]}
        rest, health = sentinel.split(series)
        out = {k: float(v[-1]) for k, v in rest.items()}
        out.update({k: float(v) for k, v in sentinel.reduce_epoch(health).items()})
        history.append(out)
    return module, mu, nu, count, step, generator, history


def _vgg_fns(lr):
    m = Vgg(device="cpu", depth=11, width_mult=0.25, dropout=0.2, learning_rate=lr,
            batch_size=BATCH, epochs=EPOCHS, seed=0)
    m._planned_steps = 12
    ds = dataset_utils.load(STEP_TRAIN)
    return m._loop_fns(ds.classes, tuple(ds.x.shape[1:])), ds


def _assert_state_equal(module, mu, nu, generator, want):
    w_module, w_mu, w_nu, _, _, w_gen, _ = want
    for (name, a), b in zip(module.named_parameters(), w_module.parameters()):
        assert torch.equal(a, b), name
    for a, b in zip(mu + nu, w_mu + w_nu):
        assert torch.equal(a, b)
    assert torch.equal(generator.get_state(), w_gen.get_state())


def test_device_scalar_step_gives_the_bits_of_the_host_scalar_step(fresh_cache):
    """Two trials of other lr, warmup and dropout through one cached
    Program (the second a cache hit), three epochs each, the second epoch
    fed from the host: every epoch's metrics, and the params, moments,
    counts and generator states after, equal the host-scalar eager
    arithmetic bit for bit. Then both as one pack: the same bits."""
    ds = None
    loops, wants = [], []
    for seed, lr, warmup, rate in TRIALS:
        hyper = {"lr": lr, "warmup": warmup, "dropout": rate}
        old_fns, ds = _vgg_fns(lr)  # its own module: init_fn fills one module in place
        want = _old_epochs(old_fns, seed, hyper, ds)
        fns, _ = _vgg_fns(lr)
        loop = port_train.TrainLoop(fns["init_fn"], fns["apply_eval"], fns["loss_fn"],
                                    fns["optimizer"], seed=seed, hyper=hyper,
                                    program_key=("step-bits", "vgg11"), device="cpu")
        seen = []
        history = []
        for epoch in range(EPOCHS):
            on_metrics = (lambda i, m: seen.append((i, m))) if epoch == 1 else None
            history.append(loop.run_epoch(ds, BATCH, seed + epoch, on_metrics=on_metrics))
        assert [i for i, _ in seen] == [0]
        # The health gate strips the sentinel keys from the returned rows.
        assert history == [{k: v for k, v in h.items() if not k.startswith("health_")}
                           for h in want[-1]]
        module, opt, step, generator, _ = loop.state
        assert (opt.count, step) == (want[3], want[4]) == (12, 12)
        _assert_state_equal(module, opt.mu, opt.nu, generator, want)
        loops.append(loop)
        wants.append(want)
    assert loops[0].program is loops[1].program
    assert port_train.program_cache_stats()["hits"] == 1

    fns, _ = _vgg_fns(TRIALS[0][1])
    packed = port_train.PackedTrainLoop(
        fns["init_fn"], fns["apply_eval"], fns["loss_fn"], fns["optimizer"],
        seeds=[t[0] for t in TRIALS],
        hypers=[{"lr": lr, "warmup": w, "dropout": d} for _, lr, w, d in TRIALS],
        program_key=("step-bits", "vgg11"), device="cpu")
    for epoch in range(EPOCHS):
        rows = packed.run_epoch(ds, BATCH, [t[0] + epoch for t in TRIALS])
        for i, want in enumerate(wants):
            assert rows[i] == {k: v for k, v in want[-1][epoch].items()
                               if not k.startswith("health_")}
    st = packed.state
    assert st.opt.count == (12, 12) and st.steps == [12, 12]
    for i, want in enumerate(wants):
        _assert_state_equal(packed.slice(i).params, [m[i] for m in st.opt.mu],
                            [v[i] for v in st.opt.nu], st.generators[i], want)


def test_step_table_rows_are_the_host_scalars_of_each_step():
    """The epoch's table holds, row by row, the float32 values the
    host-scalar step computed at each step: ``-effective_lr`` across the end
    of warmup and Adam's bias corrections, for a trial and a pack whose
    members sit at other steps."""
    from rafiki_tpu_torch.ops.optim import ScaleByAdamState, scale_by_adam

    opt = scale_by_adam()
    hyper = {"lr": torch.tensor(3e-3), "warmup": torch.tensor(5.0)}
    table = port_train._step_table(opt, ScaleByAdamState(3, None, None), hyper, 3, 6, True)
    assert table.dtype == np.float32 and table.shape == (6, 3)
    for t in range(6):
        assert table[t, 0] == -float(port_train.effective_lr(hyper, 3 + t))
        assert table[t, 1] == np.float32(1.0) - np.float32(B1) ** np.float32(4 + t)
        assert table[t, 2] == np.float32(1.0) - np.float32(B2) ** np.float32(4 + t)
    assert np.all(table[2:, 0] == np.float32(-3e-3)) and table[0, 0] > table[1, 0]
    packed = opt.step_scalars(ScaleByAdamState((0, 7), None, None), 2)
    assert packed.shape == (2, 2, 2)
    np.testing.assert_array_equal(packed[:, 1], opt.step_scalars(ScaleByAdamState(7, None, None), 2))


def test_two_threads_train_packs_of_one_cached_program(fresh_cache):
    """Two threads each train a pack through the same cached
    PackedProgram at once (as two workers' packs of one key do); each
    ends with the params of the same pack trained alone."""
    ds = dataset_utils.load(TRAIN)
    m = FeedForward(device="cpu", **_ff_knobs())
    m._planned_steps = 8
    fns = m._loop_fns(ds.classes, tuple(ds.x.shape[1:]))

    def pack(seeds):
        return port_train.PackedTrainLoop(
            fns["init_fn"], fns["apply_eval"], fns["loss_fn"], fns["optimizer"], seeds=seeds,
            hypers=[dict(fns["hyper"], lr=1e-2)] * len(seeds), program_key=("threads", "ff"),
            device="cpu")

    def train(loop, out, i):
        for epoch in range(2):
            loop.run_epoch(ds, 32, [epoch, epoch])
        out[i] = [p.detach().clone() for p in loop.state.params.values()]

    loops = [pack([0, 1]), pack([2, 3])]
    assert loops[0].program is loops[1].program
    got = [None, None]
    threads = [threading.Thread(target=train, args=(loop, got, i), daemon=True)
               for i, loop in enumerate(loops)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    for i, seeds in enumerate(([0, 1], [2, 3])):
        want = [None, None]
        train(pack(seeds), want, i)
        assert all(torch.equal(a, b) for a, b in zip(got[i], want[i]))
