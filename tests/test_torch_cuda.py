"""The port on the CUDA card, held against its own CPU path.

Runs only where a card is present (marker ``cuda``); here it skips.
This file imports no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import threading
import time

import numpy as np
import pytest
import torch

SMALL = dict(depth=11, width_mult=0.25, dropout=0.0, learning_rate=1e-3,
             batch_size=64, epochs=1, seed=0)
# Card vs CPU, both bf16 compute: cuDNN and oneDNN round to bf16 at
# other points; the JAX package's own bf16-vs-f32 gap is about 2e-3.
BF16_PROB_ATOL = 5e-3

pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _models(device):
    from rafiki_tpu_torch.models.vgg import Vgg

    blobs = []
    for seed in range(3):
        m = Vgg(device="cpu", **SMALL)
        m.init_parameters(10, (32, 32, 3), torch.Generator().manual_seed(seed))
        blobs.append(m.dump_parameters())
    out = []
    for b in blobs:
        m = Vgg(device=device, **SMALL)
        m.load_parameters(b)
        out.append(m)
    return out


def test_card_stacked_serving_replays_its_captured_forward_bit_for_bit(cuda):
    """The stacked adapter captures its forward once at the serving
    shape and replays it for every later chunk; the replays equal the
    eager stacked forward on the same padded chunks bit for bit."""
    from rafiki_tpu_torch import telemetry
    from rafiki_tpu_torch.parallel.serving import build_stacked

    stacked, reason = build_stacked([{"model_name": "vgg"}] * 3, _models(cuda), batch_size=8)
    assert reason == "stacked"
    x = np.random.default_rng(2).uniform(0, 1, size=(13, 32, 32, 3)).astype(np.float32)
    xp = stacked._first.preprocess(x)
    telemetry.reset()
    got = [stacked.predict_proba(xp) for _ in range(2)]
    pad = np.concatenate([xp, np.zeros((3,) + xp.shape[1:], xp.dtype)])
    eager = np.concatenate([stacked._ens.ensemble_proba(torch.from_numpy(c).to(cuda))
                            for c in (pad[:8], pad[8:])])[:13]
    counters = telemetry.snapshot()["counters"]
    assert counters["serving.graph_captures"] == 1
    assert counters["serving.graph_replays"] == 4
    for g in got:
        assert g.shape == (13, 10) and np.array_equal(g, eager)
    stacked.destroy()


def test_card_stacked_serving_threads_leave_no_memory_behind(cuda):
    """Served jobs' callers are threads made per job (workers, HTTP
    handlers), two at a time here; every capture and replay runs on the
    card's one serving thread, so after the first round a round of jobs
    served and stopped leaves the card's ``memory_allocated`` where it
    found it (within 1 MiB)."""
    from rafiki_tpu_torch.parallel.serving import build_stacked

    q = np.random.default_rng(5).uniform(0, 1, size=(3, 32, 32, 3)).astype(np.float32).tolist()

    def serve():
        stacked, reason = build_stacked([{"model_name": "vgg"}] * 3, _models(cuda),
                                        batch_size=64)
        assert reason == "stacked"
        stacked.warmup()
        stacked.predict(q)
        stacked.destroy()

    def round_of_two():
        threads = [threading.Thread(target=serve) for _ in range(2)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
            assert not th.is_alive()
        torch.cuda.synchronize()
        return torch.cuda.memory_allocated()

    first = round_of_two()
    grown = [round_of_two() - first for _ in range(3)]
    assert all(g <= 1 << 20 for g in grown), grown


def test_card_forward_matches_cpu(cuda):
    x = np.random.default_rng(0).uniform(0, 1, size=(7, 32, 32, 3)).astype(np.float32)
    card = [m.predict_proba(x) for m in _models(cuda)]
    cpu = [m.predict_proba(x) for m in _models("cpu")]
    for a, b in zip(card, cpu):
        assert a.shape == (7, 10) and np.isfinite(a).all()
        np.testing.assert_allclose(a, b, rtol=0, atol=BF16_PROB_ATOL)


def test_card_stacked_route_matches_replicated(cuda):
    from rafiki_tpu_torch import telemetry
    from rafiki_tpu_torch.bus.queues import InProcBus
    from rafiki_tpu_torch.parallel.serving import build_stacked
    from rafiki_tpu_torch.predictor.predictor import Predictor
    from rafiki_tpu_torch.worker.inference import InferenceWorker

    queries = np.random.default_rng(1).uniform(0, 1, size=(5, 32, 32, 3)).astype(np.float32).tolist()
    stacked, reason = build_stacked([{"model_name": "vgg"}] * 3, _models(cuda))
    assert reason == "stacked" and stacked.warmup() > 0.0
    outs = []
    for models in ([stacked], _models(cuda)):
        telemetry.reset()
        bus = InProcBus()
        workers = [InferenceWorker(bus, "job", f"w{i}", m) for i, m in enumerate(models)]
        threads = [threading.Thread(target=w.run, daemon=True) for w in workers]
        for t in threads:
            t.start()
        try:
            deadline = time.monotonic() + 60
            while len(bus.get_workers("job")) < len(workers):
                assert time.monotonic() < deadline, "workers never registered"
                threading.Event().wait(0.01)
            outs.append(np.asarray(Predictor(bus, "job", timeout_s=60).predict(queries)))
        finally:
            for w in workers:
                w.stop()
            for t in threads:
                t.join(timeout=30)
        # Every worker served every query: an error reply would be
        # dropped from the ensemble and leave a smaller one behind.
        counters = telemetry.snapshot()["counters"]
        assert counters.get("inference.batch_errors", 0) == 0
        assert counters.get("predictor.hedged_gathers", 0) == 0
        assert counters["inference.queries_served"] == len(workers) * len(queries)
    assert outs[0].shape == (5, 10)
    np.testing.assert_allclose(outs[0], outs[1], rtol=0, atol=BF16_PROB_ATOL)


# Card vs CPU training, float32 with TF32 off: three steps of VGG11 w0.25
# from the same params on the same batches. The convs sum in other
# orders on the two devices, and Adam's first steps divide each gradient
# by its own magnitude, so elements whose gradient is rounding noise
# move by up to about lr: the params are held by their L2 distance
# relative to how far they moved. Readings (H100, max over the steps):
# loss 1.0e-7 rel, grad norm 4.9e-7, params 1.1e-2 of the distance
# moved. Bounds: about 3x.
TRAIN_PARITY_TOL = {"loss_rel": 1e-6, "grad_norm_rel": 2e-6, "param_rel_l2": 3e-2}


def test_card_training_steps_match_cpu(cuda):
    from rafiki_tpu_torch.convert import state_dict_to_flax
    from rafiki_tpu_torch.models.vgg import Vgg, _Vgg

    class VggF32(Vgg):
        def build_module(self, num_classes, input_shape):
            return _Vgg(11, 0.25, num_classes, input_shape, dtype=torch.float32)

    prev = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        src = VggF32(device="cpu", **SMALL)
        src.init_parameters(10, (8, 8, 3))
        start = {k: v.clone() for k, v in state_dict_to_flax(src._module).items()}
        rng = np.random.default_rng(3)
        batches = [{"x": torch.from_numpy(rng.uniform(0, 1, size=(16, 8, 8, 3)).astype(np.float32)),
                    "y": torch.from_numpy(rng.integers(0, 10, size=16).astype(np.int32))}
                   for _ in range(3)]
        runs = {}
        for device in ("cpu", cuda):
            m = VggF32(device=device, **SMALL)
            m.init_parameters(10, (8, 8, 3))  # the same seeded draw as src
            loop, rows = m._loop, []
            for b in batches:
                loop.state, metrics = loop.program.train_step(
                    loop.state, {k: v.to(loop.device) for k, v in b.items()})
                rows.append((float(metrics["loss"]), float(metrics["health_grad_norm"]),
                             int(metrics["health_nonfinite"]),
                             {k: v.detach().cpu().clone()
                              for k, v in state_dict_to_flax(m._module).items()}))
            runs[str(device)] = rows
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev
    for (loss_a, gn_a, nf_a, p_a), (loss_b, gn_b, nf_b, p_b) in zip(runs["cuda"], runs["cpu"]):
        assert nf_a == nf_b == 0
        num = sum(float(((p_a[k] - p_b[k]) ** 2).sum()) for k in p_a) ** 0.5
        den = sum(float(((p_b[k] - start[k]) ** 2).sum()) for k in p_a) ** 0.5
        r = {"loss_rel": abs(loss_a - loss_b) / loss_b, "grad_norm_rel": abs(gn_a - gn_b) / gn_b,
             "param_rel_l2": num / den}
        print(r)
        for key, bound in TRAIN_PARITY_TOL.items():
            assert r[key] <= bound, (key, r)


def _pack_run(device, dropout, batches, lrs, packed=True):
    """Three float32 VGG11 w0.25 trials (seeds 0-2, learning rates
    ``lrs``) over the same three steps, as one pack or as three serial
    loops. Returns per-member rows of (loss, grad norm, non-finite,
    params)."""
    from rafiki_tpu_torch.convert import state_dict_to_flax
    from rafiki_tpu_torch.models.vgg import Vgg, _Vgg
    from rafiki_tpu_torch.ops.train import PackedTrainLoop, TrainLoop

    class VggF32(Vgg):
        def build_module(self, num_classes, input_shape):
            return _Vgg(11, 0.25, num_classes, input_shape, dtype=torch.float32,
                        dropout=dropout)

    fns = []
    for lr in lrs:
        m = VggF32(device=device, **dict(SMALL, learning_rate=lr, dropout=dropout))
        m._planned_steps = len(batches)
        fns.append(m._loop_fns(10, (8, 8, 3)))
    f0 = fns[0]
    rows = [[] for _ in fns]
    if packed:
        loop = PackedTrainLoop(f0["init_fn"], f0["apply_eval"], f0["loss_fn"], f0["optimizer"],
                               seeds=[0, 1, 2], hypers=[f["hyper"] for f in fns], device=device)
        for b in batches:
            metrics = loop.program.train_step(
                loop.state, {k: torch.stack([v] * 3).to(loop.device) for k, v in b.items()})
            for i in range(3):
                module = loop.slice(i).params
                rows[i].append((float(metrics["loss"][i]), float(metrics["health_grad_norm"][i]),
                                int(metrics["health_nonfinite"][i]),
                                {k: v.detach().cpu().clone()
                                 for k, v in state_dict_to_flax(module).items()}))
        return rows
    for i, f in enumerate(fns):
        loop = TrainLoop(f["init_fn"], f["apply_eval"], f["loss_fn"], f["optimizer"], seed=i,
                         hyper=f["hyper"], device=device)
        for b in batches:
            loop.state, metrics = loop.program.train_step(
                loop.state, {k: v.to(loop.device) for k, v in b.items()})
            rows[i].append((float(metrics["loss"]), float(metrics["health_grad_norm"]),
                            int(metrics["health_nonfinite"]),
                            {k: v.detach().cpu().clone()
                             for k, v in state_dict_to_flax(loop.params).items()}))
    return rows


# A pack of three VGG11 w0.25 trials on the card, float32, TF32 off,
# 3 steps: against the same pack on the CPU (learning rate 1e-3, seeds
# 0-2, dropout 0, as the two devices' random streams differ), beside the
# serial trials' own card-vs-CPU gap; and against serial trials on the
# card (learning rates 1e-3/3e-3/2e-3, dropout 0.2), which it must equal
# bit for bit: GroupNorm runs once per member where autograd records,
# Adam's quotient and the learning rate once per member with the serial
# ops, and training selects cuDNN's deterministic algorithms.
# Card vs CPU readings (H100, the worst of the three members and steps,
# over two runs): pack loss 6.2e-5 rel, grad norm 1.3e-2, params 3.4e-2
# of the distance moved, as the serial trials' own card-vs-CPU gap
# (3.5e-2; seeds 1-2 of this small network at 8x8 amplify rounding).
# Bounds: about 3x.
PACK_CARD_VS_CPU_TOL = {"loss_rel": 2e-4, "grad_norm_rel": 4e-2, "param_rel_l2": 1e-1}
PACK_VS_SERIAL_TOL = {"loss_rel": 0.0, "grad_norm_rel": 0.0, "param_rel_l2": 0.0}
PACK_LRS = (1e-3, 3e-3, 2e-3)


def test_card_pack_matches_cpu_pack_and_card_serial(cuda):
    """A pack of three trials on the card against the same pack on the
    CPU, and the serial trials' card-vs-CPU gap beside it, held to
    PACK_CARD_VS_CPU_TOL; then against three serial trials on the card
    (one dropout stream per member on both paths), held to
    PACK_VS_SERIAL_TOL: equal loss, grad norm and params."""
    from rafiki_tpu_torch.convert import state_dict_to_flax
    from rafiki_tpu_torch.models.vgg import Vgg

    rng = np.random.default_rng(4)
    batches = [{"x": torch.from_numpy(rng.uniform(0, 1, size=(16, 8, 8, 3)).astype(np.float32)),
                "y": torch.from_numpy(rng.integers(0, 10, size=16).astype(np.int32))}
               for _ in range(3)]
    prev = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    same_lr = (1e-3,) * 3
    try:
        pairs = {
            "pack_card_vs_cpu": (same_lr, _pack_run(cuda, 0.0, batches, same_lr),
                                 _pack_run("cpu", 0.0, batches, same_lr)),
            "serial_card_vs_cpu": (same_lr, _pack_run(cuda, 0.0, batches, same_lr, packed=False),
                                   _pack_run("cpu", 0.0, batches, same_lr, packed=False)),
            "pack_vs_serial": (PACK_LRS, _pack_run(cuda, 0.2, batches, PACK_LRS),
                               _pack_run(cuda, 0.2, batches, PACK_LRS, packed=False))}
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev
    worst = {name: {"loss_rel": 0.0, "grad_norm_rel": 0.0, "param_rel_l2": 0.0}
             for name in pairs}
    for name, (lrs, got, want) in pairs.items():
        for seed, lr in enumerate(lrs):
            src = Vgg(device="cpu", **dict(SMALL, learning_rate=lr))
            src._seed = seed
            src.init_parameters(10, (8, 8, 3))
            start = {k: v.clone() for k, v in state_dict_to_flax(src._module).items()}
            for (loss_a, gn_a, nf_a, p_a), (loss_b, gn_b, nf_b, p_b) in zip(got[seed], want[seed]):
                assert nf_a == nf_b == 0
                if name == "pack_vs_serial":
                    assert all(torch.equal(p_a[k], p_b[k]) for k in p_a), (seed, lr)
                num = sum(float(((p_a[k] - p_b[k]) ** 2).sum()) for k in p_a) ** 0.5
                den = sum(float(((p_b[k] - start[k]) ** 2).sum()) for k in p_a) ** 0.5
                r = {"loss_rel": abs(loss_a - loss_b) / loss_b,
                     "grad_norm_rel": abs(gn_a - gn_b) / gn_b, "param_rel_l2": num / den}
                worst[name] = {k: max(worst[name][k], r[k]) for k in r}
    print("PACK_CARD_READINGS", worst)
    for name, tol in (("pack_card_vs_cpu", PACK_CARD_VS_CPU_TOL),
                      ("serial_card_vs_cpu", PACK_CARD_VS_CPU_TOL),
                      ("pack_vs_serial", PACK_VS_SERIAL_TOL)):
        for key, bound in tol.items():
            assert worst[name][key] <= bound, (name, key, worst[name])


def _resumed_dumps(device, packed):
    """Three epochs of small bf16 VGG trials at dropout 0.2 on ``device``
    (two as one pack when ``packed``) with a checkpoint every epoch; then
    each trial resumed from its epoch-0 and epoch-1 checkpoints. Returns
    per trial the uninterrupted run's params blob and the resumed ones."""
    from rafiki_tpu_torch.models.vgg import Vgg

    uri = "synthetic://images?classes=10&w=8&h=8&c=3&n=256&seed=0"
    knobs = [dict(SMALL, dropout=0.2, epochs=3, learning_rate=lr) for lr in (1e-3, 3e-3)]

    def model(i):
        m = Vgg(device=device, **knobs[i])
        m._seed = i
        return m

    ckpts = {}
    if packed:
        models = [model(0), model(1)]

        def sink(rnd, make_blobs):
            for mi, epoch, blob in make_blobs():
                ckpts[(mi, epoch)] = blob

        Vgg.train_packed(models, uri, checkpoint_sink=sink)
    else:
        models = []
        for i in range(2):
            m = model(i)
            m.set_checkpoint_sink(lambda e, mk, i=i: ckpts.__setitem__((i, e), mk()))
            m.train(uri)
            models.append(m)
    out = []
    for i in range(2):
        resumed = []
        for epoch in (0, 1):
            m = model(i)
            assert m.restore_checkpoint(ckpts[(i, epoch)]) == epoch + 1
            m.train(uri)
            resumed.append(m.dump_parameters())
        out.append((models[i].dump_parameters(), resumed))
    return out


def test_card_checkpoints_resume_bit_for_bit(cuda):
    """A serial trial's and a pack member's checkpoints on the card carry
    the CUDA dropout generator: a trial resumed from either ends byte-equal
    to its uninterrupted serial run. The epochs run as captured graphs
    (two eager steps, then replays), before and after the checkpoints."""
    from rafiki_tpu_torch import telemetry

    replays = telemetry.get_counter("train.graph_replays")
    serial = _resumed_dumps(cuda, packed=False)
    packed = _resumed_dumps(cuda, packed=True)
    assert telemetry.get_counter("train.graph_replays") > replays
    for (want, resumed), (pack_full, pack_resumed) in zip(serial, packed):
        assert pack_full == want
        assert resumed == [want, want]
        assert pack_resumed == [want, want]


# -- captured steps (ops/graphs.py) against eager ones ---------------------------

GRAPH_STEPS = 24
GRAPH_BATCH = 32
# (seed, lr, warmup, dropout): the warmup ramp ends inside the run.
GRAPH_TRIALS = [(0, 3e-3, 10.0, 0.3), (7, 1e-3, 3.0, 0.1)]


def _graph_data(device, n_steps, batch, k=None):
    g = torch.Generator().manual_seed(11)
    n = 512
    X = torch.rand((n, 8, 8, 3), generator=g).to(device)
    Y = torch.randint(0, 10, (n,), generator=g).to(device)
    shape = (n_steps, batch) if k is None else (n_steps, k, batch)
    idx = torch.randint(0, n, shape, generator=g).to(device)
    return X, Y, idx


def _graph_fns(device, lr):
    from rafiki_tpu_torch.models.vgg import Vgg

    m = Vgg(device=device, **dict(SMALL, learning_rate=lr, dropout=0.2))
    m._planned_steps = GRAPH_STEPS
    return m._loop_fns(10, (8, 8, 3))


def _graph_loop(device, trial, key=("card-graph", "vgg11")):
    from rafiki_tpu_torch.ops.train import TrainLoop

    seed, lr, warmup, rate = trial
    f = _graph_fns(device, lr)
    return TrainLoop(f["init_fn"], f["apply_eval"], f["loss_fn"], f["optimizer"], seed=seed,
                     hyper={"lr": lr, "warmup": warmup, "dropout": rate}, program_key=key,
                     device=device)


def _assert_loops_equal(a, b):
    (ma, oa, sa, ga, _), (mb, ob, sb, gb, _) = a.state, b.state
    assert (sa, oa.count) == (sb, ob.count)
    for (name, pa), pb in zip(ma.named_parameters(), mb.parameters()):
        assert torch.equal(pa, pb), name
    for x, y in zip(oa.mu + oa.nu, ob.mu + ob.nu):
        assert torch.equal(x, y)
    assert torch.equal(ga.get_state(), gb.get_state())


def test_card_graphed_step_matches_eager(cuda):
    """Two trials of other lr, warmup and dropout share one cached
    Program; each runs GRAPH_STEPS steps eagerly (``train_step``), as a
    captured epoch over the resident data (``train_steps``) and as one
    fed from the host. Params, moments, counts, every step's loss and
    sentinels, and the dropout generator's state are equal bit for bit;
    the graphed runs replayed. The eval epoch, captured, counts what the
    eager eval steps count."""
    from rafiki_tpu_torch import telemetry
    from rafiki_tpu_torch.ops.graphs import GRAPH_WARMUP_STEPS
    from rafiki_tpu_torch.ops.train import HostFeed, ResidentFeed

    X, Y, idx = _graph_data(cuda, GRAPH_STEPS, GRAPH_BATCH)
    programs = set()
    for trial in GRAPH_TRIALS:
        eager, resident, fed = (_graph_loop(cuda, trial) for _ in range(3))
        programs.add(id(eager.program))
        steps = []
        for t in range(GRAPH_STEPS):
            batch = {"x": X.index_select(0, idx[t]), "y": Y.index_select(0, idx[t])}
            eager.state, metrics = eager.program.train_step(eager.state, batch)
            steps.append(metrics)
        want = {k: torch.stack([m[k] for m in steps]) for k in steps[0]}
        replays = telemetry.get_counter("train.graph_replays")
        resident.state, got = resident.program.train_steps(resident.state,
                                                           ResidentFeed(X, Y, idx))
        assert (telemetry.get_counter("train.graph_replays") - replays
                == GRAPH_STEPS - GRAPH_WARMUP_STEPS)
        x_host, y_host, idx_host = X.cpu().numpy(), Y.cpu().numpy(), idx.cpu().numpy()
        feed = HostFeed(({"x": x_host[ib], "y": y_host[ib]} for ib in idx_host), GRAPH_STEPS,
                        cuda)
        fed.state, got_fed = fed.program.train_steps(fed.state, feed)
        for series in (got, got_fed):
            assert set(series) == set(want)
            for k in want:
                assert torch.equal(series[k], want[k]), k
        _assert_loops_equal(resident, eager)
        _assert_loops_equal(fed, eager)
        with torch.inference_mode():
            module = eager.params
            c, n = eager.program.eval_epoch(module, X, Y, idx)
            sums = [eager.program.eval_step(module, {"x": X.index_select(0, ib),
                                                     "y": Y.index_select(0, ib)}) for ib in idx]
        assert (int(c), int(n)) == (sum(int(a) for a, _ in sums), sum(int(b) for _, b in sums))
    assert len(programs) == 1


def test_card_graphed_pack_matches_graphed_serial(cuda):
    """A k=4 pack and its four serial trials, all captured: every
    member's params, moments, steps and per-step metrics are its serial
    trial's bit for bit (PACK_VS_SERIAL_TOL: exact)."""
    from rafiki_tpu_torch.ops.train import PackedTrainLoop, ResidentFeed

    trials = GRAPH_TRIALS + [(3, 2e-3, 5.0, 0.2), (9, 5e-4, 1.0, 0.0)]
    k = len(trials)
    X, Y, idx = _graph_data(cuda, 12, GRAPH_BATCH, k=k)
    f = _graph_fns(cuda, trials[0][1])
    packed = PackedTrainLoop(f["init_fn"], f["apply_eval"], f["loss_fn"], f["optimizer"],
                             seeds=[t[0] for t in trials],
                             hypers=[{"lr": lr, "warmup": w, "dropout": d}
                                     for _, lr, w, d in trials],
                             program_key=("card-graph", "vgg11"), device=cuda)
    series = packed.program.train_steps(packed.state, ResidentFeed(X, Y, idx))
    st = packed.state
    for i, trial in enumerate(trials):
        loop = _graph_loop(cuda, trial)
        loop.state, want = loop.program.train_steps(loop.state,
                                                    ResidentFeed(X, Y, idx[:, i].contiguous()))
        module, opt, step, generator, _ = loop.state
        assert (st.steps[i], st.opt.count[i]) == (step, opt.count) == (12, 12)
        for (name, p), q in zip(module.named_parameters(), st.params.values()):
            assert torch.equal(p, q[i]), (i, name)
        for a, b in zip(opt.mu + opt.nu, st.opt.mu + st.opt.nu):
            assert torch.equal(a, b[i])
        assert torch.equal(generator.get_state(), st.generators[i].get_state())
        for key, v in want.items():
            assert torch.equal(series[key][:, i], v), (i, key)


# -- the rest of the zoo -------------------------------------------------------

ZOO_KNOBS = {
    "densenet": dict(depth=22, growth=12, learning_rate=1e-3, batch_size=64, epochs=1, seed=0),
    "transformer": dict(embed_dim=32, num_heads=2, num_layers=1, learning_rate=1e-3,
                        batch_size=32, epochs=1, seed=0),
    "pos_bilstm": dict(embed_dim=32, hidden=32, learning_rate=1e-3, batch_size=32, epochs=1,
                       seed=0),
}
ZOO_ARCH = {"densenet": (5, (16, 16, 3), 0), "transformer": (5, (16,), 81),
            "pos_bilstm": (6, (12,), 80)}


def _zoo_model(family, device, dtype=torch.bfloat16):
    """A template of ``family`` computing in ``dtype``, its params drawn
    from the seeded CPU init (the same on every device)."""
    from rafiki_tpu_torch.models.densenet import DenseNet, _DenseNet
    from rafiki_tpu_torch.models.pos_bilstm import PosBiLstm, _BiLstmTagger
    from rafiki_tpu_torch.models.transformer import Transformer, _Encoder

    nc, shape, vocab = ZOO_ARCH[family]
    build = {
        "densenet": (DenseNet, lambda: _DenseNet(22, 12, nc, 3, dtype=dtype)),
        "transformer": (Transformer, lambda: _Encoder(vocab, 32, 2, 1, nc, 16, dtype=dtype)),
        "pos_bilstm": (PosBiLstm, lambda: _BiLstmTagger(vocab, 32, 32, nc, dtype=dtype)),
    }[family]

    class Template(build[0]):
        def build_module(self, num_classes, input_shape):
            return build[1]()

    m = Template(device=device, **ZOO_KNOBS[family])
    m._dataset_meta = {"vocab": vocab}
    m._planned_steps = 8
    m.init_parameters(nc, shape)
    return m


def _zoo_batches(family, n_steps, batch, seed=3):
    nc, shape, vocab = ZOO_ARCH[family]
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_steps):
        if family == "densenet":
            x = rng.uniform(0, 1, size=(batch,) + shape).astype(np.float32)
            y = rng.integers(0, nc, size=batch).astype(np.int32)
        elif family == "transformer":
            x = rng.integers(0, vocab, size=(batch,) + shape).astype(np.int32)
            y = rng.integers(0, nc, size=batch).astype(np.int32)
        else:  # a corpus batch: labels -1 past each row's length
            x = rng.integers(1, vocab, size=(batch,) + shape).astype(np.int32)
            lens = rng.integers(shape[0] // 2, shape[0] + 1, size=batch)
            mask = np.arange(shape[0])[None, :] < lens[:, None]
            x = np.where(mask, x, 0).astype(np.int32)
            y = np.where(mask, rng.integers(0, nc, size=x.shape), -1).astype(np.int32)
        out.append({"x": x, "y": y})
    return out


# Card vs CPU, float32 with TF32 off, three steps from the same params
# (lr 1e-3): DenseNet 22/12 at 16x16 and the Transformer (embed 32, 2
# heads, 1 layer); the logits of the first forward, then the loss, the
# gradient norm and the params after each step (as TRAIN_PARITY_TOL).
# An attention key bias has a zero gradient (the softmax over keys
# cancels it), so Adam moves it by up to lr a step on rounding noise:
# it is held to that and left out of the params' gap. Readings (H100,
# max over the steps): logits 9.5e-7 / 4.8e-7, loss 1.4e-7 / 0 rel,
# grad norm 7.4e-8 / 6.8e-8, params 2.7e-5 of the distance moved for
# DenseNet (6.0e-3 for the Transformer with its key bias in). Bounds:
# about 3x, the Transformer's params held to DenseNet's bound.
ZOO_F32_LOGIT_ATOL = 3e-6
ZOO_TRAIN_PARITY_TOL = {"loss_rel": 5e-7, "grad_norm_rel": 3e-7, "param_rel_l2": 1e-4}


@pytest.mark.parametrize("family", ["densenet", "transformer"])
def test_card_zoo_f32_forward_and_steps_match_cpu(cuda, family):
    from rafiki_tpu_torch.convert import state_dict_to_flax

    prev = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    batches = _zoo_batches(family, 3, 16)
    try:
        runs = {}
        for name, device in (("cpu", "cpu"), ("card", cuda)):
            m = _zoo_model(family, device, torch.float32)
            loop, rows = m._loop, []
            with torch.no_grad():
                logits = m._module(torch.from_numpy(batches[0]["x"]).to(loop.device)).cpu()
            for b in batches:
                loop.state, metrics = loop.program.train_step(
                    loop.state, {k: torch.from_numpy(v).to(loop.device) for k, v in b.items()})
                rows.append((float(metrics["loss"]), float(metrics["health_grad_norm"]),
                             {k: v.detach().cpu().clone()
                              for k, v in state_dict_to_flax(m._module).items()}))
            runs[name] = (logits, rows)
        start = {k: v.detach().cpu().clone()
                 for k, v in state_dict_to_flax(_zoo_model(family, "cpu", torch.float32)._module).items()}
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev
    gap = float((runs["card"][0] - runs["cpu"][0]).abs().max())
    print(family, "logits", gap)
    assert gap <= ZOO_F32_LOGIT_ATOL
    lr = ZOO_KNOBS[family]["learning_rate"]
    for step, ((loss_a, gn_a, p_a), (loss_b, gn_b, p_b)) in enumerate(
            zip(runs["card"][1], runs["cpu"][1])):
        for k in [k for k in p_a if k.endswith("/key/bias")]:
            for p in (p_a.pop(k), p_b.pop(k)):
                assert float((p - start[k]).abs().max()) <= lr * (step + 1), k
        num = sum(float(((p_a[k] - p_b[k]) ** 2).sum()) for k in p_a) ** 0.5
        den = sum(float(((p_b[k] - start[k]) ** 2).sum()) for k in p_a) ** 0.5
        r = {"loss_rel": abs(loss_a - loss_b) / loss_b, "grad_norm_rel": abs(gn_a - gn_b) / gn_b,
             "param_rel_l2": num / den}
        print(family, r)
        for key, bound in ZOO_TRAIN_PARITY_TOL.items():
            assert r[key] <= bound, (key, r)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_card_one_member_densenet_pack_is_its_serial_step(cuda, dtype):
    """A one-member DenseNet pack and its serial trial, both captured
    over the same 8 batches resident on the card: params, moments and
    every step's metrics bit for bit (PACK_VS_SERIAL_TOL: exact)."""
    from rafiki_tpu_torch.ops.train import PackedTrainLoop, ResidentFeed, TrainLoop

    m = _zoo_model("densenet", cuda, dtype)
    f = m._loop_fns(*ZOO_ARCH["densenet"][:2])
    bs = _zoo_batches("densenet", 8, 32)
    X = torch.from_numpy(np.concatenate([b["x"] for b in bs])).to(cuda)
    Y = torch.from_numpy(np.concatenate([b["y"] for b in bs])).to(cuda)
    idx = torch.arange(8 * 32, device=cuda).reshape(8, 32)
    loop = TrainLoop(f["init_fn"], f["apply_eval"], f["loss_fn"], f["optimizer"],
                     hyper=f["hyper"], device=cuda)
    loop.state, want = loop.program.train_steps(loop.state, ResidentFeed(X, Y, idx))
    f = m._loop_fns(*ZOO_ARCH["densenet"][:2])
    packed = PackedTrainLoop(f["init_fn"], f["apply_eval"], f["loss_fn"], f["optimizer"],
                             seeds=[0], hypers=[f["hyper"]], device=cuda)
    series = packed.program.train_steps(packed.state, ResidentFeed(X, Y, idx[:, None]))
    module, opt, _, _, _ = loop.state
    st = packed.state
    for (name, p), q in zip(module.named_parameters(), st.params.values()):
        assert torch.equal(p, q[0]), name
    for a, b in zip(opt.mu + opt.nu, st.opt.mu + st.opt.nu):
        assert torch.equal(a, b[0])
    for key, v in want.items():
        assert torch.equal(series[key][:, 0], v), key


@pytest.mark.parametrize("family", ["transformer", "pos_bilstm"])
def test_card_captured_zoo_epoch_matches_eager(cuda, family):
    """12 steps of the Transformer (resident data) and of PosBiLstm (a
    masked corpus fed from the host), eager (``train_step``) and as one
    captured epoch (``train_steps``): params, moments, counts and every
    step's loss and sentinels bit for bit; the captured run replayed."""
    from rafiki_tpu_torch import telemetry
    from rafiki_tpu_torch.ops.graphs import GRAPH_WARMUP_STEPS
    from rafiki_tpu_torch.ops.train import HostFeed, ResidentFeed

    n = 12
    batches = _zoo_batches(family, n, 32)
    eager, captured = _zoo_model(family, cuda), _zoo_model(family, cuda)
    steps = []
    for b in batches:
        eager._loop.state, metrics = eager._loop.program.train_step(
            eager._loop.state, {k: torch.from_numpy(v).to(cuda) for k, v in b.items()})
        steps.append(metrics)
    want = {k: torch.stack([m[k] for m in steps]) for k in steps[0]}
    if family == "transformer":
        X = torch.from_numpy(np.concatenate([b["x"] for b in batches])).to(cuda)
        Y = torch.from_numpy(np.concatenate([b["y"] for b in batches])).to(cuda)
        feed = ResidentFeed(X, Y, torch.arange(n * 32, device=cuda).reshape(n, 32))
    else:
        feed = HostFeed(iter([dict(b) for b in batches]), n, cuda)
    replays = telemetry.get_counter("train.graph_replays")
    loop = captured._loop
    loop.state, got = loop.program.train_steps(loop.state, feed)
    assert telemetry.get_counter("train.graph_replays") - replays == n - GRAPH_WARMUP_STEPS
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    _assert_loops_equal(loop, eager._loop)


def test_card_counted_step_equals_its_cpu_count_and_has_an_mfu(cuda, tmp_path):
    """The profiler's FLOP count of a VGG trial's step on the card equals
    its count on the CPU (the same ops, counted on the first eager step
    of the captured epoch); a counted epoch leaves the card's params
    bit-equal to an uncounted one; on an H100 the program's MFU is
    non-null."""
    from rafiki_tpu_torch.models.vgg import Vgg
    from rafiki_tpu_torch.obs.journal import journal, read_dir
    from rafiki_tpu_torch.obs.perf import profiler

    uri = "synthetic://images?classes=10&n=512&w=32&h=32&c=3&seed=0"
    knobs = dict(SMALL, epochs=2)

    def run(device, journaled):
        profiler.reset()
        if journaled:
            journal.configure(tmp_path / str(device), role="card-test")
        try:
            m = Vgg(device=device, **knobs)
            m.train(uri)
            params = {k: v.detach().cpu() for k, v in m._loop.params.state_dict().items()}
            return params, profiler.snapshot()["programs"]
        finally:
            journal.close()

    counted, progs = run("cuda", True)
    plain, _ = run("cuda", False)
    assert all(torch.equal(counted[k], plain[k]) for k in counted)
    [card] = progs.values()
    _, cpu_progs = run("cpu", True)
    [cpu] = cpu_progs.values()
    assert card["flops"] == cpu["flops"] > 0 and card["steps"] == 512 // 64
    assert card["dtype"] == "bfloat16" and card["device"] == torch.cuda.get_device_name(0)
    recs = [r for r in read_dir(tmp_path / "cuda") if (r["kind"], r["name"]) == ("perf", "step")]
    assert recs and all(r["steps"] == 512 // 64 for r in recs)
    if profiler.card_model(torch.cuda.get_device_name(0)) is not None:
        assert card.get("mfu") is not None and 0 < card["mfu"] < 1


def test_card_capsule_replays_in_a_fresh_process(cuda, tmp_path):
    """A VGG trial (dropout 0.1) NaN-poisoned on the card banks a capsule;
    ``python -m rafiki_tpu_torch.obs replay <capsule> --json`` in a fresh
    process on the card reproduces its bad step bit for bit (8 steps an
    epoch: the bad step is 4, so 5 steps replay, the last 2 captured),
    under the capture's switches. A copy of the capsule with the dropout
    generator reseeded does not reproduce."""
    import json
    import os
    import subprocess
    import sys

    from rafiki_tpu_torch.chaos import FaultPlane, install, uninstall
    from rafiki_tpu_torch.models.vgg import Vgg
    from rafiki_tpu_torch.obs.health import DivergenceError
    from rafiki_tpu_torch.obs.journal import journal

    uri = "synthetic://images?classes=10&n=512&w=32&h=32&c=3&seed=0"
    journal.configure(tmp_path, role="card-test")
    install(FaultPlane.from_spec("seed=3;train.nan:nan:times=1"))
    try:
        with pytest.raises(DivergenceError) as err:
            Vgg(device=cuda, **dict(SMALL, dropout=0.1)).train(uri)
    finally:
        uninstall()
        journal.close()
    cap = err.value.verdict["capsule"]
    assert cap is not None and err.value.verdict["bad_step"] == 4
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "RAFIKI_CHAOS"}
    env["PYTHONPATH"] = repo
    out = subprocess.run([sys.executable, "-m", "rafiki_tpu_torch.obs", "replay", cap, "--json"],
                         cwd=repo, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    verdict = json.loads(out.stdout.strip().splitlines()[-1])
    assert verdict["reproduced"] and verdict["poisoned"] and verdict["steps_replayed"] == 5
    assert verdict["captured_env"] == verdict["replay_env"]
    assert verdict["replay_env"]["device"] == torch.cuda.get_device_name(0)
    assert verdict["comparisons"]["health_bad_loss"]["match"]
    # The loss at the bad step rests on the restored dropout stream: a copy
    # whose generator was reseeded does not reproduce.
    import pickle

    from rafiki_tpu_torch.model.base import GENERATOR_KEY
    from rafiki_tpu_torch.obs.health import capsule

    doc = capsule.load(cap)
    other = torch.Generator(device=cuda).manual_seed(12345).get_state()
    doc[GENERATOR_KEY] = dict(doc[GENERATOR_KEY], state=bytes(other.numpy()))
    changed = tmp_path / "changed.rcap"
    changed.write_bytes(pickle.dumps(doc))
    result = capsule.replay(changed, device=cuda)
    assert not result["reproduced"] and result["mismatches"] == ["health_bad_loss"]


def test_card_width1_nccl_trial_is_the_no_mesh_trial(cuda):
    """A one-rank NCCL group: the dp trial (eager steps, host-formed
    batches, an all-reduce over one rank) ends with the params of the
    captured no-mesh trial, bit for bit."""
    import datetime
    import socket

    import torch.distributed as dist

    from rafiki_tpu_torch.models.vgg import Vgg
    from rafiki_tpu_torch.parallel.mesh import data_parallel_mesh

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", world_size=1,
                            rank=0, timeout=datetime.timedelta(seconds=60),
                            device_id=torch.device("cuda", 0))
    try:
        knobs = dict(SMALL, dropout=0.2)
        uri = "synthetic://images?classes=10&n=512&w=32&h=32&c=3&seed=0"
        out = []
        for mesh in (None, data_parallel_mesh([torch.device("cuda", 0)])):
            m = Vgg(device=cuda, **knobs)
            m.set_mesh(mesh)
            m.train(uri)
            out.append({k: v.detach().cpu() for k, v in m._module.state_dict().items()})
        for k in out[0]:
            assert torch.equal(out[0][k], out[1][k]), k
    finally:
        dist.destroy_process_group()


def test_card_process_job_runs_its_worker_on_the_card(cuda, tmp_path):
    """A ProcessScheduler job of two trials: its worker subprocess runs
    under CUDA_VISIBLE_DEVICES=0 with the GP advisor over HTTP, and the
    stored params serve on the card."""
    from rafiki_tpu_torch.chaos.scenarios import FF_SOURCE, TRAIN, VAL
    from rafiki_tpu_torch.model.base import load_model_class
    from rafiki_tpu_torch.scheduler import ProcessScheduler
    from rafiki_tpu_torch.store import MetaStore, ParamsStore

    from rafiki_tpu_torch.utils.events import events

    store, params = MetaStore(tmp_path / "m.sqlite3"), ParamsStore(tmp_path / "p")
    model = store.create_model("ff", "IMAGE_CLASSIFICATION", None, FF_SOURCE, "ChaosFF")
    job = store.create_train_job("app", "IMAGE_CLASSIFICATION", None, TRAIN, VAL,
                                 {"MODEL_TRIAL_COUNT": 2})
    store.create_sub_train_job(job["id"], model["id"])
    prev = events.path
    events.configure(tmp_path / "logs")
    try:
        res = ProcessScheduler(store, params).run_train_job(job["id"], advisor_kind="gp",
                                                            poll_s=0.2)
        resolved = [(e["device"], e["device_name"]) for e in events.read("worker_device")]
    finally:
        events.close()
        if prev is not None:
            events.configure(prev.parent)
    assert res.status == "COMPLETED", res.errors
    assert [t["status"] for t in res.trials] == ["COMPLETED"] * 2
    # The worker's own record of what it resolved, not the scheduler's row.
    assert resolved == [("cuda:0", torch.cuda.get_device_name(0))]
    best = res.best_trials[0]
    m = load_model_class(FF_SOURCE, "ChaosFF")(device=cuda, **best["knobs"])
    m.load_parameters(params.load(best["params_id"]))
    assert abs(m.evaluate(VAL) - best["score"]) <= 0.02


def test_card_pack_kill_leaves_the_survivor_its_serial_run(cuda):
    """A k=2 pack of the canonical shape (VGG16 w1.0, 32x32x3, batch
    128, bf16 compute) whose member 1 is killed at its first epoch
    boundary (``kill_predicate``): it leaves with reason ``"killed"``, the
    pack's program shrinks to the survivor, and the survivor's float32
    params end bit-equal to its serial trial's on the card."""
    from rafiki_tpu_torch.models.vgg import Vgg

    uri = "synthetic://images?classes=10&n=1024&w=32&h=32&c=3&seed=4&noise=0.35&flip=0.2"
    knobs = dict(depth=16, width_mult=1.0, batch_size=128, epochs=3, seed=0)
    members = [dict(knobs, learning_rate=1e-3, dropout=0.2),
               dict(knobs, learning_rate=3e-2, dropout=0.0)]
    models = [Vgg(device=cuda, **k) for k in members]
    evicted = []
    Vgg.train_packed(models, uri, on_evict=lambda *a: evicted.append(a),
                     kill_predicate=lambda mi, e, m: (mi, e) == (1, 0))
    assert evicted == [(1, 0, "killed")]
    serial = Vgg(device=cuda, **members[0])
    serial.train(uri)
    got = {k: v for k, v in models[0]._module.state_dict().items()}
    want = {k: v for k, v in serial._module.state_dict().items()}
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


def test_card_process_route_equals_the_in_process_route(cuda, tmp_path):
    """k=2 trials served by ``run_inference_worker_process`` children on
    the card over the multiprocessing bus, and by thread workers over
    ``InProcBus``: one microbatch envelope each (one forward per worker
    over the same batch), the same kernels on the same card, so the
    ensembles are equal bit for bit."""
    import multiprocessing as mp

    from rafiki_tpu_torch.bus import InProcBus, make_mp_bus
    from rafiki_tpu_torch.model.base import load_model_class
    from rafiki_tpu_torch.predictor.predictor import Predictor
    from rafiki_tpu_torch.store import MetaStore, ParamsStore
    from rafiki_tpu_torch.worker.inference import InferenceWorker, run_inference_worker_process

    src = b"from rafiki_tpu_torch.models.vgg import Vgg\n\n\nclass CardVgg(Vgg):\n    pass\n"
    store, params = MetaStore(tmp_path / "m.sqlite3"), ParamsStore(tmp_path / "p")
    model = store.create_model("vgg", "IMAGE_CLASSIFICATION", None, src, "CardVgg")
    job = store.create_train_job("app", "IMAGE_CLASSIFICATION", None, "x", "y",
                                 {"MODEL_TRIAL_COUNT": 2})
    sub = store.create_sub_train_job(job["id"], model["id"])
    trials = []
    for m in _models("cpu")[:2]:
        t = store.create_trial(sub["id"], "vgg", SMALL)
        store.mark_trial_as_completed(t["id"], 0.5, params.save(m.dump_parameters()))
        trials.append(store.get_trial(t["id"]))
    queries = np.random.default_rng(2).uniform(0, 1, size=(9, 32, 32, 3)).astype(np.float32)
    queries = queries.tolist()

    def gather(bus, n):
        deadline = time.monotonic() + 120
        while len(bus.get_workers("job")) < n:
            assert time.monotonic() < deadline, "workers never registered"
            time.sleep(0.05)
        report = Predictor(bus, "job", timeout_s=120).predict_batch_detailed(queries)
        assert report.timeouts == 0 and report.hedged == 0 and len(report.replies) == n
        return np.asarray(report.outputs)

    cls = load_model_class(src, "CardVgg")
    models = []
    for t in trials:
        m = cls(device=cuda, **t["knobs"])
        m.load_parameters(params.load(t["params_id"]))
        models.append(m)
    bus = InProcBus()
    workers = [InferenceWorker(bus, "job", f"t{i}", m) for i, m in enumerate(models)]
    threads = [threading.Thread(target=w.run, daemon=True) for w in workers]
    for th in threads:
        th.start()
    try:
        in_process = gather(bus, 2)
    finally:
        for w in workers:
            w.stop()
        for th in threads:
            th.join(timeout=30)
    mp_bus = make_mp_bus()
    procs = []
    try:
        for i, t in enumerate(trials):
            procs.append(mp.get_context("spawn").Process(
                target=run_inference_worker_process,
                args=(mp_bus, str(tmp_path / "m.sqlite3"), str(tmp_path / "p"), t["id"], "job",
                      f"p{i}"), daemon=True))
            procs[-1].start()
        process = gather(mp_bus, 2)
    finally:
        for p in procs:
            p.kill()
            p.join(10)
        mp_bus.close()
    assert process.shape == (9, 10) and np.isfinite(process).all()
    assert np.array_equal(process, in_process)


def test_card_eviction_frees_the_stacked_program_and_reactivation_serves_equal(cuda):
    """A stacked top-3 evicted by the residency manager gives back at
    least 90% of the ``memory_allocated`` bytes its activation took (the
    caching allocator keeps the blocks reserved, so ``memory_reserved``
    is not read), and its re-activation serves the same predictions bit
    for bit."""
    from rafiki_tpu_torch.parallel.serving import build_stacked
    from rafiki_tpu_torch.tenancy import ResidencyManager

    def loader():
        stacked, reason = build_stacked([{"model_name": "vgg"}] * 3, _models(cuda),
                                        batch_size=64)
        assert stacked is not None, reason
        return stacked

    class _Nothing:
        def predict(self, queries):
            return [None for _ in queries]

    q = np.random.default_rng(4).uniform(0, 1, size=(5, 32, 32, 3)).astype(np.float32).tolist()
    warm = loader()  # this thread's cuBLAS workspace and cuDNN state, once
    warm.predict(q)
    warm.destroy()
    del warm
    rm = ResidencyManager(budget_bytes=100)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    first = rm.activate("a", 60, loader)
    torch.cuda.synchronize()
    took = torch.cuda.memory_allocated() - before
    want = first.predict(q)
    del first
    rm.activate("b", 60, _Nothing)  # evicts "a"
    torch.cuda.synchronize()
    freed = before + took - torch.cuda.memory_allocated()
    assert took > 0 and freed >= 0.9 * took, (took, freed)
    again = rm.activate("a", 60, loader)  # evicts "b"
    assert rm.resident_keys() == ["a"]
    assert again.predict(q) == want
    rm.drain()


# A template that synchronizes the card in ``evaluate`` and ``destroy``,
# as chip_smoke.py's BENCH_SRC does: a synchronize on another thread
# while an epoch's step is being captured can invalidate that capture.
SYNC_SRC = b'''
import torch

from rafiki_tpu_torch.models.vgg import Vgg


class SyncVgg(Vgg):
    def evaluate(self, dataset_uri):
        score = super().evaluate(dataset_uri)
        torch.cuda.synchronize()
        return score

    def destroy(self):
        super().destroy()
        torch.cuda.synchronize()
'''
#: Many short epochs (the knob's most): each epoch captures its step anew, so the trial
#: opens a capture window about every 40 steps.
SHARED_TRAIN = dict(SMALL, epochs=10)
SHARED_URI = "synthetic://images?classes=10&n=2560&w=32&h=32&c=3&seed=0&noise=0.35&flip=0.2"


def _serving_store(tmp_path, src=SYNC_SRC, name="SyncVgg"):
    """A meta store with three completed SMALL VGG trials of ``src`` (one
    sub job) and a params store with their blobs."""
    from rafiki_tpu_torch.models.vgg import Vgg
    from rafiki_tpu_torch.store import MetaStore, ParamsStore

    store = MetaStore(tmp_path / "meta.sqlite3")
    params = ParamsStore(tmp_path / "params")
    model = store.create_model("vgg", "IMAGE_CLASSIFICATION", None, src, name)
    tj = store.create_train_job("app", "IMAGE_CLASSIFICATION", None, "x", "y", {})
    sub = store.create_sub_train_job(tj["id"], model["id"])
    trials = []
    for seed in range(3):
        m = Vgg(device="cpu", **SMALL)
        m.init_parameters(10, (32, 32, 3), torch.Generator().manual_seed(seed))
        t = store.create_trial(sub["id"], "vgg", SMALL)
        store.mark_trial_as_completed(t["id"], 0.5, params.save(m.dump_parameters(), f"t{seed}"))
        trials.append(store.get_trial(t["id"]))
    return store, params, trials


def test_card_a_trial_trains_while_inference_jobs_start_and_stop(cuda, tmp_path, monkeypatch):
    """A captured VGG trial trains on one thread while the services
    manager creates and stops a stacked and a replicated inference job
    on the same card, again and again; the jobs' templates synchronize
    in ``destroy``. The trial completes, and its params equal an
    unshared run's byte for byte: the dedicated route loads, stacks and
    destroys its models under ``ops/graphs.py card_lock``, so no
    synchronize lands inside an epoch's capture."""
    from rafiki_tpu_torch.admin.services_manager import ServicesManager
    from rafiki_tpu_torch.model.base import load_model_class

    cls = load_model_class(SYNC_SRC, "SyncVgg")

    def train():
        m = cls(device=cuda, **SHARED_TRAIN)
        m.train(SHARED_URI)
        blob = m.dump_parameters()
        m.destroy()
        return blob

    alone = train()
    store, params, trials = _serving_store(tmp_path)
    mgr = ServicesManager(store, params, device=cuda)
    out, errors = {}, []

    def trainer():
        try:
            out["blob"] = train()
        except BaseException as e:  # reported below
            errors.append(repr(e))

    th = threading.Thread(target=trainer, name="shared-trial")
    th.start()
    cycles = 0
    try:
        while th.is_alive() or cycles < 4:
            for stacked in (True, False):
                monkeypatch.setenv("RAFIKI_STACKED_SERVING", "1" if stacked else "0")
                job = store.create_inference_job(trials[0]["id"], None)["id"]
                mgr.create_inference_services(job, trials)
                mgr.stop_inference_services(job)
            cycles += 1
    finally:
        th.join(timeout=600)
        mgr.stop_all()
    assert not th.is_alive() and errors == [], errors
    assert cycles >= 4
    assert out["blob"] == alone, f"the shared trial's params differ after {cycles} cycles"


def _scaled_job(cuda, tmp_path):
    """A stacked top-3 job served on the card by a services manager with
    an autoscaler attached but not started (its lane is driven by hand).
    Returns (manager, job id, handle, lane)."""
    from rafiki_tpu_torch.admin.services_manager import ServicesManager

    store, params, trials = _serving_store(tmp_path)
    mgr = ServicesManager(store, params, device=cuda)
    job = store.create_inference_job(trials[0]["id"], None)["id"]
    mgr.create_inference_services(job, trials)
    ctl = mgr.attach_autoscaler(job, min_workers=1, max_workers=2, start=False)
    handle = mgr._inference_jobs[job]
    assert handle.stacked_route and len(handle.workers) == 1
    return mgr, job, handle, ctl._actuators["inference"]


def test_card_a_scale_up_replica_answers_as_the_base_replica_bit_for_bit(cuda, tmp_path):
    """A scale-up replica of a stacked job is loaded, stacked and
    captured anew on the card; its answers to the same queries equal the
    base replica's bit for bit, and it registers on the job's bus."""
    mgr, job, handle, lane = _scaled_job(cuda, tmp_path)
    try:
        lane.scale_to(2)
        base, replica = handle.workers
        assert replica.worker_id in mgr.bus.get_workers(job)
        q = np.random.default_rng(6).uniform(0, 1, size=(64, 32, 32, 3)).astype(np.float32)
        got = np.asarray(replica.model.predict(q.tolist()))
        want = np.asarray(base.model.predict(q.tolist()))
        assert got.shape == (64, 10) and np.isfinite(got).all()
        assert np.array_equal(got, want)
    finally:
        mgr.stop_all()


def test_card_a_drained_scale_up_replica_gives_back_its_memory(cuda, tmp_path):
    """Once a first replica has come and gone (the serving thread's own
    state is then built), a replica's spawn and drain leave the card's
    ``memory_allocated`` within 1 MiB of its value before the spawn, in
    the drained, reaped, freed order."""
    mgr, job, handle, lane = _scaled_job(cuda, tmp_path)
    try:
        lane.scale_to(2)
        lane.scale_to(1)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        lane.scale_to(2)
        torch.cuda.synchronize()
        grown = torch.cuda.memory_allocated() - before
        lane.scale_to(1)
        torch.cuda.synchronize()
        left = torch.cuda.memory_allocated() - before
        assert grown > 0 and left <= 1 << 20, (grown, left)
        wid = f"{job[:8]}-as1"
        assert [e for e in lane.events if e[1] == wid] == [
            ("drained", wid), ("reaped", wid), ("freed", wid)]
        assert len(handle.workers) == 1
    finally:
        mgr.stop_all()
