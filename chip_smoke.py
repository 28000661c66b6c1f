#!/usr/bin/env python3
"""Smoke run of the PyTorch port's serving and training paths on one
CUDA card.

    python3 chip_smoke.py                  # from the root of a checkout
    python3 chip_smoke.py --bf16-readings  # the readings behind BF16_GAP_ATOL

Drives ``rafiki_tpu_torch`` the way a user serves a top-k ensemble,
the way a tuning job runs and the way a trial trains, at the full width
of the bench's canonical model (VGG16, width_mult=1.0, 32x32x3 inputs,
10 classes).

Serving, k=3 trials of random weights, batch 64:

  1. the card's identity (``nvidia-smi`` name and power limit);
  2. three seeded trials: ``init_parameters`` -> ``dump_parameters``
     (bf16 RTPK1 blobs) -> ``load_parameters`` into fresh CUDA models;
  3. forward parity: each trial's float32 forward, card vs CPU, and
     each bf16 forward against the float32 forward on its own device,
     over two query sets;
  4. serving through InProcBus + InferenceWorker threads + Predictor:
     64 single-query requests and 64-query bursts, once through the
     stacked route (one vmapped forward over the 3 trials) and once
     through the replicated route (one worker per trial). Every worker
     must serve every query without an error; both routes agree with
     each other and with the CPU ensemble;
  5. timings (warmup, p50/p99 latency at 1 and 64 queries, queries/s,
     peak device memory) and a device profile of the same models'
     forwards (CUDA events and ``torch.profiler``), each with the
     card's name and power limit.

Training, the bench's canonical job and trial (VGG16 w1.0, one epoch of
the 50k-image synthetic task, bf16 compute):

  6. tune_job: the bench's canonical train job (``bench.py``
     ``run_real_loop``) through the port's entry points: a ``BenchVgg``
     template uploaded with ``MetaStore.create_model``, a job of
     TUNE_TRIALS trials, ``LocalScheduler.run_train_job(n_workers=1,
     advisor_kind="gp")`` on the card, params in a ``ParamsStore``. One
     line per trial (knobs, status, score, seconds) in completion order,
     then one for the job (wall seconds, completed trials per hour, the
     cold trial, the advisor's and the saver's seconds, device memory).
     Fails unless the job COMPLETED, every ERRORED trial is a contained
     divergence, the GP proposed from expected improvement, the best
     score reaches TUNE_TOP1_TARGET and the memory left after each trial
     does not grow;
  7. the job's top-2 trials' stored blobs loaded into serving models
     and stacked: each trial's served argmax accuracy on the eval set
     against the score ``evaluate`` stored for it;
  8. one canonical trial (batch 128, dropout 0.1, lr 1e-3) through
     ``train -> evaluate -> dump_parameters``: every epoch's loss finite
     and no ``DivergenceError``, eval accuracy above ACC_FLOOR, and a
     device profile of 20 warm train steps, with the Adam and sentinel
     ranges' device time apart;
  9. FeedForward at its widest knobs (3 x 256, batch 128) trained and
     evaluated;
 10. card-vs-CPU training parity: three float32 steps (TF32 off,
     dropout 0) of VGG16 w1.0 from the same params on both devices;
     loss, the sentinel norms and the params after each step.

The service, as a user drives it (phase ``service_journey``):

 11. the admin server started through ``admin.app.serve`` (what
     ``python -m rafiki_tpu_torch serve`` runs) on the card, on a free
     loopback port, over a fresh data dir; with the port's ``Client``:
     log in, upload BENCH_SRC, a JOURNEY_TRIALS-trial GP train job on
     the canonical task, then an inference job over its top 2 (the
     stacked route); JOURNEY_1Q requests of one query and JOURNEY_64Q of
     64 POSTed to the published predictor host (client p50/p99 and the
     server's split: JSON decode, gateway, JSON encode), the HTTP
     predictions for JOURNEY_IMAGES eval images against an in-process
     stacked ensemble of the same stored blobs (JOURNEY_ATOL) and their
     accuracy; then the job again with microbatching, under
     MB_THREADS x MB_REQUESTS concurrent single-query requests; then
     everything stopped, and the memory allocated on the card back
     within TUNE_LEAK_BYTES of its reading before the inference job.

The port has no hand-written kernel yet (the JAX package has no Pallas
kernel to port), so the kernel line is ``{"kernels": []}``. The last
line is ``{"ok": true, "device": {...}}``. Any failed phase exits
nonzero before it; without a CUDA device the script exits 1 at once.

``--bf16-readings`` runs only the forward-parity measurement, over 16
other trial seeds and 4 other query sets, and prints the readings.
"""

from __future__ import annotations

import json
import subprocess
import sys
import threading
import time

import numpy as np

K = 3
BATCH = 64
N_SINGLE = 64
N_BURSTS = 8
QUERY_SETS = 2
PROFILE_ITERS = 20
INPUT_SHAPE = (32, 32, 3)
NUM_CLASSES = 10
KNOBS = dict(depth=16, width_mult=1.0, dropout=0.0, learning_rate=1e-3,
             batch_size=BATCH, epochs=1, seed=0)
# The float32 build of the same network, card vs CPU, TF32 off: only the
# summation order differs, through 13 conv layers. This is the check
# that the card computes the same function as the CPU path.
F32_ATOL = 1e-4
# One trial's bf16 forward against the float32 forward of the same
# params on the same device, and the card's bf16 forward against the
# CPU's (probabilities, max abs). Each bound is 1.25x the largest of
# the readings that ``--bf16-readings`` takes (16 other trial seeds x 4
# other query sets), rounded up to 1e-3: 5.6e-3 (bf16 vs float32, on
# the CPU) and 5.5e-3 (card vs CPU) on an H100; PERF.md gives them all.
BF16_GAP_ATOL = 7e-3
BF16_CARD_VS_CPU_ATOL = 7e-3
# The served k=3 ensemble against the ensemble of the CPU forwards: the
# mean over trials halves the rounding spread of a single forward.
ENSEMBLE_ATOL = 5e-3
# Stacked vs replicated on the card: the vmapped forward runs grouped
# convs, for which cuDNN may choose other algorithms than for the k
# plain convs, so the routes agree to bf16 rounding, not bit for bit.
ROUTE_ATOL = 5e-3

# -- training -----------------------------------------------------------------
TRAIN_KNOBS = dict(depth=16, width_mult=1.0, dropout=0.1, learning_rate=1e-3,
                   batch_size=128, epochs=1, seed=0)
TRIAL_SEEDS = (0,)
# The bench's canonical task (bench.py CANON_TRAIN and run_real_loop):
# noise 0.35 and 20% of labels flipped, so a perfect classifier scores
# 0.8 + 0.2 / 10 = 0.82.
TRAIN_URI = "synthetic://images?classes=10&n=50000&w=32&h=32&c=3&seed=0&noise=0.35&flip=0.2"
EVAL_URI = "synthetic://images?classes=10&n=10000&w=32&h=32&c=3&seed=1&noise=0.35&flip=0.2"
# Readings (H100, the first run of this phase): 0.8231 for all three
# trials, which is this eval set's ceiling: every trial labels every
# example by its class template, and the errors are the flipped labels.
# The floor leaves 0.04 below it; the bench's own target is 0.70.
ACC_FLOOR = 0.78
# A trial's served accuracy (its bf16-stored blob, through the stacked
# vmapped forward) against the accuracy ``evaluate`` reported (the
# trained float32 params through the serial forward). Readings: equal
# for all three trials. The bound allows 20 flips of 10,000 near-ties.
SERVED_ACC_ATOL = 0.002
# The bench's canonical job (bench.py BENCH_MODEL_SRC and run_real_loop):
# VGG16 w1.0 for one epoch, tuning dropout, the learning rate and the
# batch size. Ten trials take the GP past its 8 warm-up proposals.
TUNE_TRIALS = 10
TUNE_TOP1_TARGET = 0.70  # bench.py _scale: the top-1 gate off the CPU
# The memory allocated once a trial has evaluated (its own model
# resident, the previous trial's destroyed), last trial against first.
TUNE_LEAK_BYTES = 64 << 20
BENCH_SRC = b'''
import torch

from rafiki_tpu_torch.model.knobs import CategoricalKnob, FixedKnob, FloatKnob
from rafiki_tpu_torch.models.vgg import Vgg


class BenchVgg(Vgg):
    """Canonical-trial VGG16: fixed arch, tunable lr/dropout/batch."""

    #: torch.cuda.memory_allocated() once each trial has evaluated, and
    #: once each trial's model is destroyed (on the params saver's thread).
    evaluated_bytes = []
    destroyed_bytes = []

    @staticmethod
    def get_knob_config():
        return {
            "depth": FixedKnob(16),
            "width_mult": FixedKnob(1.0),
            "dropout": FloatKnob(0.0, 0.5),
            "learning_rate": FloatKnob(1e-4, 3e-2, is_exp=True),
            "batch_size": CategoricalKnob([64, 128, 256], affects_shape=True),
            "epochs": FixedKnob(1),
            "seed": FixedKnob(0),
        }

    def evaluate(self, dataset_uri):
        score = super().evaluate(dataset_uri)
        torch.cuda.synchronize()
        BenchVgg.evaluated_bytes.append(torch.cuda.memory_allocated())
        return score

    def destroy(self):
        super().destroy()
        torch.cuda.synchronize()
        BenchVgg.destroyed_bytes.append(torch.cuda.memory_allocated())
'''
FF_KNOBS = dict(hidden_layers=3, hidden_units=256, learning_rate=1e-3, batch_size=128,
                epochs=3, seed=0)
FF_TRAIN_URI = "synthetic://images?classes=10&n=2048&seed=0"
FF_EVAL_URI = "synthetic://images?classes=10&n=512&seed=1"
# Reading: 1.0 (the 28x28x1 default task separates easily).
FF_ACC_FLOOR = 0.95
PARITY_STEPS = 3
PARITY_BATCH = 8
# Card vs CPU, float32 with TF32 off, after each of PARITY_STEPS steps
# (warmup 1 step, so lr 1e-3 from the first). Readings (H100, the
# first run, max over the 3 steps): loss 8.0e-6 rel, grad norm 8.5e-5,
# update norm 3.6e-4, param norm 1.0e-5, params 6.8e-3 of the distance
# they moved (2.9e-3 max abs: Adam moves an element whose gradient is
# rounding noise by up to lr either way). The forward agrees to 1e-6;
# the gradients less closely, as cuDNN's backward algorithms sum in
# other orders. Bounds: about 3x the readings.
PARITY_TOL = {"loss_rel": 3e-5, "health_grad_norm_rel": 3e-4,
              "health_update_norm_rel": 1e-3, "health_param_norm_rel": 3e-5,
              "param_rel_l2": 2e-2}
# -- the service journey -------------------------------------------------------
JOURNEY_TRIALS = 3
JOURNEY_1Q = 50
JOURNEY_64Q = 20
JOURNEY_IMAGES = 512
# HTTP predictions against the in-process stacked ensemble of the same
# stored blobs on the card: the same forward on the same padded chunks,
# and JSON carries float32 values exactly, so they should be equal; the
# bound allows a float32 ulp of a probability.
JOURNEY_ATOL = 1e-5
MB_THREADS = 16
MB_REQUESTS = 8
MB_GATEWAY = {"max_batch": 8, "max_batch_wait_ms": 5}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def card_identity():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0 or not out.stdout.strip():
        fail(f"nvidia-smi: rc={out.returncode} {out.stderr.strip()}")
    line = out.stdout.strip().splitlines()[0]
    name, limit = (s.strip() for s in line.split(",", 1))
    return line, name, limit


def percentile_ms(xs, q):
    return float(np.percentile(np.asarray(xs) * 1e3, q))


def queries_for(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.uniform(0, 1, size=(BATCH,) + INPUT_SHAPE).astype(np.float32)


def make_blob(seed: int) -> bytes:
    import torch

    from rafiki_tpu_torch.models.vgg import Vgg

    m = Vgg(**KNOBS)
    m.init_parameters(NUM_CLASSES, INPUT_SHAPE, torch.Generator().manual_seed(seed))
    blob = m.dump_parameters()
    m.destroy()
    return blob


def load(blobs, device=None, knobs=KNOBS):
    from rafiki_tpu_torch.models.vgg import Vgg

    out = []
    for b in blobs:
        m = Vgg(device=device, **knobs)
        m.load_parameters(b)
        out.append(m)
    return out


def f32_twin(model):
    """The same params in the float32 build of the network, on the
    model's device."""
    import torch

    from rafiki_tpu_torch.models.vgg import _Vgg

    mod = _Vgg(KNOBS["depth"], KNOBS["width_mult"], NUM_CLASSES, INPUT_SHAPE,
               dtype=torch.float32)
    mod.load_state_dict(model._module.state_dict())
    return mod.to(model.device).eval()


def forward_readings(blob: bytes, query_seeds):
    """One trial on the card and on the CPU, over several query sets.
    Returns the per-query-set readings and the bf16 probabilities of
    each device on each query set."""
    from rafiki_tpu_torch.ops.train import predict_proba

    models = {"cpu": load([blob], "cpu")[0], "card": load([blob])[0]}
    twins = {name: f32_twin(m) for name, m in models.items()}
    readings, probs = [], []
    for qs in query_seeds:
        x = queries_for(qs)
        p = {name: (m.predict_proba(x), predict_proba(twins[name], x, BATCH, m.device))
             for name, m in models.items()}
        for name, (bf16, _) in p.items():
            if bf16.shape != (BATCH, NUM_CLASSES) or not np.isfinite(bf16).all():
                fail(f"{name} forward gave shape {bf16.shape} or non-finite values")
        readings.append({
            "query_seed": qs,
            "f32_card_vs_cpu": float(np.abs(p["card"][1] - p["cpu"][1]).max()),
            "bf16_vs_f32_card": float(np.abs(p["card"][0] - p["card"][1]).max()),
            "bf16_vs_f32_cpu": float(np.abs(p["cpu"][0] - p["cpu"][1]).max()),
            "bf16_card_vs_cpu": float(np.abs(p["card"][0] - p["cpu"][0]).max()),
        })
        probs.append({name: bf16 for name, (bf16, _) in p.items()})
    return readings, probs


def bf16_readings() -> int:
    """The measurement behind BF16_GAP_ATOL: seeds and query sets apart
    from the ones the smoke serves."""
    import torch

    card = card_identity()
    print(card[0])
    rows = []
    for seed in range(100, 116):
        readings, _ = forward_readings(make_blob(seed), range(100, 104))
        rows += [dict(r, trial_seed=seed) for r in readings]
        torch.cuda.empty_cache()
    summary = {"phase": "bf16_readings", "card": card[1], "power_limit": card[2],
               "trials": 16, "query_sets": 4, "bf16_gap_atol": BF16_GAP_ATOL,
               "bf16_card_vs_cpu_atol": BF16_CARD_VS_CPU_ATOL}
    for key in ("bf16_vs_f32_card", "bf16_vs_f32_cpu", "bf16_card_vs_cpu", "f32_card_vs_cpu"):
        xs = np.asarray([r[key] for r in rows])
        summary[key] = {"max": float(xs.max()), "p50": float(np.median(xs)),
                        "p90": float(np.percentile(xs, 90))}
    print(json.dumps(rows))
    print(json.dumps(summary))
    return 0


# -- device profile -----------------------------------------------------------

def _event_ms(fn, iters: int) -> float:
    """Mean device milliseconds of ``fn`` over ``iters`` back-to-back runs."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _union_us(ranges) -> float:
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(ranges):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def device_profile(fn, top: int = 6):
    """Where one forward's device time goes: CUDA-event ms, and under
    ``torch.profiler`` the device's busy time and idle share, kernel
    launches, and the costliest operators, per forward."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    iters = PROFILE_ITERS
    with torch.inference_mode():
        for _ in range(3):
            fn()
        event_ms = _event_ms(fn, iters)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = _union_us([(e.time_range.start, e.time_range.end) for e in kernels])

    def device_us(avg) -> float:
        # torch >= 2.4 names it device_time_total; older releases cuda_time_total.
        return float(getattr(avg, "device_time_total", None)
                     or getattr(avg, "cuda_time_total", 0.0))

    ops = sorted(((a.key, device_us(a)) for a in prof.key_averages()
                  if device_us(a) > 0 and not a.key.startswith("cuda")),
                 key=lambda kv: -kv[1])
    return {
        "event_ms": event_ms,
        "device_busy_ms": busy_us / iters / 1e3,
        "device_idle_share": 1.0 - busy_us / wall_us,
        "kernel_launches": len(kernels) / iters,
        "top_ops_device_ms": {k: v / iters / 1e3 for k, v in ops[:top]},
    }


# -- serving ------------------------------------------------------------------

def serve(models, queries, label, card):
    """One route: worker threads on a fresh bus, then the timed requests.
    Fails unless every worker served every query without an error and
    every reply came back. Returns (per-query outputs of the single
    requests, burst outputs, timing dict)."""
    import torch

    from rafiki_tpu_torch import telemetry
    from rafiki_tpu_torch.bus.queues import InProcBus
    from rafiki_tpu_torch.predictor.predictor import Predictor
    from rafiki_tpu_torch.worker.inference import InferenceWorker

    def check_counters(n_queries: int, phase: str) -> dict:
        snap = telemetry.snapshot()
        c = snap["counters"]
        got = {k: c.get(k, 0) for k in ("inference.batch_errors", "predictor.query_timeouts",
                                         "predictor.hedged_gathers")}
        got["inference.queries_served"] = c.get("inference.queries_served", 0)
        want = {"inference.batch_errors": 0, "predictor.query_timeouts": 0,
                "predictor.hedged_gathers": 0,
                "inference.queries_served": len(workers) * n_queries}
        if got != want:
            fail(f"{label} ({phase}): counters {got}, expected {want}")
        return snap

    telemetry.reset()
    bus = InProcBus()
    workers = [InferenceWorker(bus, f"job-{label}", f"{label}-{i}", m, batch_size=BATCH)
               for i, m in enumerate(models)]
    threads = [threading.Thread(target=w.run, name=w.worker_id, daemon=True)
               for w in workers]
    for t in threads:
        t.start()
    try:
        deadline = time.monotonic() + 60
        while len(bus.get_workers(f"job-{label}")) < len(workers):
            if time.monotonic() > deadline:
                fail(f"{label}: workers did not register")
            time.sleep(0.01)
        pred = Predictor(bus, f"job-{label}", timeout_s=120)
        # One untimed request: pays the first-call costs of a route that
        # has no warmup() of its own (the replicated workers).
        t0 = time.monotonic()
        pred.predict(queries[:1])
        first_s = time.monotonic() - t0
        check_counters(1, "first request")
        telemetry.reset()
        singles, lat1 = [], []
        for q in queries[:N_SINGLE]:
            t0 = time.monotonic()
            singles.append(pred.predict([q])[0])
            lat1.append(time.monotonic() - t0)
        bursts, lat64 = [], []
        for _ in range(N_BURSTS):
            t0 = time.monotonic()
            bursts.append(pred.predict(queries[:BATCH]))
            lat64.append(time.monotonic() - t0)
    finally:
        for w in workers:
            w.stop()
        for t in threads:
            t.join(timeout=30)
    if any(t.is_alive() for t in threads):
        fail(f"{label}: worker threads did not stop")
    for out in singles + [o for b in bursts for o in b]:
        if isinstance(out, dict):
            fail(f"{label}: a request failed: {out}")
    torch.cuda.synchronize()
    snap = check_counters(N_SINGLE + N_BURSTS * BATCH, "timed requests")
    fwd = snap["spans"]["inference.forward"]
    timing = {
        "route": label, "card": card[1], "power_limit": card[2],
        "workers": len(models), "first_request_s": first_s,
        "p50_ms_1q": percentile_ms(lat1, 50), "p99_ms_1q": percentile_ms(lat1, 99),
        "p50_ms_64q": percentile_ms(lat64, 50), "p99_ms_64q": percentile_ms(lat64, 99),
        "queries_per_s_1q": len(lat1) / sum(lat1),
        "queries_per_s_64q": BATCH * len(lat64) / sum(lat64),
        # Where a request's time went: worker forwards (summed over the
        # workers, which run side by side) against all request time.
        "forward_calls": fwd["count"], "forward_s_total": fwd["total_s"],
        "request_s_total": sum(lat1) + sum(lat64),
        "pop_batch_mean": snap["histograms"]["bus.pop_batch_size"]["mean"],
        "queries_served": snap["counters"]["inference.queries_served"],
    }
    return np.asarray(singles, np.float64), [np.asarray(b, np.float64) for b in bursts], timing


# -- training -----------------------------------------------------------------


def _synced_s(t0: float) -> float:
    import torch

    torch.cuda.synchronize()
    return time.monotonic() - t0


def train_trials(card):
    """Phase 8: the canonical trial, for each of TRIAL_SEEDS. It runs
    after the tune job, which loaded the same datasets, so its epoch is
    a warm one. Returns the phase's readings, the trained models and
    their serving blobs."""
    import torch

    from rafiki_tpu_torch.model.dataset import dataset_utils
    from rafiki_tpu_torch.model.log import logger
    from rafiki_tpu_torch.models.vgg import Vgg

    train_ds, eval_ds = dataset_utils.load(TRAIN_URI), dataset_utils.load(EVAL_URI)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    trials, models, blobs = [], [], []
    for seed in TRIAL_SEEDS:
        m = Vgg(**TRAIN_KNOBS)
        m._seed = seed  # the seed knob is fixed at 0; trials differ in their seed
        logs = []
        t0 = time.monotonic()
        with logger.capture(logs.append):
            m.train(TRAIN_URI)
        train_s = _synced_s(t0)
        t0 = time.monotonic()
        acc = m.evaluate(EVAL_URI)
        eval_s = _synced_s(t0)
        epochs = [e["values"] for e in logs if e["type"] == "values"]
        trials.append({"seed": seed, "train_s": train_s, "evaluate_s": eval_s,
                       "eval_acc": acc, "epochs": epochs})
        blobs.append(m.dump_parameters())
        models.append(m)
    steps = train_ds.size // TRAIN_KNOBS["batch_size"]
    epoch_s = float(np.mean([t["train_s"] for t in trials]))
    out = {
        "phase": "train_vgg", "card": card[1], "power_limit": card[2],
        "knobs": TRAIN_KNOBS, "train_uri": TRAIN_URI, "eval_uri": EVAL_URI,
        "train_examples": train_ds.size, "eval_examples": eval_ds.size,
        "steps_per_epoch": steps, "trials": trials,
        # One epoch per trial, after the tune job: datasets resident and
        # cuDNN's choices for batch 128 made.
        "epoch_s": epoch_s, "step_ms": epoch_s / steps * 1e3,
        "train_images_per_s": steps * TRAIN_KNOBS["batch_size"] / epoch_s,
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
    }
    return out, models, blobs


def _bench_class():
    """The BenchVgg class the scheduler loaded from BENCH_SRC."""
    from rafiki_tpu_torch.models.vgg import Vgg

    loaded = [c for c in Vgg.__subclasses__() if c.__name__ == "BenchVgg"]
    if len(loaded) != 1:
        fail(f"expected the scheduler to load BenchVgg once, found {len(loaded)}")
    return loaded[0]


def tune_job(card):
    """Phase 6: the bench's canonical train job through the port's entry
    points, in a temporary directory. Returns the per-trial lines in
    completion order, the job line, and the top-2 trials with their
    stored blobs."""
    import gc
    import shutil
    import tempfile

    import torch

    from rafiki_tpu_torch import telemetry
    from rafiki_tpu_torch.model.dataset import dataset_utils
    from rafiki_tpu_torch.scheduler import LocalScheduler
    from rafiki_tpu_torch.store import MetaStore, ParamsStore

    tmp = tempfile.mkdtemp(prefix="rafiki-tune-")
    try:
        store = MetaStore(f"{tmp}/meta.sqlite3")
        params = ParamsStore(f"{tmp}/params")
        model = store.create_model("bench-vgg", "IMAGE_CLASSIFICATION", None, BENCH_SRC, "BenchVgg")
        job = store.create_train_job("bench", "IMAGE_CLASSIFICATION", None, TRAIN_URI, EVAL_URI,
                                     {"MODEL_TRIAL_COUNT": TUNE_TRIALS})
        store.create_sub_train_job(job["id"], model["id"])
        telemetry.reset()
        # Earlier phases' reference cycles (worker threads, the bus) hold
        # card memory until the collector runs: free it before reading.
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        result = LocalScheduler(store, params).run_train_job(
            job["id"], n_workers=1, advisor_kind="gp")
        wall = _synced_s(t0)
        peak = torch.cuda.max_memory_allocated()
        snap = telemetry.snapshot()
        best = [dict(t, blob=params.load(t["params_id"])) for t in result.best_trials]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    cls = _bench_class()
    n_train = dataset_utils.load(TRAIN_URI).size
    train_s = {r["tags"]["trial_id"]: r["dur_s"] for r in telemetry.span_records()
               if r["name"] == "trial.train"}
    done = sorted((t for t in result.trials if t.get("stopped_at")), key=lambda t: t["stopped_at"])
    trials = []
    for t in done:
        bs = t["knobs"]["batch_size"]
        steps = n_train // bs
        row = {"phase": "tune_trial", "no": t["no"], "knobs": t["knobs"], "status": t["status"],
               "score": t["score"], "trial_s": t["stopped_at"] - t["started_at"],
               "batch_size": bs, "train_s": train_s.get(t["id"]),
               "error": (t["error"] or "")[:200] or None}
        if row["train_s"]:
            row["step_ms"] = row["train_s"] / steps * 1e3
        trials.append(row)
    completed = [t for t in trials if t["status"] == "COMPLETED"]
    spans = snap["spans"]
    by_bs = {}
    for t in completed:
        by_bs.setdefault(t["batch_size"], []).append(t["trial_s"])
    line = {
        "phase": "tune_job", "card": card[1], "power_limit": card[2],
        "status": result.status, "trials": len(trials), "completed": len(completed),
        "errored": len(trials) - len(completed), "job_wall_s": wall,
        "scheduler_duration_s": result.duration_s,
        "completed_trials_per_hour": 3600.0 * len(completed) / wall,
        "cold_trial_s": trials[0]["trial_s"] if trials else None,
        "trial_s_by_batch_size": {str(k): v for k, v in sorted(by_bs.items())},
        "best_score": max((t["score"] for t in completed), default=None),
        "top1_target": TUNE_TOP1_TARGET,
        "advisor_propose_s_total": spans.get("trial.advisor_propose", {}).get("total_s"),
        "advisor_proposals": spans.get("trial.advisor_propose", {}).get("count"),
        "persist_s_total": spans.get("trial.persist", {}).get("total_s"),
        "trial_total_s_total": spans.get("trial.total", {}).get("total_s"),
        # The worker's time outside its trials and proposals: the
        # advisor's feedback (the GP refits there), store writes, and the
        # wait for the last save.
        "outside_trials_s": wall - spans.get("trial.total", {}).get("total_s", 0.0)
        - spans.get("trial.advisor_propose", {}).get("total_s", 0.0),
        "gp_warmup_proposals": snap["counters"].get("advisor.gp_warmup_proposals", 0),
        "gp_ei_proposals": snap["counters"].get("advisor.gp_ei_proposals", 0),
        "max_memory_allocated_bytes": peak,
        "evaluated_memory_allocated_bytes": list(cls.evaluated_bytes),
        "destroyed_memory_allocated_bytes": list(cls.destroyed_bytes),
        "errors": result.errors,
    }
    return trials, line, best


def served_accuracy(trials, card):
    """Phase 7: the tune job's top trials' stored blobs loaded into
    serving models, stacked, and run over the eval set: each trial's
    argmax accuracy through the stacked route's forward, against the
    score the job stored for it, and the ensemble's."""
    import torch

    from rafiki_tpu_torch.model.dataset import dataset_utils
    from rafiki_tpu_torch.models.vgg import Vgg
    from rafiki_tpu_torch.parallel.serving import build_stacked
    from rafiki_tpu_torch.predictor.ensemble import renormalize_probs

    ds = dataset_utils.load(EVAL_URI)
    models = []
    for t in trials:
        m = Vgg(**t["knobs"])
        m.load_parameters(t["blob"])
        models.append(m)
    bs = TRAIN_KNOBS["batch_size"]
    stacked, reason = build_stacked([{"model_name": "BenchVgg"}] * len(models), models,
                                    batch_size=bs)
    if stacked is None:
        fail(f"stacked route refused the trained trials: {reason}")
    hits = np.zeros(len(models), np.int64)
    ens_hits = 0
    t0 = time.monotonic()
    with torch.inference_mode():
        for start in range(0, ds.size, bs):
            xt = torch.from_numpy(ds.x[start:start + bs]).cuda()
            probs = stacked._ens.forward(xt).float().cpu().numpy()  # (k, B, C)
            y = ds.y[start:start + bs]
            hits += (probs.argmax(-1) == y[None, :]).sum(axis=1)
            ens = renormalize_probs(np.mean(probs, axis=0))
            ens_hits += int((ens.argmax(-1) == y).sum())
    serve_s = _synced_s(t0)
    stacked.destroy()
    served = (hits / ds.size).tolist()
    evaluated = [t["score"] for t in trials]
    return {"phase": "served_vs_evaluated", "card": card[1], "power_limit": card[2],
            "trials": [t["no"] for t in trials], "evaluated_acc": evaluated,
            "served_acc": served, "abs_diff": [abs(a - b) for a, b in zip(served, evaluated)],
            "ensemble_acc": ens_hits / ds.size, "serve_s": serve_s,
            "served_acc_atol": SERVED_ACC_ATOL}


def train_ff(card):
    """Phase 9: FeedForward at its widest knobs."""
    from rafiki_tpu_torch.model.log import logger
    from rafiki_tpu_torch.models.ff import FeedForward

    m = FeedForward(**FF_KNOBS)
    logs = []
    t0 = time.monotonic()
    with logger.capture(logs.append):
        m.train(FF_TRAIN_URI)
    train_s = _synced_s(t0)
    acc = m.evaluate(FF_EVAL_URI)
    reloaded = FeedForward(**FF_KNOBS)
    reloaded.load_parameters(m.dump_parameters())
    return {"phase": "train_ff", "card": card[1], "power_limit": card[2], "knobs": FF_KNOBS,
            "train_uri": FF_TRAIN_URI, "eval_uri": FF_EVAL_URI, "train_s": train_s,
            "epochs": [e["values"] for e in logs if e["type"] == "values"],
            "eval_acc": acc, "reloaded_eval_acc": reloaded.evaluate(FF_EVAL_URI)}


def _f32_vgg_class():
    from rafiki_tpu_torch.models.vgg import Vgg, _Vgg

    class VggF32(Vgg):
        """The canonical network with float32 compute."""

        def build_module(self, num_classes, input_shape):
            import torch

            return _Vgg(int(self.knobs["depth"]), float(self.knobs["width_mult"]), num_classes,
                        input_shape, dtype=torch.float32, dropout=float(self.knobs["dropout"]))

    return VggF32


def training_parity(card):
    """Phase 10: PARITY_STEPS float32 train steps (TF32 off, dropout 0)
    from the same params on the card and on the CPU. Returns the
    readings after each step."""
    import torch

    from rafiki_tpu_torch.convert import state_dict_to_flax
    from rafiki_tpu_torch.obs.health import sentinel

    cls = _f32_vgg_class()
    knobs = dict(TRAIN_KNOBS, dropout=0.0)
    rng = np.random.default_rng(7)
    batches = [{"x": rng.uniform(0, 1, size=(PARITY_BATCH,) + INPUT_SHAPE).astype(np.float32),
                "y": rng.integers(0, NUM_CLASSES, size=PARITY_BATCH).astype(np.int32)}
               for _ in range(PARITY_STEPS)]
    runs = {}
    for name, device in (("card", "cuda"), ("cpu", "cpu")):
        m = cls(device=device, **knobs)
        m._planned_steps = PARITY_STEPS
        m.init_parameters(NUM_CLASSES, INPUT_SHAPE)  # the same seeded CPU draw on both
        loop, rows = m._loop, []
        start = {k: v.detach().cpu().clone() for k, v in state_dict_to_flax(m._module).items()}
        for b in batches:
            batch = {k: torch.from_numpy(v).to(loop.device) for k, v in b.items()}
            loop.state, metrics = loop.program.train_step(loop.state, batch)
            rows.append({"loss": float(metrics["loss"]),
                         **{k: float(v) for k, v in sentinel.split(metrics)[1].items()},
                         "params": {k: v.detach().cpu().clone()
                                    for k, v in state_dict_to_flax(m._module).items()}})
        runs[name] = rows
    steps = []
    for card_row, cpu_row in zip(runs["card"], runs["cpu"]):
        a, b = card_row["params"], cpu_row["params"]
        num = sum(float(((a[k] - b[k]) ** 2).sum()) for k in a) ** 0.5
        den = sum(float(((b[k] - start[k]) ** 2).sum()) for k in a) ** 0.5
        r = {"loss_rel": abs(card_row["loss"] - cpu_row["loss"]) / abs(cpu_row["loss"]),
             "param_max_abs": max(float((a[k] - b[k]).abs().max()) for k in a),
             "param_rel_l2": num / den,
             "nonfinite": (card_row["health_nonfinite"], cpu_row["health_nonfinite"])}
        for k in ("health_grad_norm", "health_update_norm", "health_param_norm"):
            r[k + "_rel"] = abs(card_row[k] - cpu_row[k]) / abs(cpu_row[k])
        steps.append(r)
    return {"phase": "train_parity", "card": card[1], "power_limit": card[2],
            "model": f"VGG{knobs['depth']} w{knobs['width_mult']} float32",
            "batch": PARITY_BATCH, "steps": steps,
            "tolerance": PARITY_TOL}


def train_step_profile(model, card):
    """Phase 8, after the trial: where a warm train step's device time
    goes, over PROFILE_ITERS steps of a trained canonical trial on fresh
    batches gathered from the resident dataset, as the epoch does."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from rafiki_tpu_torch.model.dataset import dataset_utils
    from rafiki_tpu_torch.ops.train import get_device_dataset

    loop = model._loop
    X, Y = get_device_dataset(dataset_utils.load(TRAIN_URI), loop.device)
    bs = TRAIN_KNOBS["batch_size"]
    idx = torch.randperm(X.shape[0], generator=torch.Generator().manual_seed(0))
    idx = idx[: (2 * PROFILE_ITERS + 3) * bs].reshape(-1, bs).to(loop.device)
    it = iter(idx)

    def step():
        ib = next(it)
        loop.state, _ = loop.program.train_step(loop.state, {"x": X.index_select(0, ib),
                                                             "y": Y.index_select(0, ib)})

    for _ in range(3):
        step()
    event_ms = _event_ms(step, PROFILE_ITERS)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILE_ITERS):
            step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    # The step's record_function ranges also show on the device timeline
    # as user annotations spanning their kernels; they are no kernels.
    kernels = [e for e in prof.events() if e.device_type == cuda
               and not getattr(e, "is_user_annotation", False) and not e.name.startswith("train.")]
    busy_us = _union_us([(e.time_range.start, e.time_range.end) for e in kernels])
    kernel_us = sum(e.time_range.end - e.time_range.start for e in kernels)
    n = PROFILE_ITERS

    def under(e):
        """The device kernels launched by a CPU event and its children."""
        out = list(e.kernels)
        for child in e.cpu_children:
            out += under(child)
        return out

    # The forward, Adam and sentinel ranges are recorded in the step
    # itself (ops/train.py); the backward runs on autograd's own thread,
    # so its kernels are what the ranges leave of the total.
    parts = {}
    for name in ("train.forward", "train.adam", "train.sentinel"):
        evs = [e for e in prof.events() if e.name == name and e.device_type == cpu]
        ks = [k for e in evs for k in under(e)]
        parts[name[6:]] = {"device_ms": sum(k.duration for k in ks) / n / 1e3,
                           "launches": len(ks) / n,
                           "host_ms": sum(e.cpu_time_total for e in evs) / n / 1e3}
    parts["backward"] = {
        "device_ms": kernel_us / n / 1e3 - sum(p["device_ms"] for p in parts.values()),
        "launches": len(kernels) / n - sum(p["launches"] for p in parts.values()),
        "host_ms": event_ms - sum(p["host_ms"] for p in parts.values())}

    def self_device_us(a) -> float:
        # torch >= 2.4 names it self_device_time_total.
        return float(getattr(a, "self_device_time_total", None)
                     or getattr(a, "self_cuda_time_total", 0.0))

    ops = sorted(((a.key, self_device_us(a)) for a in prof.key_averages()
                  if self_device_us(a) > 0 and not a.key.startswith("train.")),
                 key=lambda kv: -kv[1])
    return {"phase": "train_step_profile", "card": card[1], "power_limit": card[2],
            "steps": n, "batch": bs, "event_ms_per_step": event_ms,
            "device_busy_ms_per_step": busy_us / n / 1e3,
            "device_idle_share": 1.0 - busy_us / wall_us,
            "kernel_launches_per_step": len(kernels) / n,
            # host_ms of the backward: the step's CUDA-event time less the
            # host time of the three ranges.
            "per_part": parts,
            "top_ops_self_device_ms_per_step": {k[:80]: v / n / 1e3 for k, v in ops[:10]}}


# -- the service journey --------------------------------------------------------


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _get_json(url: str):
    import urllib.request

    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    with opener.open(url, timeout=60) as r:
        return json.loads(r.read())


def _span_p50_ms(records, name: str):
    xs = [r["dur_s"] for r in records if r["name"] == name]
    return percentile_ms(xs, 50) if xs else None


def _serving_counters(host: str, phase: str) -> dict:
    """The predictor's telemetry: fail on a worker error or a timed-out
    query (the inference worker answers a failing forward with an
    error reply and the manager's startup wait goes on regardless, so
    the counters are what shows a fault)."""
    snap = _get_json(f"http://{host}/metrics")
    c = snap["counters"]
    bad = {k: c.get(k, 0) for k in ("inference.batch_errors", "predictor.query_timeouts")}
    if any(bad.values()):
        fail(f"service_journey ({phase}): {bad}")
    return snap


def service_journey(card):
    """Phase 11: the user's journey through the port's service on the
    card. Returns the phase's line."""
    import gc
    import shutil
    import tempfile
    from pathlib import Path

    import torch

    from rafiki_tpu_torch import telemetry
    from rafiki_tpu_torch.admin.app import serve
    from rafiki_tpu_torch.client import Client
    from rafiki_tpu_torch.config import Config, get_config, set_config
    from rafiki_tpu_torch.model.base import load_model_class
    from rafiki_tpu_torch.model.dataset import dataset_utils
    from rafiki_tpu_torch.parallel.serving import build_stacked
    from rafiki_tpu_torch.predictor.ensemble import ensemble_predictions
    from rafiki_tpu_torch.store import MetaStore
    from rafiki_tpu_torch.utils.events import events

    line = {"phase": "service_journey", "card": card[1], "power_limit": card[2]}
    tmp = Path(tempfile.mkdtemp(prefix="rafiki-journey-"))
    prev_config = get_config()
    cfg = Config(data_dir=tmp / "data")
    set_config(cfg)
    port = _free_port()
    stop = threading.Event()
    server = threading.Thread(target=serve, name="journey-admin", daemon=True,
                              kwargs=dict(host="127.0.0.1", port=port, device="cuda",
                                          stop_event=stop))
    t_phase = time.monotonic()
    server.start()
    try:
        # -- 1. the server answers --------------------------------------------
        client = Client(admin_port=port, timeout_s=300)
        deadline = time.monotonic() + 60
        while True:
            try:
                _get_json(f"http://127.0.0.1:{port}/healthz")
                break
            except OSError:
                if time.monotonic() > deadline or not server.is_alive():
                    fail("service_journey: the admin server never answered")
                time.sleep(0.1)
        store = MetaStore(cfg.db_path)

        # -- 2. train through the REST API ------------------------------------
        client.login(cfg.superadmin_email, cfg.superadmin_password)
        (tmp / "bench_vgg.py").write_bytes(BENCH_SRC)
        client.create_model("bench-vgg", "IMAGE_CLASSIFICATION", tmp / "bench_vgg.py",
                            "BenchVgg")
        t0 = time.monotonic()
        client.create_train_job("journey", "IMAGE_CLASSIFICATION", TRAIN_URI, EVAL_URI,
                                {"MODEL_TRIAL_COUNT": JOURNEY_TRIALS}, advisor_kind="gp")
        job = client.wait_until_train_job_has_stopped("journey", timeout=900, poll_s=0.5)
        line["train_job_s"] = time.monotonic() - t0
        trials = client.get_trials_of_train_job("journey")
        line["train_job_status"] = job["status"]
        line["trials"] = [{"no": t["no"], "status": t["status"], "score": t["score"],
                           "batch_size": t["knobs"]["batch_size"],
                           "error": (t["error"] or "")[:200] or None} for t in trials]
        completed = [t for t in trials if t["status"] == "COMPLETED"]
        if job["status"] != "COMPLETED" or len(completed) < 2:
            fail(f"service_journey: train job {job['status']}, {len(completed)} trials "
                 f"completed: {line['trials']}")
        for t in trials:
            if t["status"] == "ERRORED" and not (t["error"] or "").startswith("diverged:"):
                fail(f"service_journey: trial {t['no']} errored, not a contained "
                     f"divergence: {t['error']}")

        # -- 3. serve through the REST API ------------------------------------
        gc.collect()
        torch.cuda.synchronize()
        mem_before = torch.cuda.memory_allocated()
        t0 = time.monotonic()
        inf = client.create_inference_job("journey", max_models=2)
        line["create_inference_job_s"] = time.monotonic() - t0
        host = inf["predictor_host"]
        routes = [e for e in events.read("inference_route") if e.get("job_id") == inf["id"]]
        line["route"] = routes[-1] if routes else None
        rows = store.get_services_of_job(inf["id"])
        if inf["status"] != "RUNNING" or not host:
            fail(f"service_journey: inference job {inf}")
        if not routes or routes[-1]["route"] != "stacked":
            fail(f"service_journey: the job was not served stacked: {routes}")
        if not rows or any(r["status"] == "ERRORED" for r in rows):
            fail(f"service_journey: inference service rows {rows}")

        # -- 4. predict over HTTP ---------------------------------------------
        ds = dataset_utils.load(EVAL_URI)
        x = ds.x[:JOURNEY_IMAGES]
        singles = [x[i:i + 1].tolist() for i in range(JOURNEY_1Q)]
        bursts = [x[(i * BATCH) % JOURNEY_IMAGES:][:BATCH].tolist() for i in range(JOURNEY_64Q)]
        t0 = time.monotonic()
        client.predict_via_predictor(host, singles[0])
        line["first_request_s"] = time.monotonic() - t0
        _serving_counters(host, "first request")
        for label, reqs in (("1q", singles), ("64q", bursts)):
            telemetry.reset()
            lat = []
            for q in reqs:
                t0 = time.monotonic()
                out = client.predict_via_predictor(host, q)
                lat.append(time.monotonic() - t0)
                if len(out) != len(q) or any(isinstance(p, dict) for p in out):
                    fail(f"service_journey: a {label} request failed: {out[:2]}")
            _serving_counters(host, f"{label} requests")
            records = telemetry.span_records()
            line[f"client_p50_ms_{label}"] = percentile_ms(lat, 50)
            line[f"client_p99_ms_{label}"] = percentile_ms(lat, 99)
            line[f"server_p50_ms_{label}"] = {
                name: _span_p50_ms(records, name)
                for name in ("predictor_http.decode", "predictor_http.rows",
                             "gateway.predict", "predictor_http.encode",
                             "inference.forward")}
        line["request_body_bytes_64q"] = len(json.dumps({"queries": bursts[0]}))
        http_probs = np.asarray(
            [p for i in range(0, JOURNEY_IMAGES, BATCH)
             for p in client.predict_via_predictor(host, x[i:i + BATCH].tolist())], np.float64)
        # The same two stored blobs, stacked in-process on the card, and
        # gathered as the predictor gathers the stacked worker's reply.
        best = client.get_best_trials_of_train_job("journey", max_count=2)
        cls = load_model_class(BENCH_SRC, "BenchVgg")
        models = []
        for t in best:
            m = cls(device="cuda", **t["knobs"])
            m.load_parameters(client.get_trial_parameters(t["id"]))
            models.append(m)
        ref_model, reason = build_stacked(best, models, batch_size=BATCH)
        if ref_model is None:
            fail(f"service_journey: the reference ensemble did not stack: {reason}")
        ref = np.asarray([ensemble_predictions([p]) for i in range(0, JOURNEY_IMAGES, BATCH)
                          for p in ref_model.predict(x[i:i + BATCH].tolist())], np.float64)
        ref_model.destroy()
        del models, ref_model
        line["http_vs_in_process_max_abs"] = float(np.abs(http_probs - ref).max())
        line["http_top1"] = float((http_probs.argmax(-1) == ds.y[:JOURNEY_IMAGES]).mean())
        line["top1_target"] = TUNE_TOP1_TARGET
        if http_probs.shape != (JOURNEY_IMAGES, NUM_CLASSES) or not np.isfinite(http_probs).all():
            fail(f"service_journey: HTTP predictions of shape {http_probs.shape} or non-finite")
        if line["http_vs_in_process_max_abs"] > JOURNEY_ATOL:
            fail(f"service_journey: HTTP vs in-process ensemble "
                 f"{line['http_vs_in_process_max_abs']} > {JOURNEY_ATOL}")
        if line["http_top1"] < TUNE_TOP1_TARGET:
            fail(f"service_journey: top-1 {line['http_top1']} < {TUNE_TOP1_TARGET}")

        # -- 5. microbatching ---------------------------------------------------
        client.stop_inference_job("journey")
        inf = client.create_inference_job("journey", max_models=2, gateway=MB_GATEWAY)
        host = inf["predictor_host"]
        telemetry.reset()
        answers, errors = {}, []
        lock = threading.Lock()

        def fire(k: int) -> None:
            for j in range(MB_REQUESTS):
                i = k * MB_REQUESTS + j
                try:
                    out = client.predict_via_predictor(host, x[i:i + 1].tolist())
                    with lock:
                        answers[i] = out[0]
                except Exception as e:  # counted and failed on below
                    with lock:
                        errors.append(repr(e))

        t0 = time.monotonic()
        threads = [threading.Thread(target=fire, args=(k,)) for k in range(MB_THREADS)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
        mb_wall = time.monotonic() - t0
        n_req = MB_THREADS * MB_REQUESTS
        snap = _serving_counters(host, "microbatched requests")
        stats = _get_json(f"http://{host}/gateway")
        sizes = snap["histograms"].get("serving.microbatch.size", {})
        got = np.asarray([answers[i] for i in sorted(answers)], np.float64)
        line["microbatch"] = {
            "requests": n_req, "answered": len(answers), "errors": errors[:3],
            "wall_s": mb_wall, "requests_per_s": len(answers) / mb_wall,
            "shed_total": stats["shed_total"], "timeouts": stats["timeouts"],
            "batches": sizes.get("count"), "mean_batch": sizes.get("mean"),
            "max_batch": sizes.get("max"), "gateway": MB_GATEWAY,
            "flushes": {r: snap["counters"].get(f"serving.microbatch.flush_{r}", 0)
                        for r in ("size", "deadline", "drain")},
            "vs_in_process_max_abs": (float(np.abs(got - ref[:n_req]).max())
                                      if len(answers) == n_req else None)}
        mb = line["microbatch"]
        if errors or len(answers) != n_req or stats["shed_total"] or stats["timeouts"]:
            fail(f"service_journey: microbatched requests {mb}")
        if not sizes or not (sizes["max"] > 1 and sizes["mean"] > 1):
            fail(f"service_journey: no batch of more than one member: {mb}")
        if mb["vs_in_process_max_abs"] > JOURNEY_ATOL:
            fail(f"service_journey: microbatched predictions disagree: {mb}")

        # -- 6. stop, and the card's memory ---------------------------------
        client.stop_inference_job("journey")
        gc.collect()
        torch.cuda.synchronize()
        mem_after = torch.cuda.memory_allocated()
        line["memory_allocated_before_serving"] = mem_before
        line["memory_allocated_after_stop"] = mem_after
        # Not gated: what is left once cuBLAS frees the workspaces it
        # keeps per handle (a new thread that multiplies takes one).
        clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
        if clear is not None:
            clear()
            line["memory_allocated_after_clearing_cublas_workspaces"] = \
                torch.cuda.memory_allocated()
        if mem_after > mem_before + TUNE_LEAK_BYTES:
            fail(f"service_journey: {mem_after} bytes allocated after the inference jobs "
                 f"stopped, {mem_before} before them (+{TUNE_LEAK_BYTES} allowed)")
        store.close()
    finally:
        stop.set()
        server.join(timeout=120)
        set_config(prev_config)
        shutil.rmtree(tmp, ignore_errors=True)
    if server.is_alive():
        fail("service_journey: the admin server did not stop")
    line["phase_s"] = time.monotonic() - t_phase
    return line


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card", file=sys.stderr)
        return 1
    # The float32 reference forward must be full float32 on the card too
    # (cuDNN runs float32 convs in TF32 by default). The served bf16
    # path is unaffected by these flags.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if sys.argv[1:] == ["--bf16-readings"]:
        return bf16_readings()
    if sys.argv[1:]:
        fail(f"unknown arguments {sys.argv[1:]}")
    card = card_identity()
    print(card[0])
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    failures = []

    def check(ok: bool, msg: str) -> None:
        if not ok:
            failures.append(msg)
            print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)

    from rafiki_tpu_torch.ops.train import predict
    from rafiki_tpu_torch.parallel.serving import build_stacked
    from rafiki_tpu_torch.predictor.ensemble import ensemble_predictions

    # -- 2. trials -------------------------------------------------------------
    blobs = [make_blob(seed) for seed in range(K)]
    print(f"trials: {K} x VGG{KNOBS['depth']} width_mult={KNOBS['width_mult']}, "
          f"blobs of {len(blobs[0])} bytes (bf16 RTPK1)")

    # -- 3. forward parity, card vs CPU ----------------------------------------
    readings, served_probs = [], []  # served_probs: query set 0, per trial
    for b in blobs:
        r, p = forward_readings(b, range(QUERY_SETS))
        readings += r
        served_probs.append(p[0])
    fwd = {key: max(r[key] for r in readings) for key in readings[0] if key != "query_seed"}
    print(json.dumps(dict(fwd, phase="forward_parity", trials=K, query_sets=QUERY_SETS,
                          card=card[1], power_limit=card[2], f32_atol=F32_ATOL,
                          bf16_gap_atol=BF16_GAP_ATOL,
                          bf16_card_vs_cpu_atol=BF16_CARD_VS_CPU_ATOL)))
    check(fwd["f32_card_vs_cpu"] <= F32_ATOL,
          f"float32 forward, card vs CPU: {fwd['f32_card_vs_cpu']} > {F32_ATOL}")
    for dev in ("card", "cpu"):
        got = fwd[f"bf16_vs_f32_{dev}"]
        check(got <= BF16_GAP_ATOL, f"bf16 vs float32 forward on the {dev}: "
                                    f"{got} > {BF16_GAP_ATOL}")
    check(fwd["bf16_card_vs_cpu"] <= BF16_CARD_VS_CPU_ATOL,
          f"bf16 forward, card vs CPU: {fwd['bf16_card_vs_cpu']} > {BF16_CARD_VS_CPU_ATOL}")
    cpu_ens = np.asarray([ensemble_predictions([p["cpu"][i].tolist() for p in served_probs])
                          for i in range(BATCH)], np.float64)
    qarr = queries_for(0)
    queries = qarr.tolist()
    x_card = torch.from_numpy(qarr).cuda()

    # -- 4. serving, both routes, and the device profile of each ---------------
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    stacked, reason = build_stacked([{"model_name": "vgg"}] * K, load(blobs), batch_size=BATCH)
    if stacked is None:
        fail(f"stacked route refused: {reason}")
    warmup_s = stacked.warmup()
    s_single, s_bursts, s_time = serve([stacked], queries, "stacked", card)
    s_time["warmup_s"] = warmup_s
    s_time["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
    s_time["device_profile"] = device_profile(lambda: stacked._ens.forward(x_card))
    stacked.destroy()

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    replicas = load(blobs)
    r_single, r_bursts, r_time = serve(replicas, queries, "replicated", card)
    r_time["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
    r_time["device_profile"] = device_profile(
        lambda: [predict(m._module, x_card) for m in replicas])

    n = len(s_single)  # the single requests asked the first n queries
    errs = {
        "stacked_vs_replicated": float(np.abs(s_single - r_single).max()),
        "stacked_vs_cpu_ensemble": float(np.abs(s_single - cpu_ens[:n]).max()),
        "replicated_vs_cpu_ensemble": float(np.abs(r_single - cpu_ens[:n]).max()),
        "burst_vs_single": max(float(np.abs(b[:n] - s_single).max())
                               for b in s_bursts + r_bursts),
    }
    print(json.dumps(s_time))
    print(json.dumps(r_time))
    print(json.dumps(dict(errs, phase="route_parity", card=card[1], power_limit=card[2],
                          route_atol=ROUTE_ATOL, cpu_atol=ENSEMBLE_ATOL)))
    for name, got in (("stacked", s_single), ("replicated", r_single)):
        check(got.shape == (N_SINGLE, NUM_CLASSES) and bool(np.isfinite(got).all()),
              f"{name}: outputs of shape {got.shape} or non-finite")
        check(float(np.abs(got.sum(-1) - 1.0).max()) <= 1e-5,
              f"{name}: ensembled probabilities do not sum to 1")
    check(errs["stacked_vs_replicated"] <= ROUTE_ATOL and errs["burst_vs_single"] <= ROUTE_ATOL,
          f"routes disagree: {errs}")
    check(max(errs["stacked_vs_cpu_ensemble"], errs["replicated_vs_cpu_ensemble"])
          <= ENSEMBLE_ATOL, f"served ensemble disagrees with the CPU ensemble: {errs}")

    replicas = None

    # -- 6.-7. the canonical tune job, and its top-2 served --------------------
    from rafiki_tpu_torch.obs.health import DivergenceError

    tune_rows, job, best = tune_job(card)
    for row in tune_rows:
        print(json.dumps(row))
    print(json.dumps(job))
    check(job["status"] == "COMPLETED" and job["trials"] == TUNE_TRIALS and not job["errors"],
          f"tune job: {job['status']}, {job['trials']} trials, errors {job['errors']}")
    for row in tune_rows:
        check(row["status"] == "COMPLETED" or (row["error"] or "").startswith("diverged:"),
              f"tune trial {row['no']}: {row['status']} and not a contained divergence: "
              f"{row['error']}")
    check(job["gp_ei_proposals"] >= 1, f"tune job: no proposal from expected improvement {job}")
    check(job["best_score"] is not None and job["best_score"] >= TUNE_TOP1_TARGET,
          f"tune job: best score {job['best_score']} < {TUNE_TOP1_TARGET}")
    ev = job["evaluated_memory_allocated_bytes"]
    check(len(ev) == job["completed"] and ev and ev[-1] <= ev[0] + TUNE_LEAK_BYTES,
          f"tune job: memory allocated after the last trial {ev[-1:]} > after the first "
          f"{ev[:1]} + {TUNE_LEAK_BYTES}")
    check(len(best) == 2, f"tune job: {len(best)} completed trials to serve, expected 2")
    served = served_accuracy(best, card)
    print(json.dumps(served))
    check(max(served["abs_diff"]) <= SERVED_ACC_ATOL,
          f"served accuracy disagrees with the stored score: {served}")
    del best
    torch.cuda.empty_cache()

    # -- 8.-10. one canonical trial, FeedForward, card-vs-CPU parity -----------
    try:
        vgg, trained, _ = train_trials(card)
    except DivergenceError as e:
        fail(f"canonical trial diverged: {e.verdict}")
    print(json.dumps(vgg))
    for t in vgg["trials"]:
        check(all(np.isfinite(ep["loss"]) for ep in t["epochs"]),
              f"trial seed {t['seed']}: non-finite loss {t['epochs']}")
        check(t["eval_acc"] >= ACC_FLOOR,
              f"trial seed {t['seed']}: eval accuracy {t['eval_acc']} < {ACC_FLOOR}")
    profile_row = train_step_profile(trained[0], card)
    print(json.dumps(profile_row))
    del trained
    torch.cuda.empty_cache()
    try:
        ff = train_ff(card)
    except DivergenceError as e:
        fail(f"FeedForward trial diverged: {e.verdict}")
    print(json.dumps(ff))
    check(all(np.isfinite(ep["loss"]) for ep in ff["epochs"]), f"FeedForward: non-finite loss {ff}")
    check(ff["eval_acc"] >= FF_ACC_FLOOR, f"FeedForward: eval accuracy {ff['eval_acc']} < {FF_ACC_FLOOR}")
    check(ff["reloaded_eval_acc"] == ff["eval_acc"], f"FeedForward: reloaded blob scores otherwise {ff}")
    parity = training_parity(card)
    print(json.dumps(parity))
    for i, r in enumerate(parity["steps"]):
        check(r["nonfinite"] == (0.0, 0.0), f"parity step {i}: non-finite {r}")
        for key, bound in PARITY_TOL.items():
            check(r[key] <= bound, f"parity step {i}: {key} {r[key]} > {bound}")

    # -- 11. the service journey ----------------------------------------------
    torch.cuda.empty_cache()
    print(json.dumps(service_journey(card)))

    # -- kernels and the result line -------------------------------------------
    print(json.dumps({"kernels": []}))
    if failures:
        print(f"chip_smoke: {len(failures)} check(s) failed", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
