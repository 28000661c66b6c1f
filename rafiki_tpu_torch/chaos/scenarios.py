"""The recovery scenario catalog.

The port's own copy of ``rafiki_tpu/chaos/scenarios.py``: the registry,
its helpers, TorchModel counterparts of ``ChaosFF`` and ``EvictFF``,
and the seventeen scenarios whose planes the port has, each with the JAX
package's spec, checks (by name) and vacuous-pass rejection. Each is a
declarative bundle: a ``RAFIKI_CHAOS`` fault spec, extra environment,
and a body that stands up a real cluster (sqlite meta store, params
store, bus, thread or subprocess workers), lets the injected faults
land and checks the recovery invariants through ``check()``. The
runner (``runner.py``) owns env install and teardown, telemetry, the
journal, the device scope and reporting. Trials train on the runner's
device (``utils.backend.resolve_device()``: the card unless the CPU
was asked for).

=============================  =============================================
checkpoint-write-failure       every checkpoint write errors; the trial
                               still completes (resumability lost, work
                               kept) and the failure is counted
straggler-quorum               one of three serving replicas stuck 3s per
                               forward; quorum gather answers fast without
                               timeout errors, hedging past the straggler
drain-under-load               gateway drain under background load with
                               injected frontend latency: flushes inflight,
                               sheds new work as ``draining``
predictor-outage-surfaces      every bus heartbeat skipped: the bounded
                               stale-lease grace serves through a hiccup,
                               then a real outage raises RuntimeError
pack-straggler-evict           one pack member early-stops epochs before
                               its mates: it is evicted from the stacked
                               state mid-pack, its slot backfilled with a
                               freshly proposed trial, and the evictee
                               bit-matches a serial early-stopped run
nan-trial-contained            member 2 of a k=4 pack gets one step's
                               grads NaN-poisoned: the divergence is
                               detected at the epoch boundary, a replay
                               capsule banked and bit-verified, the sick
                               member evicted and ERRORED with a
                               diagnosis, and the three survivors
                               complete with params bit-matching
                               unfaulted serial runs
noisy-neighbor-shed            an aggressor tenant floods a tenant-aware
                               gateway while every forward pays 60 ms:
                               weighted-fair admission sheds the aggressor
                               (``tenant_quota``), the gold victim is never
                               shed and its p99 stays inside 200 ms, read
                               from the ``tenant/*`` journals alone
=============================  =============================================

and three that SIGKILL subprocess workers of the ``ProcessScheduler``
(``collective-kill-mid-step`` trains at width 2, one device per rank, so
on the card it needs two):

=============================  =============================================
kill-mid-trial-resume          worker SIGKILLs itself after epoch 1 of a
                               3-epoch trial; the respawned ``-r1`` worker
                               adopts and resumes it from its checkpoint
kill-mid-pack-resume           a k=4 pack SIGKILLed after epoch 1: all four
                               members resume serially from their slice
                               checkpoints, params bit-matching serial runs
collective-kill-mid-step       a rank of a width-2 dp group SIGKILLed at its
                               epoch's collective.step site; the group is
                               respawned and every rank resumes the orphan
                               from its checkpoint
=============================  =============================================

and six that drive the mesh sweep (``scheduler/mesh.py``), its chips
(or group members) sharing the runner's device; the last three SIGKILL
the sweep's supervisor process (``scheduler/sweep_proc.py``) and resume
the sweep in a fresh one (``SUBPROCESS_SCENARIOS`` holds all six that
kill a process):

=============================  =============================================
mesh-chip-loss-repack          chip 1 of a 2-chip sweep preempted mid-pack:
                               its RUNNING rows re-packed onto chip 0 and
                               resumed, params bit-matching serial runs
chip-loss-mid-sharded-trial    member 1 of a width-2 sharded group
                               preempted: manifest durable, group re-formed
                               at width 1, reshard-on-restore, params
                               bit-matching the serial trial
mesh-degrades-single-chip      every collective.init attempt fails: the
                               sweep degrades to one chip and completes
supervisor-kill-mid-sweep      the supervisor SIGKILLed mid-sweep;
                               resume_sweep reconciles the WAL, adopts the
                               orphans and ends with the unfaulted run's
                               best score and knob set
host-loss-mid-sweep            host 1 (chips 2, 3) lost and re-packed, then
                               host 0 with the supervisor; resume finishes
                               the budget with a clean WAL
early-kill-mid-pack-resume     the supervisor SIGKILLed just after the
                               learning-curve predictor killed a pack
                               member, with its pack-mate's speculative
                               score still uncorrected in the GP; the
                               advisor rehydrates twice to the same
                               proposals, and resume ends with the
                               unfaulted kill-on run's best score and
                               knob set
=============================  =============================================

and one that SIGKILLs a spawned inference worker over the
multiprocessing bus (in ``SUBPROCESS_SCENARIOS`` too):

=============================  =============================================
stacked-worker-loss-fallback   the stacked worker (the whole top-k in one
                               process) kills itself on its second
                               forward: the fallback supervisor degrades
                               the job to per-trial thread workers and the
                               gateway's blackout re-route answers every
                               request
=============================  =============================================

The JAX package's other 2 scenarios, of autoscale, wait for the plane
they drive (ROADMAP Queue 1 item 14).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional

# check(name, ok, detail): the invariant-recording callback the runner
# passes into every scenario body.
CheckFn = Callable[..., None]


@dataclasses.dataclass
class Scenario:
    name: str
    description: str
    spec: str                      # RAFIKI_CHAOS value for the run
    fn: Callable[..., None]        # fn(tmp: Path, check: CheckFn)
    env: Dict[str, str] = dataclasses.field(default_factory=dict)


SCENARIOS: Dict[str, Scenario] = {}

#: The scenarios that SIGKILL a subprocess: the ProcessScheduler's
#: workers, the sweep supervisor's process (``sweep_proc``), or a spawned
#: stacked inference worker.
SUBPROCESS_SCENARIOS = frozenset({"kill-mid-trial-resume", "kill-mid-pack-resume",
                                  "collective-kill-mid-step", "supervisor-kill-mid-sweep",
                                  "host-loss-mid-sweep", "early-kill-mid-pack-resume",
                                  "stacked-worker-loss-fallback"})


def scenario(name: str, description: str, spec: str,
             env: Optional[Dict[str, str]] = None):
    def register(fn):
        SCENARIOS[name] = Scenario(name=name, description=description,
                                   spec=spec, fn=fn, env=dict(env or {}))
        return fn
    return register


# ---------------------------------------------------------------------------
# Shared fixtures
# ---------------------------------------------------------------------------

# A 3-epoch MLP whose only shape knob is fixed: every proposal shares a
# packing key (k trials stack into one program), and ``seed`` defaults to
# 0, so a fresh model with a trial's knobs retrains bit for bit: the
# reference run the invariants compare against.
FF_SOURCE = b"""
from rafiki_tpu_torch.model.base import TorchModel
from rafiki_tpu_torch.model.knobs import FixedKnob, FloatKnob
from rafiki_tpu_torch.models.ff import _Mlp

class ChaosFF(TorchModel):
    @staticmethod
    def get_knob_config():
        return {
            "hidden_units": FixedKnob(16),
            "learning_rate": FloatKnob(1e-3, 3e-2, is_exp=True),
            "batch_size": FixedKnob(32),
            "epochs": FixedKnob(3),
        }

    def build_module(self, num_classes, input_shape):
        return _Mlp(hidden_layers=1, hidden_units=int(self.knobs["hidden_units"]),
                    num_classes=num_classes, input_shape=input_shape)
"""

TRAIN = "synthetic://images?classes=5&n=128&w=8&h=8&seed=0"
VAL = "synthetic://images?classes=5&n=64&w=8&h=8&seed=1"

JOB = "chaosjob"


def _device():
    """The runner's device (the thread's default)."""
    from rafiki_tpu_torch.utils.backend import resolve_device

    return resolve_device(None)


def _train_env(tmp):
    from rafiki_tpu_torch.store import MetaStore, ParamsStore

    store = MetaStore(tmp / "meta.sqlite3")
    params = ParamsStore(tmp / "params")
    model = store.create_model("chaosff", "IMAGE_CLASSIFICATION", None,
                               FF_SOURCE, "ChaosFF")
    return store, params, model


def _make_job(store, model, budget):
    job = store.create_train_job("chaosapp", "IMAGE_CLASSIFICATION", None,
                                 TRAIN, VAL, budget)
    store.create_sub_train_job(job["id"], model["id"])
    return job


def _check_rows(check, store, job_id, expect: int):
    """The lost/duplicated-rows invariant: exactly ``expect`` trial rows
    (the atomic budget claim held), all COMPLETED."""
    trials = store.get_trials_of_train_job(job_id)
    check("exact_trial_rows", len(trials) == expect,
          f"{len(trials)} rows for budget {expect}")
    bad = [t["id"] for t in trials if t["status"] != "COMPLETED"]
    check("all_trials_completed", not bad, f"not completed: {bad}")
    check("no_duplicate_rows",
          len({t["id"] for t in trials}) == len(trials), "duplicate ids")
    return trials


def _params_match_serial(check, params, trials, source=None, cls_name=None,
                         train_uri=None):
    """Bit-match invariant: each trial's persisted params equal a fresh
    unfaulted serial ``train()`` with the same knobs (the seed knob
    defaults alike), leaf for leaf."""
    import pickle

    import torch

    from rafiki_tpu_torch.model.base import load_model_class
    from rafiki_tpu_torch.utils.serial import load_flat

    cls = load_model_class(source or FF_SOURCE, cls_name or "ChaosFF")
    train_uri = train_uri or TRAIN

    def leaves(blob: bytes):
        return load_flat(pickle.loads(blob)["packed"])

    for t in trials:
        ref = cls(**t["knobs"])
        ref.train(train_uri)
        got = leaves(params.load(t["params_id"]))
        want = leaves(ref.dump_parameters())
        ref.destroy()
        same = (set(got) == set(want)
                and all(torch.equal(got[k], want[k]) for k in want))
        check(f"params_match_serial:{t['id'][:8]}", same,
              "params differ from an unfaulted serial run")


def _no_corrupt_checkpoints(check, params, trials):
    """Completed trials have their mid-trial checkpoints swept (their
    final params supersede them), and every persisted params blob loads
    (a torn write would raise here)."""
    leftovers = []
    for t in trials:
        if params.latest_checkpoint(t["id"]) is not None:
            leftovers.append(t["id"])
        params.load(t["params_id"])  # digest-verified read; raises if torn
    check("no_stale_checkpoints", not leftovers,
          f"checkpoints outlived completion: {leftovers}")


def _platform() -> str:
    """The ProcessScheduler platform of the runner's device."""
    return "cpu" if _device().type == "cpu" else "cuda"


def _journal_has(recs, kind: str, name: str) -> bool:
    return any(r.get("kind") == kind and r.get("name") == name for r in recs)


# ---------------------------------------------------------------------------
# Train-path scenarios
# ---------------------------------------------------------------------------

@scenario(
    "kill-mid-trial-resume",
    "SIGKILL the worker after epoch 1 of a 3-epoch trial; the respawned "
    "worker must adopt and resume from the epoch-1 checkpoint, then "
    "finish the remaining budget — no lost or duplicated trial rows.",
    spec="seed=7;worker.epoch:kill:after=1:times=1:unless=-r",
    env={"RAFIKI_CHECKPOINT_EVERY": "1", "RAFIKI_WORKER_MAX_RESTARTS": "3",
         "RAFIKI_WORKER_RESTART_BACKOFF_S": "0.2"},
)
def kill_mid_trial_resume(tmp, check: CheckFn) -> None:
    from rafiki_tpu_torch.scheduler import ProcessScheduler

    store, params, model = _train_env(tmp)
    job = _make_job(store, model, {"MODEL_TRIAL_COUNT": 2})
    sched = ProcessScheduler(store, params)
    result = sched.run_train_job(job["id"], n_workers=1, advisor_kind="random",
                                 platform=_platform())
    check("job_completed", result.status == "COMPLETED", result.errors)
    trials = _check_rows(check, store, job["id"], expect=2)
    # The kill happened and recovery ran: a trial finished under the
    # respawned worker (its id carries the restart suffix).
    resumed = [t for t in trials if "-r" in (t["worker_id"] or "")]
    check("trial_finished_by_respawned_worker", len(resumed) >= 1,
          f"worker ids: {[t['worker_id'] for t in trials]}")
    _no_corrupt_checkpoints(check, params, trials)


@scenario(
    "kill-mid-pack-resume",
    "The acceptance scenario: a k=4 packed run SIGKILLed mid-pack must "
    "resume ALL four trials from their per-epoch slice checkpoints; "
    "resumed final params bit-match an unfaulted serial run.",
    spec="seed=7;worker.epoch:kill:after=1:times=1:unless=-r",
    env={"RAFIKI_CHECKPOINT_EVERY": "1", "RAFIKI_TRIAL_PACK": "4",
         "RAFIKI_WORKER_MAX_RESTARTS": "3",
         "RAFIKI_WORKER_RESTART_BACKOFF_S": "0.2"},
)
def kill_mid_pack_resume(tmp, check: CheckFn) -> None:
    from rafiki_tpu_torch.scheduler import ProcessScheduler

    store, params, model = _train_env(tmp)
    job = _make_job(store, model, {"MODEL_TRIAL_COUNT": 4})
    sched = ProcessScheduler(store, params)
    result = sched.run_train_job(job["id"], n_workers=1, advisor_kind="random",
                                 platform=_platform())
    check("job_completed", result.status == "COMPLETED", result.errors)
    trials = _check_rows(check, store, job["id"], expect=4)
    resumed = [t for t in trials if "-r" in (t["worker_id"] or "")]
    check("all_trials_resumed_by_respawned_worker", len(resumed) == 4,
          f"worker ids: {[t['worker_id'] for t in trials]}")
    _no_corrupt_checkpoints(check, params, trials)
    _params_match_serial(check, params, trials)


@scenario(
    "checkpoint-write-failure",
    "Every mid-trial checkpoint write fails (injected store error). "
    "A checkpoint is an optimization: the trial must still COMPLETE — "
    "only its resumability is lost — and the failure must be counted.",
    spec="seed=7;store.params_write:error:match=_ckpt_",
    env={"RAFIKI_CHECKPOINT_EVERY": "1"},
)
def checkpoint_write_failure(tmp, check: CheckFn) -> None:
    from rafiki_tpu_torch import telemetry
    from rafiki_tpu_torch.scheduler import LocalScheduler

    store, params, model = _train_env(tmp)
    job = _make_job(store, model, {"MODEL_TRIAL_COUNT": 1})
    sched = LocalScheduler(store, params)
    result = sched.run_train_job(job["id"], n_workers=1, devices=[_device()],
                                 advisor_kind="random")
    check("job_completed", result.status == "COMPLETED", result.errors)
    trials = _check_rows(check, store, job["id"], expect=1)
    check("write_failures_counted",
          telemetry.get_counter("worker.checkpoint_write_failed") >= 1.0,
          "no worker.checkpoint_write_failed increments")
    # Final params take the non-checkpoint path: unaffected, loadable.
    params.load(trials[0]["params_id"])


# ---------------------------------------------------------------------------
# Serving-path scenarios (in-process bus + thread workers)
# ---------------------------------------------------------------------------

class _ConstModel:
    """Fixed prob-vector stand-in: the serving scenarios exercise the
    gather and drain machinery, not the model."""

    def __init__(self, vec):
        self.vec = list(vec)

    def predict(self, queries):
        return [self.vec for _ in queries]


class _ServingCluster:
    def __init__(self, n_workers: int, job: str = JOB):
        from rafiki_tpu_torch.bus import InProcBus
        from rafiki_tpu_torch.worker.inference import InferenceWorker

        self.bus = InProcBus()
        self.job = job
        self.stop = threading.Event()
        self.threads = []
        for i in range(n_workers):
            w = InferenceWorker(self.bus, job, f"w{i}", _ConstModel([0.6, 0.4]),
                                stop_event=self.stop)
            th = threading.Thread(target=w.run, daemon=True, name=f"chaos-iw-w{i}")
            self.threads.append(th)
            th.start()
        deadline = time.monotonic() + 10
        while len(self.bus.get_workers(job)) < n_workers:
            if time.monotonic() >= deadline:
                raise RuntimeError("inference workers never registered")
            time.sleep(0.005)

    def close(self):
        self.stop.set()
        for th in self.threads:
            th.join(timeout=5)


@scenario(
    "straggler-quorum",
    "One of three serving replicas is stuck 3s per forward. Quorum "
    "gather (min_replies=2) must answer every request fast, with no "
    "timeout errors, hedging past the straggler.",
    spec="seed=7;inference.forward:delay:delay=3:match=w2",
)
def straggler_quorum(tmp, check: CheckFn) -> None:
    from rafiki_tpu_torch import chaos
    from rafiki_tpu_torch.gateway import Gateway, GatewayConfig
    from rafiki_tpu_torch.predictor import Predictor

    cluster = _ServingCluster(3)
    try:
        predictor = Predictor(cluster.bus, JOB, timeout_s=8.0)
        gw = Gateway(predictor, GatewayConfig(min_replies=2, hedge_grace_s=0.1))
        t0 = time.monotonic()
        outs = gw.predict([[1.0], [2.0]])
        elapsed = time.monotonic() - t0
        check("all_queries_answered",
              len(outs) == 2 and all(not (isinstance(o, dict) and "error" in o) for o in outs),
              f"outputs: {outs}")
        check("quorum_faster_than_straggler", elapsed < 2.5,
              f"gather took {elapsed:.2f}s against a 3s straggler")
        stats = gw.stats()
        check("no_gather_timeouts", stats["timeouts"] == 0, stats["timeouts"])
        check("straggler_hedged", stats["hedged"] >= 1, stats["hedged"])
        plane = chaos.active()
        fired = [] if plane is None else plane.schedule()
        check("straggler_fault_fired",
              any(site == "inference.forward" and "w2" in key
                  for site, _mode, _hit, key in fired),
              f"schedule: {fired}")
        gw.close()
    finally:
        cluster.close()


@scenario(
    "drain-under-load",
    "Drain the gateway while background requests (with injected "
    "frontend latency) hold inflight slots: drain must flush them "
    "within its timeout and every post-drain request must shed.",
    spec="seed=7;gateway.predict:delay:delay=0.3:times=6",
)
def drain_under_load(tmp, check: CheckFn) -> None:
    from rafiki_tpu_torch.gateway import Gateway, GatewayConfig, ShedError
    from rafiki_tpu_torch.predictor import Predictor

    cluster = _ServingCluster(1)
    try:
        predictor = Predictor(cluster.bus, JOB, timeout_s=8.0)
        gw = Gateway(predictor, GatewayConfig(max_inflight=2, max_queue=8))
        outcomes: List[str] = []
        lock = threading.Lock()

        def fire():
            try:
                gw.predict([[1.0]])
                out = "ok"
            except ShedError as e:
                out = f"shed:{e.reason}"
            with lock:
                outcomes.append(out)

        threads = [threading.Thread(target=fire) for _ in range(6)]
        for th in threads:
            th.start()
        time.sleep(0.15)  # let the first wave hold inflight slots
        drained = gw.drain(timeout=10.0)
        for th in threads:
            th.join(timeout=15)
        check("drain_flushed_inflight", drained, "drain() timed out")
        check("inflight_zero_after_drain", gw.admission.inflight == 0, gw.admission.inflight)
        check("some_requests_served", outcomes.count("ok") >= 1, outcomes)
        check("no_request_lost", len(outcomes) == 6, outcomes)
        try:
            gw.predict([[1.0]])
            check("post_drain_request_shed", False, "predict succeeded")
        except ShedError as e:
            check("post_drain_request_shed", e.reason == "draining", e.reason)
        gw.close()
    finally:
        cluster.close()


@scenario(
    "predictor-outage-surfaces",
    "Every bus heartbeat skipped. Inside the bounded stale grace the "
    "predictor still serves (counted fallback); past it the outage "
    "surfaces as RuntimeError, not per-query timeouts.",
    spec="seed=7;bus.heartbeat:skip",
)
def predictor_outage_surfaces(tmp, check: CheckFn) -> None:
    from rafiki_tpu_torch import chaos, telemetry
    from rafiki_tpu_torch.bus import InProcBus
    from rafiki_tpu_torch.predictor import Predictor

    bus = InProcBus()
    for w in ("w0", "w1"):
        bus.add_worker(JOB, w)
    stop = threading.Event()

    def beat():
        while not stop.wait(0.05):
            for w in ("w0", "w1"):
                bus.heartbeat(JOB, w)  # chaos skips every one

    th = threading.Thread(target=beat, daemon=True)
    th.start()
    try:
        ttl = 0.4
        predictor = Predictor(bus, JOB, timeout_s=1.0, worker_ttl_s=ttl)
        # A hiccup: leases about 1.5x TTL old, inside the 2x TTL grace.
        # The bounded fallback serves the full set and counts.
        time.sleep(1.5 * ttl)
        graced = predictor.live_workers()
        check("grace_window_serves", set(graced) == {"w0", "w1"}, graced)
        check("fallback_counted",
              telemetry.get_counter("predictor.stale_lease_fallback") >= 1.0,
              "no predictor.stale_lease_fallback increments")
        # An outage: leases beyond the grace. Empty fan-out set, and
        # predict() raises instead of passing the outage off as slow answers.
        time.sleep(1.0 * ttl)
        check("outage_set_empty", predictor.live_workers() == [], "not empty")
        try:
            predictor.predict([[1.0]])
            check("outage_raises", False, "predict succeeded")
        except RuntimeError as e:
            check("outage_raises", "no live inference workers" in str(e), e)
        check("outage_counted",
              telemetry.get_counter("predictor.no_live_workers") >= 1.0,
              "no predictor.no_live_workers increments")
        plane = chaos.active()
        fired = [] if plane is None else plane.schedule()
        check("heartbeats_skipped",
              sum(1 for site, mode, _h, _k in fired
                  if site == "bus.heartbeat" and mode == "skip") >= 2,
              f"schedule: {fired}")
    finally:
        stop.set()
        th.join(timeout=2)


# ---------------------------------------------------------------------------
# Tenant isolation
# ---------------------------------------------------------------------------


def _tenant_recs(recs, name: str, tenant: str) -> List[dict]:
    return [r for r in recs
            if r.get("kind") == "tenant" and r.get("name") == name
            and r.get("tenant") == tenant]


def noisy_neighbor_checks(check: CheckFn, recs: List[dict], victim: str, aggressor: str,
                          budget_ms: float, victim_errors: int) -> None:
    """The scenario's six checks, read from the ``tenant/*`` journal
    records alone (also what ``chip_smoke.py`` holds a card run to)."""
    victim_lat = sorted(r.get("e2e_s", 0.0) * 1000.0
                        for r in _tenant_recs(recs, "request", victim))
    victim_p99 = (victim_lat[min(len(victim_lat) - 1, int(0.99 * len(victim_lat)))]
                  if victim_lat else float("inf"))
    aggr_sheds = _tenant_recs(recs, "shed", aggressor)
    victim_sheds = _tenant_recs(recs, "shed", victim)
    check("victim_served", len(victim_lat) >= 20 and victim_errors == 0,
          f"{len(victim_lat)} victim completions, "
          f"{victim_errors} errors/sheds at the caller")
    check("victim_p99_within_budget", victim_p99 <= budget_ms,
          f"victim p99 {victim_p99:.1f}ms vs gold budget {budget_ms}ms "
          f"({len(victim_lat)} samples)")
    check("aggressor_shed", len(aggr_sheds) > 0,
          "the flood never shed — no contention was created")
    check("shed_charged_to_aggressor_quota",
          any(r.get("reason") == "tenant_quota" for r in aggr_sheds),
          f"aggressor shed reasons: {sorted({r.get('reason') for r in aggr_sheds})}")
    check("victim_never_shed", len(victim_sheds) == 0,
          f"{len(victim_sheds)} victim sheds: "
          f"{sorted({r.get('reason') for r in victim_sheds})}")
    summaries = [r for r in recs if r.get("kind") == "tenant" and r.get("name") == "summary"]
    summary_aggr = summaries[-1].get("tenants", {}).get(aggressor, {}) if summaries else {}
    check("summary_reconciles_sheds",
          bool(summaries) and summary_aggr.get("shed") == len(aggr_sheds),
          f"summary={summary_aggr} vs {len(aggr_sheds)} tenant/shed recs")


@scenario(
    "noisy-neighbor-shed",
    "Tenant isolation under a noisy neighbor: an aggressor tenant "
    "floods a tenant-aware gateway at ~10x the victim's rate while "
    "every forward pays an injected delay. Weighted-fair admission "
    "with per-tenant quotas must shed the AGGRESSOR (tenant_quota, "
    "charged to the flooder) while the victim's p99 stays inside its "
    "gold budget and the victim sheds nothing — every invariant read "
    "from the per-tenant journals alone.",
    spec="seed=13;inference.forward:delay:delay=0.06",
)
def noisy_neighbor_shed(tmp, check: CheckFn) -> None:
    from rafiki_tpu_torch.gateway import Gateway, GatewayConfig, ShedError
    from rafiki_tpu_torch.obs import journal as journal_mod
    from rafiki_tpu_torch.predictor import Predictor
    from rafiki_tpu_torch.tenancy import TenantDirectory, TenantFabric

    victim, aggressor = "victim", "aggressor"
    cluster = _ServingCluster(1)
    try:
        fabric = TenantFabric(TenantDirectory(tiers={victim: "gold", aggressor: "batch"}))
        budget_ms = fabric.directory.tier_of(victim).p99_budget_ms
        predictor = Predictor(cluster.bus, JOB, timeout_s=8.0)
        # TWO inflight slots so the quota binds: at quota_frac 0.5 each
        # tenant may hold ONE. Weighted mode caps the aggressor at that
        # slot, so the victim waits at most one forward. Unweighted (the
        # doctored polarity) ignores the quota and degrades to global
        # FIFO: the victim queues behind the whole flood. (One slot would
        # not separate the modes: every tenant's inflight is 0 at each
        # decision and the charge ties.)
        gw = Gateway(predictor, GatewayConfig(min_replies=1, max_inflight=2, max_queue=8),
                     tenancy=fabric)
        stop = threading.Event()

        def aggress():
            # The 10x spike: flood until stopped; a shed (the expected
            # outcome) backs off briefly so the loop doesn't busy-spin.
            while not stop.is_set():
                try:
                    gw.predict([[1.0]], tenant=aggressor)
                except (ShedError, RuntimeError):
                    time.sleep(0.005)

        # 8 flooders against 2+8 capacity: deep queue pressure without
        # filling the shared queue, so the victim always gets to enqueue
        # in both polarities.
        flood = [threading.Thread(target=aggress, daemon=True, name=f"aggr-{i}")
                 for i in range(8)]
        for th in flood:
            th.start()
        time.sleep(0.3)  # the flood established before the victim
        victim_errors = 0
        for _ in range(25):
            try:
                gw.predict([[1.0]], tenant=victim)
            except (ShedError, RuntimeError):
                victim_errors += 1
            time.sleep(0.02)
        stop.set()
        for th in flood:
            th.join(timeout=5)
        gw.drain(timeout=10.0)  # flushes the tenant/summary record
        gw.close()
    finally:
        cluster.close()
    # Everything below reads ONLY the journal: the isolation story must
    # reconstruct without touching live objects.
    noisy_neighbor_checks(check, journal_mod.read_dir(journal_mod.journal.log_dir), victim,
                          aggressor, budget_ms, victim_errors)


# ---------------------------------------------------------------------------
# Stacked-route loss scenario (mp bus + spawned stacked worker)
# ---------------------------------------------------------------------------


#: The stacked worker's liveness lease, for the supervisor and the
#: predictor alike (the reference scenario's 1 s).
STACKED_LOSS_TTL_S = 1.0


def _stacked_stub_main(bus, job: str, worker_id: str) -> None:
    """Spawn target: the stacked worker as its OWN process, the
    deployment shape of the stacked serving route, where one process
    holds a job's whole top-k ensemble. RAFIKI_CHAOS rides the spawn
    env, so the inference.forward kill fires HERE, in the child."""
    from rafiki_tpu_torch import obs

    obs.configure_from_env(role="infer")
    from rafiki_tpu_torch.worker.inference import InferenceWorker

    InferenceWorker(bus, job, worker_id, _ConstModel([0.6, 0.4])).run()


def stacked_loss_body(check: CheckFn, child, child_args: tuple, fallback_models: list,
                      requests: list, register_timeout_s: float = 30.0) -> dict:
    """The body of ``stacked-worker-loss-fallback`` over any stacked
    child: ``child(bus, job, "stacked-w0", *child_args)`` is spawned and
    must die of the ``inference.forward`` kill on its second forward;
    the supervisor's fallback serves ``fallback_models`` from thread
    workers of this process. Runs the five ``requests`` through the
    gateway, checks the seven invariants, and returns what it saw
    (outputs, the child's pid, and the wall instants of the kill and of
    the first answer after it)."""
    import multiprocessing as mp
    import os

    from rafiki_tpu_torch import telemetry
    from rafiki_tpu_torch.bus.queues import make_mp_bus
    from rafiki_tpu_torch.gateway import Gateway, GatewayConfig
    from rafiki_tpu_torch.obs import journal as journal_mod
    from rafiki_tpu_torch.predictor import Predictor
    from rafiki_tpu_torch.worker.fallback import FallbackSupervisor
    from rafiki_tpu_torch.worker.inference import InferenceWorker

    ctx = mp.get_context("spawn")
    bus = make_mp_bus()
    stop = threading.Event()
    fallback_threads: List[threading.Thread] = []
    proc = sup = None
    try:
        proc = ctx.Process(target=child, args=(bus, JOB, "stacked-w0") + tuple(child_args),
                           daemon=True)
        proc.start()
        deadline = time.monotonic() + register_timeout_s
        while "stacked-w0" not in bus.get_workers(JOB):
            if not proc.is_alive():
                raise RuntimeError(f"stacked worker died before registering: {proc.exitcode}")
            if time.monotonic() >= deadline:
                raise RuntimeError("stacked worker never registered")
            time.sleep(0.02)

        def spawn_fallback():
            # The replicated degrade: one thread worker per trial.
            for i, model in enumerate(fallback_models):
                w = InferenceWorker(bus, JOB, f"fb{i}", model, stop_event=stop)
                th = threading.Thread(target=w.run, daemon=True, name=f"chaos-fb{i}")
                fallback_threads.append(th)
                th.start()

        sup = FallbackSupervisor(bus, JOB, "stacked-w0", spawn_fallback,
                                 ttl_s=STACKED_LOSS_TTL_S, poll_s=0.1).start()
        predictor = Predictor(bus, JOB, timeout_s=10.0, worker_ttl_s=STACKED_LOSS_TTL_S)
        gw = Gateway(predictor, GatewayConfig(min_replies=1, blackout_retries=4))
        # Request 1 is the fault's after=1 skip: the stacked worker serves
        # it, seeding the latency EWMA the blackout probes key off.
        # Request 2's forward IS the kill: its envelope dies with the
        # worker and only the blackout re-route can save it.
        outcomes, outputs, done_at = [], [], []
        for queries in requests:
            try:
                outs = gw.predict(queries, deadline_s=10.0)
                ok = bool(outs) and not any(isinstance(o, dict) and "error" in o for o in outs)
            except Exception as e:
                outs, ok = repr(e), False
            outcomes.append(ok)
            outputs.append(outs)
            done_at.append(time.time())
        gw.close()
        check("no_request_dropped", all(outcomes), f"outcomes: {outcomes}")
        proc.join(timeout=5)
        check("stacked_worker_sigkilled", not proc.is_alive() and proc.exitcode == -9,
              f"alive={proc.is_alive()} exitcode={proc.exitcode}")
        check("fallback_supervisor_fired", sup.fired.is_set(),
              "supervisor never saw the lease die")
        check("blackout_reroute_engaged",
              telemetry.get_counter("gateway.blackout_retries") >= 1.0,
              "no gateway.blackout_retries increments")
        recs = journal_mod.read_dir(journal_mod.journal.log_dir)
        check("journal_records_fallback", _journal_has(recs, "serving", "fallback"),
              "no serving/fallback journal record")
        check("journal_records_blackout_retry", _journal_has(recs, "gateway", "blackout_retry"),
              "no gateway/blackout_retry journal record")
        # The kill really fired, and in the CHILD: its chaos/injected
        # record carries the child's pid.
        injected = [r for r in recs if r.get("kind") == "chaos"
                    and r.get("name") == "injected" and r.get("site") == "inference.forward"]
        check("kill_journaled_from_child",
              any(r.get("pid") != os.getpid() for r in injected),
              f"injected records: {injected}")
        killed_at = next((r.get("ts") for r in injected if r.get("pid") == proc.pid), None)
        return {"outcomes": outcomes, "outputs": outputs, "child_pid": proc.pid,
                "killed_at": killed_at,
                "first_answer_after_kill": next((t for t in done_at
                                                 if killed_at is not None and t > killed_at),
                                                None),
                "blackout_retries": telemetry.get_counter("gateway.blackout_retries")}
    finally:
        if sup is not None:
            sup.stop()
        stop.set()
        for th in fallback_threads:
            th.join(timeout=5)
        if proc is not None:
            if proc.is_alive():
                proc.kill()
            proc.join(timeout=5)
        bus.close()


@scenario(
    "stacked-worker-loss-fallback",
    "SIGKILL the stacked worker that serves a job's WHOLE top-k "
    "ensemble mid-load: the fallback supervisor must degrade the job "
    "to replicated per-trial workers, the gateway's blackout re-route "
    "must carry every admitted request to an answer (zero dropped), "
    "and the loss->fallback story must reconstruct from the journals.",
    spec="seed=7;inference.forward:kill:after=1:times=1:match=stacked",
)
def stacked_worker_loss_fallback(tmp, check: CheckFn) -> None:
    # Const-model stand-ins on both sides: this scenario pins the loss
    # control flow, not the model math.
    stacked_loss_body(check, _stacked_stub_main, (),
                      [_ConstModel([0.6, 0.4]) for _ in range(2)],
                      [[[float(i)]] for i in range(5)])


# ---------------------------------------------------------------------------
# Elastic-pack scenarios
# ---------------------------------------------------------------------------

# ChaosFF plus an early-stop rule keyed off learning_rate, a DYNAMIC knob,
# so a high-lr (early-stopping) member and a low-lr (full-budget) member
# share one packing key and train in one pack.
EVICT_SOURCE = b"""
from rafiki_tpu_torch.model.base import TorchModel
from rafiki_tpu_torch.model.knobs import FixedKnob, FloatKnob
from rafiki_tpu_torch.models.ff import _Mlp

class EvictFF(TorchModel):
    @staticmethod
    def get_knob_config():
        return {
            "hidden_units": FixedKnob(16),
            "learning_rate": FloatKnob(1e-3, 3e-2, is_exp=True),
            "batch_size": FixedKnob(32),
            "epochs": FixedKnob(3),
        }

    def build_module(self, num_classes, input_shape):
        return _Mlp(hidden_layers=1, hidden_units=int(self.knobs["hidden_units"]),
                    num_classes=num_classes, input_shape=input_shape)

    def should_stop_early(self, epoch, metrics):
        # A high-lr member "converges" after its first epoch: the
        # deterministic straggler-eviction trigger.
        return float(self.knobs["learning_rate"]) >= 0.02
"""


def _pack_worker(tmp, source: bytes, cls_name: str, model_name: str, budget: int,
                 worker_id: str):
    """A store, a job of ``budget`` trials of the template, and a worker on
    the runner's device with a random advisor and synchronous persists."""
    from rafiki_tpu_torch.advisor import AdvisorService
    from rafiki_tpu_torch.model.base import load_model_class
    from rafiki_tpu_torch.store import MetaStore, ParamsStore
    from rafiki_tpu_torch.worker.train import InProcAdvisorHandle, TrainWorker

    store = MetaStore(tmp / "meta.sqlite3")
    params = ParamsStore(tmp / "params")
    model = store.create_model(model_name, "IMAGE_CLASSIFICATION", None, source, cls_name)
    job = _make_job(store, model, {"MODEL_TRIAL_COUNT": budget})
    sub = store.get_sub_train_jobs(job["id"])[0]
    cls = load_model_class(source, cls_name)
    advisors = AdvisorService()
    advisor_id = advisors.create_advisor(cls.get_knob_config(), kind="random")
    worker = TrainWorker(
        store, params, sub["id"], cls, InProcAdvisorHandle(advisors, advisor_id), TRAIN, VAL,
        {"MODEL_TRIAL_COUNT": budget}, worker_id=worker_id, devices=[_device()],
        async_persist=False)
    return store, params, job, sub, cls, worker


def _claim_rows(store, sub, cls, cls_name: str, knobs_list, budget: int):
    from rafiki_tpu_torch.model.knobs import knob_config_signature

    knob_config = cls.get_knob_config()
    rows = []
    for kn in knobs_list:
        trial = store.create_trial(sub["id"], cls_name, kn,
                                   shape_sig=knob_config_signature(knob_config, kn),
                                   budget_max=budget)
        rows.append((trial["id"], kn))
    return rows


@scenario(
    "pack-straggler-evict",
    "One member of a k=2 pack early-stops at epoch 0 while its mate "
    "trains the full budget: the straggler must be EVICTED from the "
    "stacked state mid-pack, its slot backfilled with a freshly "
    "proposed trial, all three trials complete, and the evictee "
    "bit-matches a serial early-stopped run.",
    spec="seed=11;worker.epoch:delay:delay=0.05:times=1",
)
def pack_straggler_evict(tmp, check: CheckFn) -> None:
    from rafiki_tpu_torch import telemetry
    from rafiki_tpu_torch.worker.train import PackedTrialRunner

    store, params, job, sub, cls, worker = _pack_worker(
        tmp, EVICT_SOURCE, "EvictFF", "evictff", 3, "evict-w0")
    base = {"hidden_units": 16, "batch_size": 32, "epochs": 3}
    # lr >= 0.02 trips EvictFF.should_stop_early at epoch 0: a straggler
    # next to a full-budget mate.
    rows = _claim_rows(store, sub, cls, "EvictFF",
                       [dict(base, learning_rate=0.025), dict(base, learning_rate=0.005)], 3)
    n = PackedTrialRunner(worker, 2).run_assigned(rows, budget_max=3)
    # 2 assigned + 1 backfilled into the evicted straggler's slot.
    check("all_rows_carried", n == 3, f"carried {n}, want 3")
    trials = _check_rows(check, store, job["id"], expect=3)
    check("straggler_evicted", telemetry.get_counter("trial_pack.evictions") >= 1.0,
          "no trial_pack.evictions increments")
    check("slot_backfilled", telemetry.get_counter("trial_pack.backfills") >= 1.0,
          "no trial_pack.backfills increments")
    check("all_scores_recorded", all(t.get("score") is not None for t in trials),
          f"scores: {[t.get('score') for t in trials]}")
    _params_match_serial(check, params, trials, source=EVICT_SOURCE, cls_name="EvictFF")


@scenario(
    "nan-trial-contained",
    "Chaos NaN-poisons one gradient step of pack member 2 (k=4). The "
    "health plane must trip at the epoch boundary, bank a replay "
    "capsule that re-executes bit-exactly, evict ONLY the sick member "
    "(ERRORED with a diagnosis, floor score fed back), and carry the "
    "three survivors to completion with params bit-matching unfaulted "
    "serial runs.",
    spec="seed=19;train.nan:nan:times=1:match=@m2",
)
def nan_trial_contained(tmp, check: CheckFn) -> None:
    from rafiki_tpu_torch import telemetry
    from rafiki_tpu_torch.chaos import plane as plane_mod
    from rafiki_tpu_torch.obs import journal as journal_mod
    from rafiki_tpu_torch.worker.train import PackedTrialRunner

    store, params, job, sub, cls, worker = _pack_worker(
        tmp, FF_SOURCE, "ChaosFF", "nanff", 4, "nan-w0")
    base = {"hidden_units": 16, "batch_size": 32, "epochs": 3}
    # budget_max=4 is also the backfill gate: the evicted slot must NOT be
    # refilled (the budget is fully claimed), which keeps the member
    # indices stable for the @m2 match.
    rows = _claim_rows(store, sub, cls, "ChaosFF",
                       [dict(base, learning_rate=lr) for lr in (0.001, 0.002, 0.004, 0.008)], 4)
    n = PackedTrialRunner(worker, 4).run_assigned(rows, budget_max=4)
    check("all_rows_carried", n == 4, f"carried {n}, want 4")

    # Vacuous-pass rejection: the fault must have fired at train.nan for
    # member 2; a pass where the poison never landed proves nothing.
    fired = [(site, mode, key) for site, mode, _hit, key in plane_mod.active().schedule()
             if site == "train.nan"]
    check("nan_fault_fired", len(fired) == 1 and "@m2" in fired[0][2],
          f"train.nan firings: {fired}")

    trials = store.get_trials_of_train_job(job["id"])
    check("exact_trial_rows", len(trials) == 4,
          f"{len(trials)} rows for budget 4 (backfill must not refill "
          "a diverged slot under a drained budget)")
    errored = [t for t in trials if t["status"] == "ERRORED"]
    completed = [t for t in trials if t["status"] == "COMPLETED"]
    check("one_member_errored", len(errored) == 1, f"statuses: {[t['status'] for t in trials]}")
    check("three_survivors_completed", len(completed) == 3,
          f"statuses: {[t['status'] for t in trials]}")
    check("diagnosis_surfaced",
          bool(errored) and "diverged" in (errored[0].get("error") or ""),
          f"error: {errored[0].get('error') if errored else None}")
    check("survivors_scored", all(t.get("score") is not None for t in completed),
          f"scores: {[t.get('score') for t in completed]}")
    check("divergence_counted", telemetry.get_counter("health.divergences") >= 1.0,
          "no health.divergences increments")
    check("containment_counted", telemetry.get_counter("health.contained") >= 1.0,
          "no health.contained increments")
    check("eviction_counted", telemetry.get_counter("health.evictions") >= 1.0,
          "no health.evictions increments")

    recs = journal_mod.read_dir(journal_mod.journal.log_dir)
    check("journal_records_divergence", _journal_has(recs, "health", "divergence"),
          "no health/divergence journal record")
    check("journal_records_capsule", _journal_has(recs, "health", "capsule"),
          "no health/capsule journal record")

    # The capsule is a faithful repro: re-execute the truncated epoch and
    # require every compared sentinel value bit-identical.
    caps = sorted((journal_mod.journal.log_dir or tmp).glob("capsule-*.rcap"))
    check("capsule_banked", len(caps) >= 1, "no capsule-*.rcap on disk")
    if caps:
        from rafiki_tpu_torch.obs.health import capsule as capsule_mod

        verdict = capsule_mod.replay(caps[-1])
        check("capsule_replay_bit_exact", verdict["reproduced"],
              f"mismatches: {verdict['mismatches']}")
        check("capsule_replay_poisoned", verdict["poisoned"],
              "replayed capsule carried no poison column")

    _params_match_serial(check, params, completed)


@scenario(
    "collective-kill-mid-step",
    "SIGKILL a dp-mesh worker inside the collective step path (the "
    "collective.step site fires each epoch a mesh plan is live). The "
    "respawned worker must adopt, resume from the epoch checkpoint and "
    "finish the budget. No bit-match here: dp gradient reduction order "
    "differs from serial by design.",
    spec="seed=13;collective.step:kill:after=1:times=1:unless=-r",
    env={"RAFIKI_CHECKPOINT_EVERY": "1", "RAFIKI_WORKER_MAX_RESTARTS": "3",
         "RAFIKI_WORKER_RESTART_BACKOFF_S": "0.2"},
)
def collective_kill_mid_step(tmp, check: CheckFn) -> None:
    from rafiki_tpu_torch.scheduler import ProcessScheduler

    store, params, model = _train_env(tmp)
    job = _make_job(store, model, {"MODEL_TRIAL_COUNT": 2})
    sched = ProcessScheduler(store, params)
    result = sched.run_train_job(job["id"], n_workers=1, devices_per_trial=2,
                                 advisor_kind="random", platform=_platform())
    check("job_completed", result.status == "COMPLETED", result.errors)
    trials = _check_rows(check, store, job["id"], expect=2)
    resumed = [t for t in trials if "-r" in (t["worker_id"] or "")]
    check("trial_finished_by_respawned_worker", len(resumed) >= 1,
          f"worker ids: {[t['worker_id'] for t in trials]}")
    _no_corrupt_checkpoints(check, params, trials)


# ---------------------------------------------------------------------------
# Mesh sweep scenarios (scheduler/mesh.py): the runner's device is every
# chip's, so two chips, or two group members, share one device.
# ---------------------------------------------------------------------------

def _chips(n: int):
    return [_device()] * n


@scenario(
    "mesh-chip-loss-repack",
    "Preempt chip 1 of a 2-chip mesh sweep mid-pack: the supervisor "
    "must re-pack its RUNNING trials onto the survivor, every trial "
    "completes with a score, resumed params bit-match unfaulted serial "
    "runs, and the loss/re-pack story reads back out of the journals.",
    spec="seed=11;scheduler.preempt:kill:after=2:times=1:match=chip1",
    env={"RAFIKI_CHECKPOINT_EVERY": "1"},
)
def mesh_chip_loss_repack(tmp, check: CheckFn) -> None:
    from rafiki_tpu_torch import chaos, telemetry
    from rafiki_tpu_torch.obs import journal as journal_mod
    from rafiki_tpu_torch.obs.ledger import ledger
    from rafiki_tpu_torch.scheduler import MeshSweepScheduler

    store, params, model = _train_env(tmp)
    job = _make_job(store, model, {"MODEL_TRIAL_COUNT": 4})
    result = MeshSweepScheduler(store, params).run_sweep(
        job["id"], chips=2, trials_per_chip=2, advisor_kind="random", devices=_chips(2))
    check("job_completed", result.status == "COMPLETED", result.errors)
    trials = _check_rows(check, store, job["id"], expect=4)
    check("all_scores_recorded", all(t.get("score") is not None for t in trials),
          f"scores: {[t.get('score') for t in trials]}")
    check("chip_loss_counted", telemetry.get_counter("mesh.chips_lost") >= 1.0,
          "no mesh.chips_lost increments")
    # The kill really fired, against chip1 specifically.
    plane = chaos.active()
    fired = [] if plane is None else plane.schedule()
    check("preempt_fired",
          any(site == "scheduler.preempt" and key == "chip1"
              for site, _mode, _hit, key in fired), f"schedule: {fired}")
    # Re-packed work lands on the survivor.
    workers = {t.get("worker_id") for t in trials}
    check("survivor_finished_trials", any(w and w.endswith("-mesh-c0") for w in workers),
          f"worker ids: {sorted(w or '' for w in workers)}")
    recs = journal_mod.read_dir(journal_mod.journal.log_dir)
    check("journal_records_chip_loss", _journal_has(recs, "mesh", "chip_lost"),
          "no mesh/chip_lost journal record")
    check("journal_records_repack", _journal_has(recs, "mesh", "repack"),
          "no mesh/repack journal record")
    # Recovery cost charged to the sweep's downtime bucket.
    ent = ledger.snapshot()["entities"].get(f"mesh:{job['id']}", {})
    check("downtime_charged", ent.get("downtime_s", 0.0) > 0.0, ent)
    _params_match_serial(check, params, trials)


# A Transformer family with every shape knob fixed: one knob config, so a
# fresh model with a trial's knobs retrains bit-identically, and the
# width-invariance of the sharded loop (shard/loop.py) makes that same
# serial run the reference for a GROUP trial at any width.
SHARD_SOURCE = b"""
from rafiki_tpu_torch.model.knobs import FixedKnob, FloatKnob
from rafiki_tpu_torch.models.transformer import Transformer

class ShardTf(Transformer):
    @staticmethod
    def get_knob_config():
        return {
            "embed_dim": FixedKnob(32),
            "num_heads": FixedKnob(2),
            "num_layers": FixedKnob(1),
            "learning_rate": FloatKnob(1e-3, 1e-2, is_exp=True),
            "batch_size": FixedKnob(32),
            "epochs": FixedKnob(3),
            "seed": FixedKnob(0),
        }
"""

SHARD_TRAIN = "synthetic://text?vocab=81&classes=5&n=256&len=16&seed=0"
SHARD_VAL = "synthetic://text?vocab=81&classes=5&n=64&len=16&seed=1"


@scenario(
    "chip-loss-mid-sharded-trial",
    "Preempt member 1 of a width-2 sharded group mid-trial: the group "
    "must abort at the epoch boundary (that epoch's shard-chunk "
    "manifest durable FIRST), re-form at width 1 on the survivor, "
    "resume via reshard-on-restore, complete with a score, and the "
    "final params must bit-match an unfaulted serial run.",
    spec="seed=11;scheduler.preempt:kill:after=2:times=1:match=chip1",
    env={"RAFIKI_CHECKPOINT_EVERY": "1", "RAFIKI_SHARD_WIDTH": "2"},
)
def chip_loss_mid_sharded_trial(tmp, check: CheckFn) -> None:
    from rafiki_tpu_torch import chaos, telemetry
    from rafiki_tpu_torch.obs import journal as journal_mod
    from rafiki_tpu_torch.scheduler import MeshSweepScheduler
    from rafiki_tpu_torch.store import MetaStore, ParamsStore

    store = MetaStore(tmp / "meta.sqlite3")
    params = ParamsStore(tmp / "params")
    model = store.create_model("shardtf", "TEXT_CLASSIFICATION", None, SHARD_SOURCE, "ShardTf")
    job = store.create_train_job("shardapp", "TEXT_CLASSIFICATION", None, SHARD_TRAIN,
                                 SHARD_VAL, {"MODEL_TRIAL_COUNT": 1})
    store.create_sub_train_job(job["id"], model["id"])
    result = MeshSweepScheduler(store, params).run_sweep(
        job["id"], chips=2, trials_per_chip=1, advisor_kind="random", devices=_chips(2))
    check("job_completed", result.status == "COMPLETED", result.errors)
    trials = _check_rows(check, store, job["id"], expect=1)
    check("score_recorded", trials[0].get("score") is not None, trials[0])
    check("group_worker_finished", (trials[0].get("worker_id") or "").endswith("-shard-g0"),
          f"worker id: {trials[0].get('worker_id')}")
    # The kill really fired, against a group member specifically.
    plane = chaos.active()
    fired = [] if plane is None else plane.schedule()
    check("preempt_fired",
          any(site == "scheduler.preempt" and key == "chip1"
              for site, _mode, _hit, key in fired), f"schedule: {fired}")
    check("chip_loss_counted", telemetry.get_counter("mesh.chips_lost") >= 1.0,
          "no mesh.chips_lost increments")
    check("reshard_restore_counted", telemetry.get_counter("shard.reshard_restores") >= 1.0,
          "no shard.reshard_restores increments")
    # The width history reconstructs from the journal stream alone:
    # formed at 2, member lost, re-formed at 1, resharded 2 -> 1.
    recs = journal_mod.read_dir(journal_mod.journal.log_dir)
    shard = [r for r in recs if r.get("kind") == "shard"]
    widths = [r.get("width") for r in shard if r.get("name") == "group_formed"]
    check("group_formed_then_reformed", widths == [2, 1], f"group_formed widths: {widths}")
    check("journal_records_member_loss", _journal_has(recs, "shard", "member_lost"),
          "no shard/member_lost journal record")
    reshards = [(r.get("from_width"), r.get("to_width"))
                for r in shard if r.get("name") == "reshard"]
    check("journal_records_reshard", (2, 1) in reshards, f"reshard records: {reshards}")
    _params_match_serial(check, params, trials, source=SHARD_SOURCE, cls_name="ShardTf",
                         train_uri=SHARD_TRAIN)


@scenario(
    "mesh-degrades-single-chip",
    "Every mesh-formation attempt fails (injected collective.init "
    "errors past the retry budget): the sweep must DEGRADE to "
    "single-chip mode inside its grace window — same trials, one chip "
    "— and still complete, with the downgrade journaled.",
    spec="seed=17;collective.init:error:times=8",
    env={"RAFIKI_MESH_INIT_RETRIES": "2", "RAFIKI_MESH_INIT_BACKOFF_S": "0.01",
         "RAFIKI_MESH_FORM_GRACE_S": "5"},
)
def mesh_degrades_single_chip(tmp, check: CheckFn) -> None:
    from rafiki_tpu_torch import telemetry
    from rafiki_tpu_torch.obs import journal as journal_mod
    from rafiki_tpu_torch.scheduler import MeshSweepScheduler

    store, params, model = _train_env(tmp)
    job = _make_job(store, model, {"MODEL_TRIAL_COUNT": 2})
    result = MeshSweepScheduler(store, params).run_sweep(
        job["id"], chips=2, trials_per_chip=2, advisor_kind="random", devices=_chips(2))
    check("job_completed", result.status == "COMPLETED", result.errors)
    trials = _check_rows(check, store, job["id"], expect=2)
    check("degradation_counted", telemetry.get_counter("mesh.degraded_single_chip") >= 1.0,
          "no mesh.degraded_single_chip increments")
    check("init_retries_counted", telemetry.get_counter("mesh.init_retries") >= 2.0,
          "no mesh.init_retries increments")
    workers = {t.get("worker_id") for t in trials}
    check("single_chip_ran_everything", all(w and w.endswith("-mesh-c0") for w in workers),
          f"worker ids: {sorted(w or '' for w in workers)}")
    recs = journal_mod.read_dir(journal_mod.journal.log_dir)
    check("journal_records_degradation", _journal_has(recs, "mesh", "degraded"),
          "no mesh/degraded journal record")
    _params_match_serial(check, params, trials)


# ---------------------------------------------------------------------------
# Control-plane crash scenarios (docs/recovery.md): the sweep runs in a
# process of its own (scheduler/sweep_proc.py), so a supervisor kill takes
# out the WHOLE control plane (advisor state, pack assignments,
# heartbeats), and resume_sweep must prove a genuinely fresh process
# adopts the job from the MetaStore + sweep WAL + journals alone, and the
# crash's story must read back through `obs resume`.
# ---------------------------------------------------------------------------

def _sweep_proc_env(extra: Optional[Dict[str, str]] = None,
                    chaos: bool = True) -> Dict[str, str]:
    """Child env for a sweep_proc subprocess: inherits the runner's
    installed chaos/journal env, pins this checkout importable whatever
    the cwd, and (chaos=False) strips the fault spec for resume and
    reference children, which run unfaulted."""
    import os
    from pathlib import Path

    import rafiki_tpu_torch

    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(Path(rafiki_tpu_torch.__file__).resolve().parents[1]),
                    env.get("PYTHONPATH", "")) if p)
    env.update(extra or {})
    if not chaos:
        env.pop("RAFIKI_CHAOS", None)
    return env


def _sweep_proc_argv(mode: str, store, params, job_id: str, chips: int, trials_per_chip: int):
    import sys

    return [sys.executable, "-m", "rafiki_tpu_torch.scheduler.sweep_proc", mode,
            "--db", str(store.path), "--params", str(params.directory), "--job", job_id,
            "--chips", str(chips), "--trials-per-chip", str(trials_per_chip),
            "--device", _platform()]


def _sweep_proc(mode: str, store, params, job_id: str, *, chips: int, trials_per_chip: int,
                env: Dict[str, str], advisor: Optional[str] = None,
                advisor_kwargs: Optional[str] = None, stale_after_s: Optional[float] = None,
                timeout: float = 240.0):
    import json as _json
    import subprocess

    argv = _sweep_proc_argv(mode, store, params, job_id, chips, trials_per_chip)
    if advisor:
        argv += ["--advisor", advisor]
    if advisor_kwargs:
        argv += ["--advisor-kwargs", advisor_kwargs]
    if stale_after_s is not None:
        argv += ["--stale-after-s", str(stale_after_s)]
    proc = subprocess.run(argv, env=env, capture_output=True, text=True, timeout=timeout)
    summary = {}
    if proc.stdout.strip():
        try:
            summary = _json.loads(proc.stdout.strip().splitlines()[-1])
        except ValueError:
            summary = {}
    return proc, summary


def _wal_checks(check, store, job_id: str) -> None:
    """WAL-vs-store reconcile proves zero slots claimed twice: every
    trial row covered by exactly one claim record."""
    from rafiki_tpu_torch.scheduler.wal import read_wal, reconcile, wal_path

    recs = read_wal(wal_path(store.path, job_id))
    for sub in store.get_sub_train_jobs(job_id):
        r = reconcile(recs, store.get_trials_of_sub_train_job(sub["id"]), sub=sub,
                      sub_id=sub["id"])
        check("wal_reconciles_clean", r.ok, r.summary())
        check("no_double_claims", all(n == 1 for n in r.claims.values()), r.summary())


@scenario(
    "supervisor-kill-mid-sweep",
    "SIGKILL the whole sweep-supervisor process mid-sweep (after its "
    "warmup claims, before any trial completes): resume_sweep in a "
    "fresh process must reconcile the WAL with zero double-claimed "
    "slots, rehydrate the GP advisor, adopt every orphan, and finish "
    "the job with the SAME best score and knob set as an unfaulted "
    "run under the same seeds — with a non-warmup post-resume "
    "propose_batch proving the advisor continued, not restarted.",
    spec="seed=23;supervisor.tick:kill:after=30:times=1:match=g0",
    env={"RAFIKI_CHECKPOINT_EVERY": "1",
         "RAFIKI_SUPERVISOR_HEARTBEAT_S": "0.2"},
)
def supervisor_kill_mid_sweep(tmp, check: CheckFn) -> None:
    import json as _json
    import subprocess
    import sys
    import time as _time

    from rafiki_tpu_torch.obs import journal as journal_mod

    # Budget == chips * trials_per_chip == GP n_initial: every claim is a
    # seed-deterministic warmup proposal made up front, so ONE plain
    # unfaulted run is a complete best-score reference and the faulted
    # run's kill (supervisor.tick only exists after the claims) cannot
    # change which knobs were claimed.
    BUDGET, CHIPS, K = 4, 2, 2
    fd = tmp / "faulted"
    fd.mkdir(parents=True, exist_ok=True)
    store, params, model = _train_env(fd)
    job = _make_job(store, model, {"MODEL_TRIAL_COUNT": BUDGET})

    p1, _ = _sweep_proc("run", store, params, job["id"], chips=CHIPS, trials_per_chip=K,
                        env=_sweep_proc_env(), advisor="gp", advisor_kwargs='{"n_initial": 4}')
    check("supervisor_killed", p1.returncode == -9,
          f"run rc={p1.returncode}: {p1.stderr[-500:]}")

    _time.sleep(0.5)
    p2, summary = _sweep_proc("resume", store, params, job["id"], chips=CHIPS,
                              trials_per_chip=K, env=_sweep_proc_env(chaos=False),
                              stale_after_s=0.4)
    check("resume_completed", p2.returncode == 0,
          f"resume rc={p2.returncode}: {p2.stderr[-800:]}")
    check("resume_adopted_orphans", summary.get("adopted", 0) >= 1, summary)
    check("resume_mode_wal", summary.get("mode") == "wal", summary)
    trials = _check_rows(check, store, job["id"], expect=BUDGET)
    _wal_checks(check, store, job["id"])

    # The unfaulted reference run, same seeds, its own journal dir so the
    # faulted job's timeline stays uncontaminated.
    rd = tmp / "reference"
    rd.mkdir(parents=True, exist_ok=True)
    rstore, rparams, rmodel = _train_env(rd)
    rjob = _make_job(rstore, rmodel, {"MODEL_TRIAL_COUNT": BUDGET})
    p3, _ = _sweep_proc("run", rstore, rparams, rjob["id"], chips=CHIPS, trials_per_chip=K,
                        env=_sweep_proc_env({"RAFIKI_LOG_DIR": str(rd / "obs")}, chaos=False),
                        advisor="gp", advisor_kwargs='{"n_initial": 4}')
    check("reference_completed", p3.returncode == 0,
          f"reference rc={p3.returncode}: {p3.stderr[-500:]}")
    rtrials = rstore.get_trials_of_train_job(rjob["id"])
    best_f = max((t["score"] for t in trials if t["score"] is not None), default=None)
    best_r = max((t["score"] for t in rtrials if t["score"] is not None), default=None)
    check("best_score_matches_unfaulted", best_f is not None and best_f == best_r,
          f"faulted {best_f} vs unfaulted {best_r}")
    knobs_f = sorted(_json.dumps(t["knobs"], sort_keys=True) for t in trials)
    knobs_r = sorted(_json.dumps(t["knobs"], sort_keys=True) for t in rtrials)
    check("knob_set_matches_unfaulted", knobs_f == knobs_r,
          "resumed sweep explored different knobs than unfaulted run")

    # The post-resume propose_batch shows non-warmup internals: the
    # rehydrated GP drafted with the constant liar, it did not restart.
    jrecs = journal_mod.read_dir(journal_mod.journal.log_dir)
    check("advisor_rehydrated", _journal_has(jrecs, "recovery", "rehydrated"),
          "no recovery/rehydrated journal record")
    batches = [r for r in jrecs if r.get("kind") == "advisor" and r.get("name") == "propose_batch"]
    check("post_resume_batch_non_warmup",
          any(b.get("strategy") == "constant_liar_min" for b in batches),
          f"batch strategies: {[b.get('strategy') for b in batches]}")
    check("kill_injected_journaled",
          any(r.get("kind") == "chaos" and r.get("mode") == "kill"
              and r.get("site") == "supervisor.tick" for r in jrecs),
          "no chaos/injected supervisor.tick kill in journals")

    # The crash->adopt->complete story reconstructs from the journals alone
    # through the obs CLI verb.
    p4 = subprocess.run(
        [sys.executable, "-m", "rafiki_tpu_torch.obs", "--dir", str(journal_mod.journal.log_dir),
         "resume", job["id"]],
        env=_sweep_proc_env(chaos=False), capture_output=True, text=True, timeout=60)
    check("obs_resume_reconstructs", p4.returncode == 0 and "resumed:" in p4.stdout,
          f"rc={p4.returncode}: {p4.stderr[-400:]}")


@scenario(
    "host-loss-mid-sweep",
    "Two whole-host losses in one 4-chip / 2-hosts sweep: host 1 "
    "(chips 2,3) is lost first via the host.loss chaos site and the "
    "survivors must re-pack its rows; then host 0 dies taking the "
    "supervisor with it (SIGKILL fired the moment the re-pack hits "
    "the journal — state-triggered, so the ordering is robust to "
    "machine speed), and resume_sweep must adopt the rest and finish "
    "the full budget with clean WAL accounting.",
    spec="seed=29;host.loss:kill:after=2:times=1:match=g0h1",
    env={"RAFIKI_CHECKPOINT_EVERY": "1",
         "RAFIKI_SUPERVISOR_HEARTBEAT_S": "0.2",
         "RAFIKI_MESH_CHIPS_PER_HOST": "2"},
)
def host_loss_mid_sweep(tmp, check: CheckFn) -> None:
    import signal
    import subprocess
    import time as _time

    from rafiki_tpu_torch.obs import journal as journal_mod

    BUDGET, CHIPS, K = 8, 4, 2
    store, params, model = _train_env(tmp)
    job = _make_job(store, model, {"MODEL_TRIAL_COUNT": BUDGET})

    # Host 0's loss cannot be tick-scheduled: the epoch boundary that
    # unwinds host 1's aborted packs arrives at machine-dependent times,
    # and killing before the re-pack would test the supervisor-kill path,
    # not host ordering. So the body watches the shared journal dir for
    # the mesh/repack record and THEN kills the supervisor process: the
    # same SIGKILL a real host loss delivers, triggered by cluster state.
    argv = _sweep_proc_argv("run", store, params, job["id"], CHIPS, K) + ["--advisor", "random"]
    child = subprocess.Popen(argv, env=_sweep_proc_env(), stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True)
    log_dir = journal_mod.journal.log_dir
    deadline = _time.monotonic() + 120.0
    repacked = False
    try:
        while _time.monotonic() < deadline and child.poll() is None:
            if any(r.get("kind") == "mesh" and r.get("name") == "repack"
                   for r in journal_mod.read_dir(log_dir)):
                repacked = True
                break
            _time.sleep(0.1)
    finally:
        if child.poll() is None:
            child.send_signal(signal.SIGKILL)
        child.communicate(timeout=60)
    check("repack_seen_before_host0_loss", repacked,
          "mesh/repack never hit the journals before timeout/exit")
    check("supervisor_host_killed", child.returncode == -9, f"run rc={child.returncode}")

    # Survivors re-packed host 1's rows BEFORE host 0 died: the host-loss
    # and re-pack story is already in the journals.
    jrecs = journal_mod.read_dir(journal_mod.journal.log_dir)
    host_lost = [r for r in jrecs if r.get("kind") == "mesh" and r.get("name") == "host_lost"]
    check("host1_loss_journaled", any(r.get("host") == 1 for r in host_lost),
          f"host_lost records: {host_lost}")
    check("survivors_repacked", _journal_has(jrecs, "mesh", "repack"),
          "no mesh/repack journal record after host loss")

    _time.sleep(0.5)
    p2, summary = _sweep_proc("resume", store, params, job["id"], chips=CHIPS,
                              trials_per_chip=K, env=_sweep_proc_env(chaos=False),
                              stale_after_s=0.4)
    check("resume_completed", p2.returncode == 0,
          f"resume rc={p2.returncode}: {p2.stderr[-800:]}")
    check("resume_adopted_orphans", summary.get("adopted", 0) >= 1, summary)
    _check_rows(check, store, job["id"], expect=BUDGET)
    _wal_checks(check, store, job["id"])


# A wider-lr sibling of ChaosFF for the early-kill scenario. The GP's
# seed-0 warm-up draws over this LINEAR lr range put {0.0127, 8.3e-4} on
# chip 0 (global round-robin) and {0.0054, 3.4e-4} on chip 1: chip 0's
# strong learner sets best-so-far, and on the delayed chip 1 the 3.4e-4
# member's flat curve is condemned by the predictor while its 0.0054
# pack-mate's rising curve survives and is speculated. 8 epochs keep a
# window of several epochs open between the kill and the pack's end for
# the state-triggered SIGKILL.
EK_SOURCE = b"""
from rafiki_tpu_torch.model.base import TorchModel
from rafiki_tpu_torch.model.knobs import FixedKnob, FloatKnob
from rafiki_tpu_torch.models.ff import _Mlp

class ChaosEkFF(TorchModel):
    @staticmethod
    def get_knob_config():
        return {
            "hidden_units": FixedKnob(24),
            "learning_rate": FloatKnob(1e-5, 0.02, is_exp=False),
            "batch_size": FixedKnob(32),
            "epochs": FixedKnob(8),
        }

    def build_module(self, num_classes, input_shape):
        return _Mlp(hidden_layers=1, hidden_units=int(self.knobs["hidden_units"]),
                    num_classes=num_classes, input_shape=input_shape)
"""


def _ek_env(tmp):
    from rafiki_tpu_torch.store import MetaStore, ParamsStore

    store = MetaStore(tmp / "meta.sqlite3")
    params = ParamsStore(tmp / "params")
    model = store.create_model("chaosekff", "IMAGE_CLASSIFICATION", None, EK_SOURCE, "ChaosEkFF")
    return store, params, model


def _uncorrected_spec_hashes(recs) -> set:
    """Hashes with an ``advisor/speculate`` record and no
    ``advisor/feedback`` record anywhere in the stream: the speculations
    a crash would leave in flight."""
    specs = {r.get("knobs_hash") for r in recs
             if r.get("kind") == "advisor" and r.get("name") == "speculate"}
    fed = {r.get("knobs_hash") for r in recs
           if r.get("kind") == "advisor" and r.get("name") == "feedback"}
    return specs - fed


@scenario(
    "early-kill-mid-pack-resume",
    "SIGKILL the sweep supervisor at the worst curve-advisor moment: "
    "a pack member was just early-killed by the learning-curve "
    "predictor and its surviving packmates' speculative scores sit in "
    "the GP uncorrected (the true scores never landed). Resume must "
    "reconcile the WAL with zero double-claimed slots, rehydrate the "
    "advisor from journals alone — real observations plus the "
    "in-flight speculations, byte-identical proposals proven by "
    "rehydrating twice from the same records — and finish the job "
    "with the SAME best score and knob set as an unfaulted kill-on "
    "run under the same seeds.",
    spec="seed=37;worker.epoch:delay:delay=0.25:match=mesh-c1",
    env={"RAFIKI_CHECKPOINT_EVERY": "1",
         "RAFIKI_SUPERVISOR_HEARTBEAT_S": "0.2",
         "RAFIKI_CURVE_KILL": "1",
         "RAFIKI_CURVE_SPECULATE": "1",
         # 5 observations before a verdict (the curves are noisy at 1/64
         # val granularity) and a wide margin, so only the flat
         # chance-level member is condemned, never its rising pack-mate.
         "RAFIKI_CURVE_KILL_MIN_OBS": "5",
         "RAFIKI_CURVE_KILL_MARGIN": "0.35"},
)
def early_kill_mid_pack_resume(tmp, check: CheckFn) -> None:
    import json as _json
    import signal
    import subprocess
    import time as _time

    from rafiki_tpu_torch.advisor.rehydrate import rehydrate_advisor
    from rafiki_tpu_torch.advisor.service import AdvisorService
    from rafiki_tpu_torch.model.base import load_model_class
    from rafiki_tpu_torch.obs import journal as journal_mod

    # Budget == GP n_initial: every claim is a seed-deterministic warm-up
    # proposal, so ONE unfaulted run is a complete reference. Chip 0 runs
    # undelayed and sets best-so-far; the worker.epoch delay pinned to
    # chip 1 (match=mesh-c1) holds its pack mid-flight until a best
    # exists, so the doomed member's verdict fires with a live pack-mate
    # still training.
    BUDGET, CHIPS, K = 4, 2, 2
    fd = tmp / "faulted"
    fd.mkdir(parents=True, exist_ok=True)
    store, params, model = _ek_env(fd)
    job = _make_job(store, model, {"MODEL_TRIAL_COUNT": BUDGET})

    # The SIGKILL cannot be tick-scheduled: the kill epoch arrives at
    # machine-dependent times. Watch the shared journal dir for the
    # advisor/kill record AND an uncorrected advisor/speculate record (the
    # backfill that follows the eviction speculates the pack-mate), then
    # kill the supervisor: a just-killed member, a speculation in flight.
    argv = _sweep_proc_argv("run", store, params, job["id"], CHIPS, K) + [
        "--advisor", "gp", "--advisor-kwargs", '{"n_initial": 4}']
    child = subprocess.Popen(argv, env=_sweep_proc_env(), stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True)
    log_dir = journal_mod.journal.log_dir
    deadline = _time.monotonic() + 150.0
    killed_seen = spec_in_flight = False
    try:
        while _time.monotonic() < deadline and child.poll() is None:
            recs = journal_mod.read_dir(log_dir)
            killed_seen = _journal_has(recs, "advisor", "kill")
            spec_in_flight = bool(_uncorrected_spec_hashes(recs))
            if killed_seen and spec_in_flight:
                break
            _time.sleep(0.02)
    finally:
        if child.poll() is None:
            child.send_signal(signal.SIGKILL)
        _, err = child.communicate(timeout=60)
    check("kill_seen_before_crash", killed_seen, "no advisor/kill record before timeout/exit")
    check("speculation_in_flight_at_crash", spec_in_flight,
          "no uncorrected advisor/speculate record at the crash")
    check("supervisor_killed", child.returncode == -9,
          f"run rc={child.returncode}: {(err or '')[-500:]}")

    # Byte-identity at the crash point: rehydrate the advisor TWICE from
    # the same frozen journal snapshot and store rows (real scores first,
    # then in-flight speculations) and the post-resume proposals must
    # match byte for byte.
    crash_recs = journal_mod.read_dir(log_dir)
    sub = store.get_sub_train_jobs(job["id"])[0]
    aid = sub.get("advisor_id")
    check("advisor_id_persisted", bool(aid), f"sub row: {sub}")
    model_row = store.get_model(sub["model_id"])
    model_cls = load_model_class(model_row["model_file"], model_row["model_class"])
    completed = [t for t in store.get_trials_of_train_job(job["id"])
                 if t["status"] == "COMPLETED" and t.get("score") is not None]
    batches = []
    for _ in range(2):
        svc = AdvisorService()
        rehydrate_advisor(svc, model_cls.get_knob_config(), kind="gp", advisor_id=aid,
                          completed=completed, journal_records=crash_recs, seed=0,
                          engine_kwargs={"n_initial": 4}, job_id=job["id"])
        batches.append(_json.dumps(svc.get(aid).propose_batch(K), sort_keys=True))
    check("rehydrated_proposals_byte_match", batches[0] == batches[1],
          f"{batches[0][:200]} vs {batches[1][:200]}")

    _time.sleep(0.5)
    p2, summary = _sweep_proc("resume", store, params, job["id"], chips=CHIPS,
                              trials_per_chip=K, env=_sweep_proc_env(chaos=False),
                              stale_after_s=0.4)
    check("resume_completed", p2.returncode == 0,
          f"resume rc={p2.returncode}: {p2.stderr[-800:]}")
    check("resume_adopted_orphans", summary.get("adopted", 0) >= 1, summary)

    trials = store.get_trials_of_train_job(job["id"])
    check("exact_trial_rows", len(trials) == BUDGET, f"{len(trials)} rows for budget {BUDGET}")
    check("no_duplicate_rows", len({t["id"] for t in trials}) == len(trials), "duplicate ids")
    bad = [t["id"] for t in trials if t["status"] not in ("COMPLETED", "ERRORED")]
    check("all_trials_terminal", not bad, f"non-terminal: {bad}")
    check("killed_trial_errored", any(t["status"] == "ERRORED" for t in trials),
          "no ERRORED row: the pre-crash kill vanished on resume")
    # WAL reconcile: zero double-claimed slots despite the kill, the crash
    # and the adoption churn.
    _wal_checks(check, store, job["id"])

    # The unfaulted kill-on reference under the same seeds, its own
    # journal dir: the same best score, the same knob set, the same kill.
    rd = tmp / "reference"
    rd.mkdir(parents=True, exist_ok=True)
    rstore, rparams, rmodel = _ek_env(rd)
    rjob = _make_job(rstore, rmodel, {"MODEL_TRIAL_COUNT": BUDGET})
    p3, _ = _sweep_proc("run", rstore, rparams, rjob["id"], chips=CHIPS, trials_per_chip=K,
                        env=_sweep_proc_env({"RAFIKI_LOG_DIR": str(rd / "obs")}, chaos=False),
                        advisor="gp", advisor_kwargs='{"n_initial": 4}')
    check("reference_completed", p3.returncode == 0,
          f"reference rc={p3.returncode}: {p3.stderr[-500:]}")
    rtrials = rstore.get_trials_of_train_job(rjob["id"])
    best_f = max((t["score"] for t in trials if t["score"] is not None), default=None)
    best_r = max((t["score"] for t in rtrials if t["score"] is not None), default=None)
    check("best_score_matches_unfaulted", best_f is not None and best_f == best_r,
          f"faulted {best_f} vs unfaulted {best_r}")
    knobs_f = sorted(_json.dumps(t["knobs"], sort_keys=True) for t in trials)
    knobs_r = sorted(_json.dumps(t["knobs"], sort_keys=True) for t in rtrials)
    check("knob_set_matches_unfaulted", knobs_f == knobs_r,
          "resumed sweep explored different knobs than unfaulted run")
