"""The learning-curve early kill and speculative scoring in the port,
against the JAX package's, on the CPU.

* the extrapolator (``advisor/curve.py``): every fit of seeded point
  sets, its record, its overlay points and every kill-rule verdict equal
  the JAX package's exactly (float64 numpy on the host, same operations);
* the coordinator and the advisor audit: one scripted sequence of
  proposals, curve points, verdicts, speculations, consolation and real
  scores writes the same ``advisor/*`` records in both packages, field
  for field (timestamps, pids, roles, trace ids and the GP's fit seconds
  aside);
* the off polarity: with both switches off the coordinator is None, a
  disabled one changes no byte of a GP stream, and a worker completes
  every trial with the GP stream it proposes without a coordinator;
* the serial kill: a worker's doomed trial ends ERRORED
  ``early_killed`` with its predicted score as consolation, from a
  scripted model and from a TorchModel whose train loop the kill leaves
  between epochs;
* the packed kill: a float32 pack whose member is killed leaves its
  survivors bit-equal to their serial trials, and within ``F32_TOL`` of
  the JAX package's pack with the same kill; the worker's packed arm
  does the kill's bookkeeping before the backfill and scores no killed
  member;
* speculations in flight rehydrate byte-identically from a journal of
  either package, into either package's advisor.
"""

import json
import math
import pickle

import numpy as np
import pytest
import torch

import rafiki_tpu.model.knobs as jax_knobs
import rafiki_tpu_torch.model.knobs as port_knobs
from rafiki_tpu.advisor import curve as jax_curve
from rafiki_tpu.advisor.rehydrate import rehydrate_advisor as jax_rehydrate
from rafiki_tpu.advisor.service import AdvisorService as JaxAdvisorService
from rafiki_tpu.advisor.speculative import CurveCoordinator as JaxCurveCoordinator
from rafiki_tpu.obs.journal import journal as jax_journal, read_dir as jax_read_dir
from rafiki_tpu.obs.search.ledger import search_ledger as jax_search_ledger
from rafiki_tpu_torch import telemetry
from rafiki_tpu_torch.advisor import curve
from rafiki_tpu_torch.advisor.app import AdvisorApp, HttpAdvisorHandle
from rafiki_tpu_torch.advisor.gp import GpAdvisor
from rafiki_tpu_torch.advisor.rehydrate import journal_speculations, rehydrate_advisor
from rafiki_tpu_torch.advisor.service import AdvisorService
from rafiki_tpu_torch.advisor.speculative import CurveCoordinator
from rafiki_tpu_torch.model.base import BaseModel, load_model_class
from rafiki_tpu_torch.model.log import logger
from rafiki_tpu_torch.obs.journal import journal, read_dir
from rafiki_tpu_torch.obs.search.audit import knobs_hash
from rafiki_tpu_torch.obs.search.ledger import search_ledger
from rafiki_tpu_torch.store import MetaStore, ParamsStore
from rafiki_tpu_torch.utils.events import events
from rafiki_tpu_torch.utils.httpd import start_server
from rafiki_tpu_torch.utils.serial import load_flat
from rafiki_tpu_torch.worker.train import TrainWorker
from tests.test_torch_pack import (FF_INIT, FF_KNOBS, TRAIN, VAL, XPKG_MEMBERS, JaxFFConst,
                                   PortFFConst, _jax_params, _pack_readings, _params)
from tests.test_torch_train import F32_TOL

# See test_torch_train.py: two intra-op threads per xdist worker.
torch.set_num_threads(2)

CURVE_RECORD_NAMES = {"predict", "kill", "speculate", "correct", "false_kill"}
#: Fields a journal stamps by process and clock, left out of comparisons.
VOLATILE = {"ts", "pid", "role", "trace_id"}


def _knob_config(k):
    return {"lr": k.FloatKnob(1e-4, 1e-1, is_exp=True),
            "units": k.IntegerKnob(4, 64),
            "b": k.FixedKnob(8)}


def _saturating(final, e, tau=2.0):
    return final * (1.0 - math.exp(-(e + 1) / tau))


@pytest.fixture
def journaled(tmp_path):
    """Both packages' journals (port in tmp/port, JAX in tmp/jax) and
    clean search ledgers, back to pristine afterwards."""
    for led in (search_ledger, jax_search_ledger):
        led.reset()
    journal.configure(tmp_path / "port", role="test")
    jax_journal.configure(tmp_path / "jax", role="test")
    try:
        yield tmp_path
    finally:
        journal.close()
        jax_journal.close()
        for led in (search_ledger, jax_search_ledger):
            led.reset()


def _advisor_records(log_dir, read):
    out = []
    for r in read(log_dir):
        if r.get("kind") != "advisor":
            continue
        r = {k: v for k, v in r.items() if k not in VOLATILE}
        if isinstance(r.get("acquisition"), dict):
            r["acquisition"] = {k: v for k, v in r["acquisition"].items() if k != "fit_s"}
        out.append(r)
    return out


# -- the extrapolator -------------------------------------------------------------


def _point_sets(seed):
    """Seeded (epoch, score) prefixes: rising, flat, noisy, falling and
    short curves, with an unsorted order and a NaN now and then."""
    rng = np.random.default_rng(seed)
    sets = []
    for _ in range(24):
        n = int(rng.integers(1, 9))
        final = float(rng.uniform(0.05, 0.98))
        tau = float(rng.uniform(0.3, 6.0))
        noise = float(rng.choice([0.0, 1e-3, 2e-2, 1e-1]))
        pts = [(e, final * (1.0 - math.exp(-(e + 1) / tau)) + float(rng.normal(0.0, noise)))
               for e in range(n)]
        if rng.random() < 0.2:
            pts = [(e, 1.0 - s) for e, s in pts]  # a falling curve
        if rng.random() < 0.2 and pts:
            pts[int(rng.integers(0, len(pts)))] = (pts[0][0], float("nan"))
        rng.shuffle(pts)
        sets.append((pts, int(rng.integers(1, 20))))
    return sets


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_fits_records_and_verdicts_equal_the_jax_packages(seed):
    configs = [(curve.KillConfig(enabled=True, warmup_epochs=w, margin=m, min_obs=o),
                jax_curve.KillConfig(enabled=True, warmup_epochs=w, margin=m, min_obs=o))
               for w, m, o in ((2, 0.02, 3), (1, 0.0, 2), (3, 0.35, 5))]
    n_fits = 0
    for pts, horizon in _point_sets(seed):
        got, want = curve.fit_curve(pts, horizon), jax_curve.fit_curve(pts, horizon)
        assert (got is None) == (want is None)
        if got is None:
            continue
        n_fits += 1
        assert got.to_record() == want.to_record()
        assert (got.predicted_final, got.band, got.rmse, got.decay) == \
            (want.predicted_final, want.band, want.rmse, want.decay)
        finite = [(e, s) for e, s in pts if math.isfinite(s)]
        assert curve.predict_points(got, finite) == jax_curve.predict_points(want, finite)
        for port_cfg, jax_cfg in configs:
            for epoch in range(0, 6):
                for best in (None, 0.2, 0.5, 0.9):
                    assert port_cfg.should_kill(got, epoch, best) == \
                        jax_cfg.should_kill(want, epoch, best)
    assert n_fits >= 12


def test_kill_config_and_coordinator_from_env(monkeypatch):
    for var in ("RAFIKI_CURVE_KILL", "RAFIKI_CURVE_SPECULATE"):
        monkeypatch.delenv(var, raising=False)
    assert CurveCoordinator.from_env() is None
    assert curve.KillConfig.from_env() == curve.KillConfig()
    monkeypatch.setenv("RAFIKI_CURVE_KILL", "1")
    monkeypatch.setenv("RAFIKI_CURVE_KILL_WARMUP", "3")
    monkeypatch.setenv("RAFIKI_CURVE_KILL_MARGIN", "0.35")
    monkeypatch.setenv("RAFIKI_CURVE_KILL_MIN_OBS", "5")
    coord = CurveCoordinator.from_env()
    assert coord is not None and coord.config.enabled and not coord.config.speculate
    assert vars(coord.config) == vars(jax_curve.KillConfig.from_env())
    monkeypatch.delenv("RAFIKI_CURVE_KILL")
    monkeypatch.setenv("RAFIKI_CURVE_SPECULATE", "1")
    coord = CurveCoordinator.from_env()
    assert coord is not None and coord.config.speculate and not coord.config.enabled


# -- the coordinator and the audit, against the JAX package --------------------------


def _decision_sequence(pkg):
    """One scripted GP sweep with the curve plane on, in ``pkg``: a real
    score, a doomed curve killed at its first eligible boundary and fed
    its predicted score, a rising curve speculated and then corrected,
    then a constant-liar draft from the refit GP."""
    if pkg == "jax":
        svc, coord_cls, cfg_cls, k = JaxAdvisorService(), JaxCurveCoordinator, \
            jax_curve.KillConfig, jax_knobs
        from rafiki_tpu.obs.search import audit as audit_mod
    else:
        svc, coord_cls, cfg_cls, k = AdvisorService(), CurveCoordinator, curve.KillConfig, \
            port_knobs
        from rafiki_tpu_torch.obs.search import audit as audit_mod
    aid = svc.create_advisor(_knob_config(k), kind="gp", seed=0, advisor_id="adv-seq",
                             engine_kwargs={"n_initial": 3})
    svc.get(aid).job_id = "job-seq"
    adv = svc.get(aid)
    coord = coord_cls(cfg_cls(enabled=True, speculate=True, warmup_epochs=2, margin=0.02,
                              min_obs=3))
    kn = svc.propose_batch(aid, 3)
    svc.feedback(aid, 0.8, kn[0])
    coord.note_scored(kn[0], 0.8)
    killed_at = None
    for e in range(5):
        coord.observe(kn[1], e, _saturating(0.2, e), trial_id="t-doomed", horizon=8)
        fit = coord.kill_verdict(kn[1], e, trial_id="t-doomed")
        if fit is not None:
            killed_at = e
            coord.note_done(kn[1])
            audit_mod.note_doomed(kn[1])
            svc.feedback(aid, fit.predicted_final, kn[1])
            break
    for e in range(3):
        coord.observe(kn[2], e, _saturating(0.75, e), trial_id="t-rising")
    assert coord.speculate_inflight(adv) == 1
    assert coord.speculate_inflight(adv) == 0
    svc.feedback(aid, 0.74, kn[2])
    coord.note_scored(kn[2], 0.74)
    batch = svc.propose_batch(aid, 2)
    return killed_at, kn + batch


def test_the_same_decisions_write_the_same_advisor_records(journaled):
    got_at, got_knobs = _decision_sequence("port")
    want_at, want_knobs = _decision_sequence("jax")
    assert got_at == want_at == 2
    assert got_knobs == want_knobs
    journal.close()
    jax_journal.close()
    got = _advisor_records(journaled / "port", read_dir)
    want = _advisor_records(journaled / "jax", jax_read_dir)
    assert [(r["name"]) for r in got] == [(r["name"]) for r in want]
    assert {"propose", "propose_batch", "feedback", "predict", "kill", "speculate",
            "correct"} <= {r["name"] for r in got}
    for a, b in zip(got, want):
        assert a == b, (a, b)
    snap, jsnap = search_ledger.snapshot(), jax_search_ledger.snapshot()
    for key in ("n_proposed", "n_scored", "n_doomed", "n_pending", "n_killed",
                "n_speculations", "n_corrections", "best_score", "regret"):
        assert snap[key] == jsnap[key], key
    assert (snap["n_killed"], snap["n_doomed"], snap["n_corrections"]) == (1, 1, 1)


# -- off polarity ------------------------------------------------------------------


def test_disabled_coordinator_leaves_gp_stream_byte_identical(journaled):
    kc = _knob_config(port_knobs)

    def _stream(coord):
        adv = GpAdvisor(kc, seed=11, n_initial=3)
        out = []
        for t in range(5):
            knobs = adv.propose()
            out.append(knobs)
            score = 0.5 + 0.1 * math.sin(t)
            if coord is not None:
                for e in range(4):
                    coord.observe(knobs, e, _saturating(score, e))
                    assert coord.kill_verdict(knobs, e) is None
                assert coord.speculate_inflight(adv) == 0
            adv.feedback(score, knobs)
            if coord is not None:
                coord.note_scored(knobs, score)
        return json.dumps(out, sort_keys=True)

    plain = _stream(None)
    assert plain == _stream(CurveCoordinator(curve.KillConfig()))  # both switches off
    journal.close()
    assert not [r for r in read_dir(journaled / "port")
                if r.get("kind") == "advisor" and r.get("name") in CURVE_RECORD_NAMES]


# -- the serial kill -----------------------------------------------------------------


class _Recorder:
    """Advisor handle that scripts proposals and records feedback."""

    def __init__(self, finals):
        self.finals = list(finals)
        self.feedbacks = []

    def propose(self):
        return {"final": self.finals.pop(0), "epochs": 6}

    def feedback(self, score, knobs):
        self.feedbacks.append((knobs["final"], score))


class _CurveModel(BaseModel):
    """Logs a saturating acc curve toward its ``final`` knob."""

    def __init__(self, final, epochs):
        super().__init__(final=final, epochs=epochs)
        self.final, self.epochs = final, epochs

    @staticmethod
    def get_knob_config():
        return {"final": port_knobs.FloatKnob(0.05, 0.95), "epochs": port_knobs.FixedKnob(6)}

    def train(self, uri):
        for e in range(self.epochs):
            logger.log(epoch=e, acc=_saturating(self.final, e),
                       loss=1.0 - _saturating(self.final, e))

    def evaluate(self, uri):
        return self.final

    def predict(self, queries):
        return []

    def dump_parameters(self):
        return b"params"


def _store(tmp_path):
    store = MetaStore(tmp_path / "meta.sqlite3")
    params = ParamsStore(tmp_path / "params")
    mrow = store.create_model("curvekill", "IMAGE_CLASSIFICATION", None, b"x = 1", "X")
    job = store.create_train_job("app", "IMAGE_CLASSIFICATION", None, TRAIN, VAL, {})
    sub = store.create_sub_train_job(job["id"], mrow["id"])
    return store, params, sub


def _worker(tmp_path, model_cls, advisor, monkeypatch, kill, **kw):
    for var in ("RAFIKI_CURVE_KILL", "RAFIKI_CURVE_SPECULATE"):
        monkeypatch.delenv(var, raising=False)
    if kill:
        monkeypatch.setenv("RAFIKI_CURVE_KILL", "1")
    store, params, sub = _store(tmp_path)
    worker = TrainWorker(store, params, sub["id"], model_cls, advisor, TRAIN, VAL, {},
                         worker_id="curve-w0", async_persist=False, **kw)
    return store, worker


def test_serial_worker_kills_the_doomed_trial(journaled, monkeypatch):
    adv = _Recorder([0.9, 0.1])
    store, worker = _worker(journaled, _CurveModel, adv, monkeypatch, kill=True)
    killed0 = telemetry.get_counter("worker.trials_killed")
    healthy = worker.run_trial(adv.propose())
    doomed = worker.run_trial(adv.propose())
    assert healthy["status"] == "COMPLETED" and healthy["score"] == 0.9
    assert doomed["status"] == "ERRORED" and doomed["error"].startswith("early_killed: ")
    # The consolation feedback is the conservative PREDICTED score.
    assert adv.feedbacks[0] == (0.9, 0.9)
    killed_final, consolation = adv.feedbacks[1]
    assert killed_final == 0.1 and 0.0 < consolation < 0.9 - 0.02
    assert telemetry.get_counter("worker.trials_killed") == killed0 + 1
    journal.close()
    recs = [r for r in read_dir(journaled / "port") if r.get("kind") == "advisor"]
    kills = [r for r in recs if r["name"] == "kill"]
    # The first eligible boundary: warmup 2 and min_obs 3 meet at epoch 2.
    assert len(kills) == 1 and kills[0]["epoch"] == 2 and kills[0]["best_so_far"] == 0.9
    assert kills[0]["trial_id"] == doomed["id"]
    assert any(r["name"] == "predict" for r in recs)
    # The trial's log holds the epochs it trained, and no more.
    epochs = [e["values"]["epoch"] for e in store.get_trial_logs(doomed["id"])
              if e.get("type") == "values"]
    assert epochs == [0, 1, 2]
    assert search_ledger.snapshot()["n_killed"] == 1


def test_serial_worker_off_polarity_completes_everything(journaled, monkeypatch):
    adv = _Recorder([0.9, 0.1])
    store, worker = _worker(journaled, _CurveModel, adv, monkeypatch, kill=False)
    assert worker.curve is None
    assert worker.run_trial(adv.propose())["status"] == "COMPLETED"
    assert worker.run_trial(adv.propose())["status"] == "COMPLETED"
    assert [s for _, s in adv.feedbacks] == [0.9, 0.1]
    journal.close()
    assert not [r for r in read_dir(journaled / "port")
                if r.get("kind") == "advisor" and r.get("name") in CURVE_RECORD_NAMES]
    assert search_ledger.snapshot()["n_killed"] == 0


FF_SRC = b"""
from rafiki_tpu_torch.model.base import TorchModel
from rafiki_tpu_torch.model.knobs import FixedKnob, FloatKnob
from rafiki_tpu_torch.models.ff import _Mlp


class CurveFF(TorchModel):
    @staticmethod
    def get_knob_config():
        return {"learning_rate": FloatKnob(1e-4, 1e-1, is_exp=True),
                "batch_size": FixedKnob(64), "epochs": FixedKnob(4), "seed": FixedKnob(0)}

    def build_module(self, num_classes, input_shape):
        return _Mlp(1, 32, num_classes, input_shape)
"""


def _gp_job(tmp_path, n_trials):
    store = MetaStore(tmp_path / "meta.sqlite3")
    params = ParamsStore(tmp_path / "params")
    cls = load_model_class(FF_SRC, "CurveFF")
    mrow = store.create_model("curveff", "IMAGE_CLASSIFICATION", None, FF_SRC, "CurveFF")
    job = store.create_train_job("app", "IMAGE_CLASSIFICATION", None, TRAIN, VAL,
                                 {"MODEL_TRIAL_COUNT": n_trials})
    sub = store.create_sub_train_job(job["id"], mrow["id"])
    return store, params, cls, sub


@pytest.mark.parametrize("coordinator", ["none", "disabled"])
def test_off_switch_completes_every_trial_with_the_same_gp_stream(tmp_path, monkeypatch,
                                                                  coordinator):
    """A GP worker with both switches off (no coordinator at all) and one
    handed a disabled coordinator run the same job: every trial
    completes, and the proposals and scores are byte-identical to the
    advisor's stream with no worker in between (the same scores fed to a
    fresh GP of the same seed propose the same knobs)."""
    for var in ("RAFIKI_CURVE_KILL", "RAFIKI_CURVE_SPECULATE"):
        monkeypatch.delenv(var, raising=False)
    store, params, cls, sub = _gp_job(tmp_path, 5)
    svc = AdvisorService()
    aid = svc.create_advisor(cls.get_knob_config(), kind="gp", seed=4,
                             engine_kwargs={"n_initial": 3})
    from rafiki_tpu_torch.worker.train import InProcAdvisorHandle

    worker = TrainWorker(store, params, sub["id"], cls, InProcAdvisorHandle(svc, aid), TRAIN,
                         VAL, {"MODEL_TRIAL_COUNT": 5}, devices=[torch.device("cpu")],
                         async_persist=False)
    assert worker.curve is None
    if coordinator == "disabled":
        worker.curve = CurveCoordinator(curve.KillConfig())
    assert worker.run() == 5
    trials = sorted(store.get_trials_of_sub_train_job(sub["id"]), key=lambda t: t["no"])
    assert [t["status"] for t in trials] == ["COMPLETED"] * 5
    stream = json.dumps([(t["knobs"], t["score"]) for t in trials], sort_keys=True)
    replay = GpAdvisor(cls.get_knob_config(), seed=4, n_initial=3)
    again = []
    for t in trials:
        knobs = replay.propose()
        again.append((knobs, t["score"]))
        replay.feedback(t["score"], knobs)
    assert json.dumps(again, sort_keys=True) == stream


def test_torch_model_trial_is_killed_between_epochs(journaled, monkeypatch):
    """A TorchModel trial's kill comes out of ``logger.log`` between two
    epochs: the trial ends ERRORED after the epochs it trained, its model
    is destroyed, and the worker's next trial trains normally."""

    class _Scripted:
        def __init__(self):
            self.fed = []

        def propose(self):
            return dict(learning_rate=1e-3, batch_size=64, epochs=4, seed=0)

        def feedback(self, score, knobs):
            self.fed.append(score)

    adv = _Scripted()
    cls = load_model_class(FF_SRC, "CurveFF")
    destroyed = []
    orig = cls.destroy
    monkeypatch.setattr(cls, "destroy", lambda self: (destroyed.append(self), orig(self)))
    store, worker = _worker(journaled, cls, adv, monkeypatch, kill=True,
                            devices=[torch.device("cpu")])
    # A best-so-far no curve reaches, and a rule that decides after two
    # epochs: the trial is condemned at epoch 1.
    worker.curve = CurveCoordinator(curve.KillConfig(enabled=True, warmup_epochs=2, min_obs=2,
                                                     margin=0.0))
    worker.curve.note_scored({"elsewhere": 1}, 2.0)
    row = worker.run_trial(adv.propose())
    assert row["status"] == "ERRORED" and row["error"].startswith("early_killed: ")
    assert "at epoch 1" in row["error"]
    epochs = [e["values"]["epoch"] for e in store.get_trial_logs(row["id"])
              if e.get("type") == "values"]
    assert epochs == [0, 1]
    assert len(destroyed) == 1 and destroyed[0]._loop is None
    assert len(adv.fed) == 1 and adv.fed[0] < 2.0
    worker.curve = None
    assert worker.run_trial(adv.propose())["status"] == "COMPLETED"


# -- the packed kill -----------------------------------------------------------------


def _kill_pack(side, members, epochs, kill_at):
    """One float32 ``train_packed`` in ``side`` with a kill predicate that
    condemns member ``kill_at[0]`` at epoch ``kill_at[1]``; per-member
    rows (history, params, score of the survivors) and the evictions."""
    cls = JaxFFConst if side == "jax" else PortFFConst
    cls.STOP_LR = None
    knobs = dict(FF_KNOBS, epochs=epochs)
    models = []
    for lr, _, seed in members:
        m = cls(**dict(knobs, learning_rate=lr)) if side == "jax" else \
            cls(device="cpu", **dict(knobs, learning_rate=lr))
        m._seed = seed
        models.append(m)
    evicted, consulted = [], []

    def predicate(mi, e, metrics):
        consulted.append((mi, e, isinstance(metrics.get("acc"), float)))
        return (mi, e) == kill_at

    histories = cls.train_packed(models, TRAIN, on_evict=lambda *a: evicted.append(a),
                                 kill_predicate=predicate)
    survivors = [i for i in range(len(models)) if i != kill_at[0]]
    scores = cls.evaluate_packed([models[i] for i in survivors], VAL)
    rows = []
    for i, m in enumerate(models):
        p = _jax_params(m) if side == "jax" else {k: v.numpy() for k, v in _params(m).items()}
        rows.append({"history": histories[i], "params": p,
                     "score": scores[survivors.index(i)] if i in survivors else None})
    return rows, evicted, consulted, models


def test_packed_kill_leaves_survivors_equal_to_serial_and_to_the_jax_pack():
    """A k=3 float32 pack whose member 1 is killed at epoch 0: it leaves
    with reason ``"killed"`` while its pack-mates train on in the k=2
    program; each survivor's params are bit-equal to its serial trial's
    in the port, and the whole pack agrees with the JAX package's pack
    under the same predicate within F32_TOL (readings: as the
    straggler's, loss 2.3e-7 rel and params under 5e-6 max abs)."""
    members = [XPKG_MEMBERS[i] for i in (0, 1, 3)]
    got, got_ev, consulted, models = _kill_pack("port", members, 3, (1, 0))
    ref, ref_ev, ref_consulted, _ = _kill_pack("jax", members, 3, (1, 0))
    assert got_ev == ref_ev == [(1, 0, "killed")]
    assert consulted == ref_consulted
    assert all(is_float for _, _, is_float in consulted)
    assert [len(r["history"]) for r in got] == [3, 1, 3]
    for i in (0, 2):
        lr, _, seed = members[i]
        serial = PortFFConst(device="cpu", **dict(FF_KNOBS, epochs=3, learning_rate=lr))
        serial._seed = seed
        serial.train(TRAIN)
        want = _params(serial)
        got_p = _params(models[i])
        assert set(got_p) == set(want) and all(torch.equal(got_p[k], want[k]) for k in want)
        assert got[i]["score"] == serial.evaluate(VAL)
    start = {k: v.float().numpy() for k, v in load_flat(pickle.loads(FF_INIT)["packed"]).items()}
    r = _pack_readings([ref[i] for i in (0, 2)], [got[i] for i in (0, 2)], start)
    print(r)
    for key in r:
        assert r[key] <= F32_TOL[key], (key, r)
    # The killed member's one epoch agrees too.
    ea, eb = ref[1]["history"][0], got[1]["history"][0]
    assert abs(ea["loss"] - eb["loss"]) / abs(ea["loss"]) <= F32_TOL["loss_rel"]


class _KillLr(CurveCoordinator):
    """Condemns the trial at ``lr`` at its epoch 0 against a best-so-far
    of 0.5, journaled as a real verdict is (``advisor/predict`` and
    ``advisor/kill``, with a fit that carries a prediction), and nothing
    else. ``speculate``: the speculation switch, for an advisor that
    takes speculations."""

    def __init__(self, lr, speculate=True):
        super().__init__(curve.KillConfig(enabled=True, speculate=speculate, min_obs=1))
        self.lr = lr
        self._best = 0.5

    def kill_verdict(self, knobs, epoch, trial_id=None):
        if knobs["learning_rate"] != self.lr or epoch != 0:
            return None
        from rafiki_tpu_torch.obs.search import audit as search_audit

        fit = curve.fit_curve([(0, 0.1), (1, 0.1)], 2)
        search_audit.record_predict(knobs, fit.to_record(), epoch=epoch, best_so_far=0.5,
                                    trial_id=trial_id)
        search_audit.record_kill(knobs, fit.to_record(), epoch=epoch, best_so_far=0.5,
                                 config={"warmup_epochs": 0, "margin": 0.0, "min_obs": 1},
                                 trial_id=trial_id)
        return fit


def test_packed_worker_kill_books_before_the_backfill_and_scores_no_killed_member(
        tmp_path, monkeypatch):
    from tests.test_torch_pack import PACK_SRC, _ScriptedAdvisor

    store = MetaStore(tmp_path / "meta.sqlite3")
    params = ParamsStore(tmp_path / "params")
    cls = load_model_class(PACK_SRC, "PackFF")
    mrow = store.create_model("packff", "IMAGE_CLASSIFICATION", None, PACK_SRC, "PackFF")
    job = store.create_train_job("app", "IMAGE_CLASSIFICATION", None, TRAIN, VAL,
                                 {"MODEL_TRIAL_COUNT": 3})
    sub = store.create_sub_train_job(job["id"], mrow["id"])
    adv = _ScriptedAdvisor([1e-2, 3e-3, 1e-3])
    worker = TrainWorker(store, params, sub["id"], cls, adv, TRAIN, VAL,
                         {"MODEL_TRIAL_COUNT": 3}, devices=[torch.device("cpu")],
                         async_persist=False, trial_pack=2)
    worker.curve = _KillLr(3e-3, speculate=False)  # the scripted advisor takes none
    evaluated = []
    orig = cls.evaluate_packed.__func__
    monkeypatch.setattr(cls, "evaluate_packed", classmethod(
        lambda c, ms, uri: (evaluated.extend(m.knobs["learning_rate"] for m in ms),
                            orig(c, ms, uri))[1]))
    events.configure(tmp_path / "events")
    try:
        assert worker.run() == 3
        kills = list(events.read("trial_killed"))
        evictions = list(events.read("pack_member_evicted"))
    finally:
        events.close()
    rows = {t["knobs"]["learning_rate"]: t for t in store.get_trials_of_sub_train_job(sub["id"])}
    assert rows[3e-3]["status"] == "ERRORED"
    assert rows[3e-3]["error"].startswith("early_killed: predicted ")
    assert rows[1e-2]["status"] == rows[1e-3]["status"] == "COMPLETED"
    # The killed member leaves at epoch 0; the backfill takes its slot,
    # so the first member leaves "finished" while the backfill trains on.
    assert [(e["trial_id"], e["epoch"], e["reason"]) for e in evictions] == \
        [(rows[3e-3]["id"], 0, "killed"), (rows[1e-2]["id"], 1, "finished")]
    assert [e["trial_id"] for e in kills] == [rows[3e-3]["id"]]
    # The consolation feedback came before the backfill's proposal (1e-3)
    # was drafted, and the killed member was never evaluated.
    fed = [lr for _, kn in adv.fed for lr in [kn["learning_rate"]]]
    assert fed.index(3e-3) == 0
    assert 3e-3 not in evaluated and sorted(evaluated) == [1e-3, 1e-2]


# -- speculations rehydrate from either package's journal ---------------------------------


def _speculation_journal(pkg):
    """A GP sweep with one speculation still in flight, in ``pkg``'s journal."""
    svc = JaxAdvisorService() if pkg == "jax" else AdvisorService()
    k = jax_knobs if pkg == "jax" else port_knobs
    aid = svc.create_advisor(_knob_config(k), kind="gp", seed=0, advisor_id="adv-spec",
                             engine_kwargs={"n_initial": 2})
    kn = svc.propose_batch(aid, 3)
    svc.feedback(aid, 0.8, kn[0])
    svc.feedback(aid, 0.5, kn[1])
    svc.speculate(aid, 0.72, kn[2], fit={"family": "pow", "predicted": 0.72})
    return kn


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_speculations_rehydrate_byte_identically_from_either_packages_journal(journaled,
                                                                              writer):
    _speculation_journal(writer)
    journal.close()
    jax_journal.close()
    recs = (read_dir if writer == "port" else jax_read_dir)(journaled / writer)
    specs = journal_speculations(recs)
    assert len(specs) == 1 and specs[0][1] == 0.72 and specs[0][2]["family"] == "pow"

    port_svc, jax_svc = AdvisorService(), JaxAdvisorService()
    rehydrate_advisor(port_svc, _knob_config(port_knobs), "gp", "adv-spec", completed=[],
                      journal_records=recs, seed=0, engine_kwargs={"n_initial": 2})
    jax_rehydrate(jax_svc, _knob_config(jax_knobs), "gp", "adv-spec", completed=[],
                  journal_records=recs, seed=0, engine_kwargs={"n_initial": 2})
    got = json.dumps(port_svc.propose_batch("adv-spec", 2), sort_keys=True)
    assert got == json.dumps(jax_svc.propose_batch("adv-spec", 2), sort_keys=True)
    # Rehydrating twice is the same, and the speculation is load-bearing.
    again = AdvisorService()
    rehydrate_advisor(again, _knob_config(port_knobs), "gp", "adv-spec", completed=[],
                      journal_records=recs, seed=0, engine_kwargs={"n_initial": 2})
    assert json.dumps(again.propose_batch("adv-spec", 2), sort_keys=True) == got
    bare = AdvisorService()
    rehydrate_advisor(bare, _knob_config(port_knobs), "gp", "adv-spec", completed=[],
                      journal_records=[r for r in recs if r.get("name") != "speculate"],
                      seed=0, engine_kwargs={"n_initial": 2})
    assert json.dumps(bare.propose_batch("adv-spec", 2), sort_keys=True) != got


def test_speculate_inflight_sorted_once_and_retired(journaled):
    coord = CurveCoordinator(curve.KillConfig(speculate=True, min_obs=2))
    a, b, young = {"lr": 0.01}, {"lr": 0.02}, {"lr": 0.03}
    for e in range(3):
        coord.observe(a, e, _saturating(0.8, e))
        coord.observe(b, e, _saturating(0.6, e))
    coord.observe(young, 0, 0.1)  # below min_obs: not fed

    class _Sink:
        calls = []

        def speculate(self, score, knobs, fit=None):
            self.calls.append((score, dict(knobs), fit))

    sink = _Sink()
    assert coord.speculate_inflight(sink) == 2
    fed = [knobs_hash(k) for _, k, _ in sink.calls]
    assert fed == sorted(fed)
    assert all(f is not None and "predicted" in f for *_, f in sink.calls)
    assert coord.speculate_inflight(sink) == 0
    coord.note_scored(a, 0.8)
    coord.note_done(b)
    coord.observe(a, 3, 0.79)
    coord.observe(b, 3, 0.59)
    assert coord.speculate_inflight(sink) == 0


def test_a_process_workers_http_handle_speculates(journaled):
    """A process worker's advisor handle carries a speculation (score,
    knobs and the fit's record) over HTTP: the remote advisor takes it
    and journals what an in-process handle's speculation journals."""
    svc = AdvisorService()
    aid = svc.create_advisor(_knob_config(port_knobs), kind="gp", seed=0,
                             advisor_id="adv-http", engine_kwargs={"n_initial": 2})
    kn = svc.propose(aid)

    class _Sink:
        calls = []

        def speculate(self, score, knobs, fit=None):
            self.calls.append((score, dict(knobs), fit))

    coord, twin = (CurveCoordinator(curve.KillConfig(speculate=True, min_obs=2))
                   for _ in range(2))
    for e in range(3):
        for c in (coord, twin):
            c.observe(kn, e, _saturating(0.7, e))
    assert twin.speculate_inflight(_Sink()) == 1
    server, thread = start_server(AdvisorApp(svc, secret="s3cret"))
    try:
        handle = HttpAdvisorHandle(f"http://127.0.0.1:{server.server_port}", aid,
                                   secret="s3cret")
        assert coord.speculate_inflight(handle) == 1
        assert coord.speculate_inflight(handle) == 0
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=5)
    journal.close()
    score, knobs, fit = _Sink.calls[0]
    assert svc.get(aid)._speculative == {knobs_hash(kn): score}
    [rec] = [r for r in read_dir(journaled / "port") if r.get("name") == "speculate"]
    assert (rec["knobs"], rec["predicted"], rec["fit"]) == (knobs, score, fit)
