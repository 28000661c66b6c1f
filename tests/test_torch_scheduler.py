"""The port's train-job path (LocalScheduler -> TrainWorker -> advisor ->
model -> MetaStore/ParamsStore) against the JAX package's, on the CPU.

The same small job runs in both packages: a TinyFF template per package
(as ``tests/test_scheduler.py``), float32 compute, both starting each
trial from the same flax-drawn params, the random advisor from seed 0.
The knob sequences must be equal and the scores within
``tests/test_torch_ff.py``'s float32 bound; the port's best blob serves
in the JAX package.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rafiki_tpu.model.base import load_model_class as jax_load_model_class
from rafiki_tpu.models.ff import _Mlp as JaxMlp
from rafiki_tpu.scheduler import LocalScheduler as JaxLocalScheduler
from rafiki_tpu.store import MetaStore as JaxMetaStore, ParamsStore as JaxParamsStore
from rafiki_tpu_torch import telemetry
from rafiki_tpu_torch.advisor import AdvisorService
from rafiki_tpu_torch.model.base import load_model_class
from rafiki_tpu_torch.scheduler import LocalScheduler
from rafiki_tpu_torch.store import MetaStore, ParamsStore
from rafiki_tpu_torch.utils.backend import default_device, resolve_device
from rafiki_tpu_torch.utils.events import events
from rafiki_tpu_torch.worker.train import InProcAdvisorHandle, TrainWorker
from tests.test_torch_ff import F32_TOL
from tests.test_torch_train import flax_init_blob

# See test_torch_train.py: two intra-op threads per xdist worker.
torch.set_num_threads(2)

TRAIN = "synthetic://images?classes=5&n=256&w=8&h=8&seed=0"
VAL = "synthetic://images?classes=5&n=128&w=8&h=8&seed=1"
CPU = [torch.device("cpu")]

TEMPLATE = """
{imports}

INIT = {init!r}


class TinyFF({base}):
    @staticmethod
    def get_knob_config():
        return {{
            "hidden_units": CategoricalKnob([16, 32], affects_shape=True),
            "learning_rate": FloatKnob(1e-3, 3e-2, is_exp=True),
            "batch_size": FixedKnob(32),
            "epochs": FixedKnob(1),
        }}

    def build_module(self, num_classes, input_shape):
        return {module}

    def train(self, dataset_uri):
        # Every trial starts from the same flax-drawn params in both
        # packages; the warmup is planned before they are installed.
        self._planned_steps = 8
        self.load_parameters(INIT[int(self.knobs["hidden_units"])])
        super().train(dataset_uri)
"""
JAX_IMPORTS = """import jax.numpy as jnp
from rafiki_tpu.model.base import JaxModel
from rafiki_tpu.model.knobs import CategoricalKnob, FixedKnob, FloatKnob
from rafiki_tpu.models.ff import _Mlp"""
PORT_IMPORTS = """import torch
from rafiki_tpu_torch.model.base import TorchModel
from rafiki_tpu_torch.model.knobs import CategoricalKnob, FixedKnob, FloatKnob
from rafiki_tpu_torch.models.ff import _Mlp"""
JAX_MODULE = ("_Mlp(hidden_layers=1, hidden_units=int(self.knobs['hidden_units']), "
              "num_classes=num_classes, dtype=jnp.float32)")
PORT_MODULE = ("_Mlp(1, int(self.knobs['hidden_units']), num_classes, input_shape, "
               "dtype=torch.float32)")


@pytest.fixture(scope="module")
def sources():
    init = {h: flax_init_blob(JaxMlp(hidden_layers=1, hidden_units=h, num_classes=5,
                                     dtype=jnp.float32), (8, 8, 1), num_classes=5)
            for h in (16, 32)}
    return {
        "jax": TEMPLATE.format(imports=JAX_IMPORTS, init=init, base="JaxModel",
                               module=JAX_MODULE).encode(),
        "port": TEMPLATE.format(imports=PORT_IMPORTS, init=init, base="TorchModel",
                                module=PORT_MODULE).encode(),
    }


def make_job(store, source, budget, name="tinyff", cls="TinyFF"):
    model = store.create_model(name, "IMAGE_CLASSIFICATION", None, source, cls)
    job = store.create_train_job(name, "IMAGE_CLASSIFICATION", None, TRAIN, VAL, budget)
    store.create_sub_train_job(job["id"], model["id"])
    return job


def port_env(tmp_path):
    return MetaStore(tmp_path / "port.sqlite3"), ParamsStore(tmp_path / "port-params")


def test_same_random_job_in_both_packages(sources, tmp_path):
    jstore, jparams = JaxMetaStore(tmp_path / "jax.sqlite3"), JaxParamsStore(tmp_path / "jax-params")
    jjob = make_job(jstore, sources["jax"], {"MODEL_TRIAL_COUNT": 4})
    want = JaxLocalScheduler(jstore, jparams).run_train_job(
        jjob["id"], n_workers=1, devices=jax.devices("cpu")[:1], advisor_kind="random")
    store, params = port_env(tmp_path)
    job = make_job(store, sources["port"], {"MODEL_TRIAL_COUNT": 4})
    got = LocalScheduler(store, params).run_train_job(
        job["id"], n_workers=1, devices=CPU, advisor_kind="random")

    assert got.status == want.status == "COMPLETED"
    assert [t["knobs"] for t in got.trials] == [t["knobs"] for t in want.trials]
    assert len({t["knobs"]["learning_rate"] for t in got.trials}) == 4
    assert all(t["status"] == "COMPLETED" and t["params_id"] for t in got.trials)
    scores = [(t["score"], u["score"]) for t, u in zip(got.trials, want.trials)]
    assert max(abs(a - b) for a, b in scores) <= F32_TOL["score"], scores
    assert max(s for s, _ in scores) > 0.5  # the job learned: chance is 0.2
    assert got.best_trials[0]["score"] == max(s for s, _ in scores)

    # The port's best blob serves in the JAX package, as in test_torch_ff.
    best = got.best_trials[0]
    blob = params.load(best["params_id"])
    served = load_model_class(sources["port"], "TinyFF")(device="cpu", **best["knobs"])
    ref = jax_load_model_class(sources["jax"], "TinyFF")(**best["knobs"])
    served.load_parameters(blob)
    ref.load_parameters(blob)
    queries = np.random.default_rng(3).uniform(0, 1, size=(10, 8, 8, 1)).astype(np.float32)
    got_p, want_p = np.asarray(served.predict(queries.tolist())), np.asarray(ref.predict(queries.tolist()))
    np.testing.assert_allclose(got_p.sum(-1), 1.0, atol=1e-5)
    np.testing.assert_allclose(got_p, want_p, rtol=0, atol=1e-2)


def test_gp_job_of_ten_trials_reaches_expected_improvement(sources, tmp_path):
    store, params = port_env(tmp_path)
    job = make_job(store, sources["port"], {"MODEL_TRIAL_COUNT": 10})
    telemetry.reset()
    events.configure(tmp_path / "logs")
    try:
        result = LocalScheduler(store, params).run_train_job(
            job["id"], n_workers=1, devices=CPU, advisor_kind="gp")
        names = [e["event"] for e in events.read()]
    finally:
        events.close()
    assert names[0] == "train_job_started" and names[-1] == "train_job_finished"
    assert names.count("trial_started") == names.count("trial_completed") == 10
    assert result.status == "COMPLETED"
    assert len(result.trials) == 10
    assert all(t["status"] == "COMPLETED" for t in result.trials)
    # Trials 9 and 10 from expected improvement, and the 11th proposal,
    # which finds the budget spent and is dropped.
    assert telemetry.get_counter("advisor.gp_warmup_proposals") == 8
    assert telemetry.get_counter("advisor.gp_ei_proposals") == 3
    spans = telemetry.snapshot()["spans"]
    for name in ("trial.total", "trial.train", "trial.evaluate", "trial.persist"):
        assert spans[name]["count"] == 10, name
    assert spans["trial.advisor_propose"]["count"] == 11  # the 11th finds no slot
    assert telemetry.get_counter("worker.trials_succeeded") == 10
    assert [t["score"] for t in result.best_trials] == \
        sorted((t["score"] for t in result.trials), reverse=True)[:2]
    svc = store.get_services_of_job(job["id"])
    assert [s["status"] for s in svc] == ["STOPPED"]
    assert store.get_sub_train_jobs(job["id"])[0]["status"] == "COMPLETED"


BAD_SOURCE = b"""
from rafiki_tpu_torch.model.base import BaseModel
from rafiki_tpu_torch.model.knobs import FloatKnob
from rafiki_tpu_torch.obs.health import DivergenceError


class Bad(BaseModel):
    @staticmethod
    def get_knob_config():
        return {"lr": FloatKnob(0.0, 1.0)}

    def train(self, uri):
        if self.knobs["lr"] > 0.5:
            raise DivergenceError({"divergence": "nonfinite", "bad_step": 3,
                                   "diagnosis": "loss went non-finite"})
        raise RuntimeError("always bad")

    def evaluate(self, uri):
        return 0.0

    def predict(self, queries):
        return []
"""


def test_raising_template_is_contained(tmp_path):
    store, params = port_env(tmp_path)
    job = make_job(store, BAD_SOURCE, {"MODEL_TRIAL_COUNT": 4}, name="bad", cls="Bad")
    telemetry.reset()
    svc = AdvisorService()
    result = LocalScheduler(store, params, svc).run_train_job(
        job["id"], n_workers=1, devices=CPU, advisor_kind="random")
    # The loop survives, but the job is ERRORED: every trial failed.
    assert result.status == "ERRORED"
    assert len(result.trials) == 4 and result.best_trials == []
    errors = [t["error"] for t in result.trials]
    assert all(t["status"] == "ERRORED" for t in result.trials)
    diverged = [t["knobs"]["lr"] > 0.5 for t in result.trials]
    assert any(diverged) and not all(diverged)  # both arms ran
    for err, div in zip(errors, diverged):
        if div:
            assert err.startswith("diverged:") and "Traceback" not in err
        else:
            assert "Traceback" in err and "RuntimeError: always bad" in err
    assert telemetry.get_counter("worker.trials_errored") == 4


def test_stop_event_halts_the_job_and_logs_are_captured(sources, tmp_path):
    store, params = port_env(tmp_path)
    job = make_job(store, sources["port"], {"MODEL_TRIAL_COUNT": 100_000})
    stop = threading.Event()
    timer = threading.Timer(1.5, stop.set)
    out = {}
    # The job runs on its own thread so that a stop the scheduler fails
    # to honour fails this test in bounded time instead of hanging it.
    runner = threading.Thread(target=lambda: out.update(result=LocalScheduler(
        store, params).run_train_job(job["id"], n_workers=1, devices=CPU,
                                     advisor_kind="random", stop_event=stop)), daemon=True)
    timer.start()
    runner.start()
    try:
        runner.join(timeout=120)
    finally:
        timer.cancel()
        stop.set()
    assert not runner.is_alive(), "the job did not stop within 120 s of its stop event"
    result = out["result"]
    assert result.status == "STOPPED"
    assert 0 < len(result.trials) < 100_000
    assert store.get_train_job(job["id"])["status"] == "STOPPED"
    logs = store.get_trial_logs(result.trials[0]["id"])
    assert any(e["type"] == "plot" for e in logs)
    assert any(e["type"] == "values" and "loss" in e.get("values", {}) for e in logs)


def test_no_devices_and_no_cuda_raises(sources, tmp_path, monkeypatch):
    store, params = port_env(tmp_path)
    job = make_job(store, sources["port"], {"MODEL_TRIAL_COUNT": 1})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LocalScheduler(store, params).run_train_job(job["id"])
    assert store.get_train_job(job["id"])["status"] == "STARTED"
    assert store.get_trials_of_train_job(job["id"]) == []


WHERE_SOURCE = b"""
from rafiki_tpu_torch.model.log import logger
from rafiki_tpu_torch.models.ff import FeedForward


class Where(FeedForward):
    def train(self, uri):
        logger.log(device=str(self.device))
        super().train(uri)
"""


def test_a_trial_built_in_the_workers_cpu_scope_lands_on_the_cpu(tmp_path, monkeypatch):
    """A template takes no device argument: the worker's device scope
    decides, and outside a scope the default is CUDA, which is absent."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    store, params = port_env(tmp_path)
    job = make_job(store, WHERE_SOURCE, {"MODEL_TRIAL_COUNT": 1}, name="where", cls="Where")
    cls = load_model_class(WHERE_SOURCE, "Where")
    knobs = dict(hidden_layers=1, hidden_units=32, learning_rate=1e-2, batch_size=32,
                 epochs=1, seed=0)
    svc = AdvisorService()
    aid = svc.create_advisor(cls.get_knob_config(), kind="random")
    sub = store.get_sub_train_jobs(job["id"])[0]
    worker = TrainWorker(store, params, sub["id"], cls, InProcAdvisorHandle(svc, aid),
                         TRAIN, VAL, {"MODEL_TRIAL_COUNT": 1}, devices=CPU, async_persist=False)
    trial = worker.run_trial(knobs)
    assert trial["status"] == "COMPLETED", trial["error"]
    logs = store.get_trial_logs(trial["id"])
    assert {"device": "cpu"} in [e.get("values") for e in logs]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cls(**knobs)
    with default_device("cpu"):
        assert cls(**knobs).device == torch.device("cpu")
        with default_device(torch.device("cpu")):
            assert resolve_device() == torch.device("cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(ValueError, match="one device"):
        TrainWorker(store, params, sub["id"], cls, InProcAdvisorHandle(svc, aid), TRAIN, VAL,
                    {}, devices=CPU * 2)


def test_model_developer_harness_in_both_packages(monkeypatch):
    """``tune_model`` proposes the same knobs in both packages (the
    random advisor from one seed); ``test_model_class`` runs the
    contract round trip on the CPU; ``device=None`` follows an enclosing
    CPU scope."""
    from rafiki_tpu.model.dev import tune_model as jax_tune_model
    from rafiki_tpu.models.ff import FeedForward as JaxFeedForward
    from rafiki_tpu_torch.model.dev import test_model_class, tune_model
    from rafiki_tpu_torch.models.ff import FeedForward

    train = "synthetic://images?classes=4&n=128&w=6&h=6&seed=0"
    val = "synthetic://images?classes=4&n=64&w=6&h=6&seed=1"
    want = jax_tune_model(JaxFeedForward, train, val, total_trials=3, advisor="random", seed=4)
    got = tune_model(FeedForward, train, val, total_trials=3, advisor="random", seed=4,
                     device="cpu")
    assert [r["knobs"] for r in got[2]] == [r["knobs"] for r in want[2]]
    assert all(r["status"] == "COMPLETED" for r in got[2])
    assert got[1] == max(r["score"] for r in got[2])
    score, preds = test_model_class(FeedForward, "IMAGE_CLASSIFICATION", train, val,
                                    queries=np.zeros((2, 6, 6, 1)).tolist(), device="cpu")
    assert 0.0 <= score <= 1.0 and np.asarray(preds).shape == (2, 4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with default_device("cpu"):
        scoped = tune_model(FeedForward, train, val, total_trials=1, advisor="random", seed=4)
    assert scoped[2][0]["knobs"] == want[2][0]["knobs"]
    assert scoped[2][0]["status"] == "COMPLETED", scoped[2][0]["status"]


def test_profile_dir_gets_a_chrome_trace_per_trial(sources, tmp_path, monkeypatch):
    monkeypatch.setenv("RAFIKI_PROFILE_DIR", str(tmp_path / "prof"))
    store, params = port_env(tmp_path)
    job = make_job(store, sources["port"], {"MODEL_TRIAL_COUNT": 2})
    result = LocalScheduler(store, params).run_train_job(
        job["id"], n_workers=1, devices=CPU, advisor_kind="random")
    assert result.status == "COMPLETED"
    for t in result.trials:
        trace = tmp_path / "prof" / t["id"] / "trace.json"
        assert trace.exists() and b"traceEvents" in trace.read_bytes()[:4096]
