"""The port stands alone: it imports nothing of JAX or of the JAX
package, and its entry points run on CUDA unless asked for the CPU."""

import os
import pkgutil
import subprocess
import sys

import pytest
import torch

import rafiki_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "ml_dtypes", "werkzeug", "requests",
             "rafiki_tpu")


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        rafiki_tpu_torch.__path__, prefix="rafiki_tpu_torch."))


def test_port_imports_nothing_of_jax_or_the_jax_package():
    # A fresh interpreter: this test process has JAX loaded already.
    mods = _port_modules()
    for name in ("worker.inference", "model.dataset", "model.log", "obs.health.sentinel",
                 "obs.health.detector", "ops.optim", "ops.train", "models.ff", "models.vgg"):
        assert f"rafiki_tpu_torch.{name}" in mods
    assert len(mods) >= 28
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        f"bad = sorted(n for n in sys.modules if n.split('.')[0] in {FORBIDDEN!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.strip() == "[]"



def test_the_train_job_path_and_a_gp_fit_need_no_scikit_learn():
    """The card's machine has no scikit-learn: the GP advisor fits its
    own Gaussian process. Every module of the train-job path imports,
    and a GP proposal past the warm-up runs, with none of scikit-learn,
    JAX or the JAX package loaded."""
    new = ("constants", "config", "utils.events", "store.meta", "store.params",
           "advisor.base", "advisor.random_advisor", "advisor.gp", "advisor.tpe",
           "advisor.service", "parallel.mesh", "worker.train", "scheduler.local", "model.dev")
    mods = _port_modules()
    for name in new:
        assert f"rafiki_tpu_torch.{name}" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "from rafiki_tpu_torch import telemetry\n"
        "from rafiki_tpu_torch.advisor import make_advisor\n"
        "from rafiki_tpu_torch.model.knobs import CategoricalKnob, FloatKnob\n"
        "adv = make_advisor({'lr': FloatKnob(1e-4, 3e-2, is_exp=True),\n"
        "                    'bs': CategoricalKnob([64, 128, 256])}, kind='gp', seed=0)\n"
        "for i in range(9):\n"
        "    k = adv.propose()\n"
        "    adv.feedback(-abs(k['lr'] - 1e-3) * 100 + k['bs'] / 1000, k)\n"
        "assert telemetry.get_counter('advisor.gp_ei_proposals') == 1, telemetry.snapshot()\n"
        f"bad = sorted(n for n in sys.modules if n.split('.')[0] in {FORBIDDEN + ('sklearn',)!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.strip() == "[]"


def test_the_service_modules_need_neither_werkzeug_nor_requests():
    """The card's machine has neither werkzeug nor requests: the admin,
    its REST app, the gateway, the HTTP predictor, the client and the
    command line import, and the HTTP layer round-trips a request, with
    none of them (nor JAX or the JAX package) loaded."""
    new = ("utils.jsonable", "utils.auth", "utils.httpd", "gateway", "gateway.admission",
           "gateway.breaker", "gateway.microbatch", "gateway.gateway", "predictor.app",
           "admin", "admin.services_manager", "admin.admin", "admin.app", "client",
           "client.client", "__main__")
    mods = _port_modules()
    for name in new:
        assert f"rafiki_tpu_torch.{name}" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "from rafiki_tpu_torch.utils.httpd import json_response, start_server\n"
        "from rafiki_tpu_torch.client.client import _send\n"
        "srv, _ = start_server(lambda r: json_response({'path': r.path, 'n': len(r.body)}))\n"
        "got = _send('POST', f'http://127.0.0.1:{srv.server_port}/a%20b', {}, b'xyz', 10)\n"
        "srv.shutdown(); srv.server_close()\n"
        "assert got == {'path': '/a b', 'n': 3}, got\n"
        f"bad = sorted(n for n in sys.modules if n.split('.')[0] in {FORBIDDEN!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.strip() == "[]"


def test_a_packed_train_job_runs_with_nothing_of_jax_loaded(tmp_path):
    """Trial packing touches the health monitor, Adam, the train step,
    the layers, the model surface, the worker and the scheduler. Each of
    them imports, and a job of three FeedForward trials packed by
    ``LocalScheduler.run_train_job(trial_pack=3)`` on the CPU completes
    in one packed round, with nothing of JAX or the JAX package loaded."""
    touched = ("obs.health.detector", "obs.health.sentinel", "ops.optim", "ops.train",
               "ops.layers", "model.base", "models.ff", "models.vgg", "worker.train",
               "scheduler.local")
    mods = _port_modules()
    for name in touched:
        assert f"rafiki_tpu_torch.{name}" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "import torch\n"
        "torch.set_num_threads(2)\n"
        "from rafiki_tpu_torch import telemetry\n"
        "from rafiki_tpu_torch.scheduler import LocalScheduler\n"
        "from rafiki_tpu_torch.store import MetaStore, ParamsStore\n"
        "src = open('rafiki_tpu_torch/models/ff.py', 'rb').read()\n"
        f"store = MetaStore({str(tmp_path / 'm.sqlite3')!r})\n"
        f"params = ParamsStore({str(tmp_path / 'p')!r})\n"
        "model = store.create_model('ff', 'IMAGE_CLASSIFICATION', None, src, 'FeedForward')\n"
        "uri = 'synthetic://images?classes=4&n=128&w=8&h=8&seed={}'\n"
        "job = store.create_train_job('app', 'IMAGE_CLASSIFICATION', None, uri.format(0),\n"
        "                             uri.format(1), {'MODEL_TRIAL_COUNT': 3})\n"
        "store.create_sub_train_job(job['id'], model['id'])\n"
        "class Fixed:\n"
        "    def __init__(self): self.i = 0\n"
        "    def __call__(self, advisor_id, n):\n"
        "        self.i += n\n"
        "        return [dict(hidden_layers=1, hidden_units=32, batch_size=32, epochs=1,\n"
        "                     seed=0, learning_rate=1e-3 * (j + 1)) for j in range(n)]\n"
        "sched = LocalScheduler(store, params)\n"
        "sched.advisors.propose_batch = Fixed()\n"
        "res = sched.run_train_job(job['id'], devices=[torch.device('cpu')], trial_pack=3)\n"
        "assert res.status == 'COMPLETED', res\n"
        "assert [t['status'] for t in res.trials] == ['COMPLETED'] * 3, res.trials\n"
        "assert telemetry.get_counter('worker.packed_rounds') == 1\n"
        f"bad = sorted(n for n in sys.modules if n.split('.')[0] in {FORBIDDEN!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_zoo_and_a_packed_densenet_job_run_with_nothing_of_jax_loaded(tmp_path):
    """The zoo's modules and its registry import, every registry name
    resolves, a job of two DenseNet trials packed by
    ``LocalScheduler.run_train_job(trial_pack=2)`` completes in one
    packed round on the CPU, and a Transformer and a PosBiLstm trial
    run through the model harness, with nothing of JAX, the JAX package
    or scikit-learn loaded."""
    zoo = ("models", "models.densenet", "models.transformer", "models.pos_bilstm",
           "models.pos_hmm", "models.sk", "ops.layers", "convert", "model.dataset")
    mods = _port_modules()
    for name in zoo:
        assert f"rafiki_tpu_torch.{name}" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "import torch\n"
        "torch.set_num_threads(2)\n"
        "from rafiki_tpu_torch import telemetry\n"
        "from rafiki_tpu_torch.model.dev import test_model_class\n"
        "from rafiki_tpu_torch.models import MODEL_REGISTRY, get_model_class\n"
        "from rafiki_tpu_torch.scheduler import LocalScheduler\n"
        "from rafiki_tpu_torch.store import MetaStore, ParamsStore\n"
        "assert all(get_model_class(n).__name__ == n for n in MODEL_REGISTRY)\n"
        "src = open('rafiki_tpu_torch/models/densenet.py', 'rb').read()\n"
        f"store = MetaStore({str(tmp_path / 'm.sqlite3')!r})\n"
        f"params = ParamsStore({str(tmp_path / 'p')!r})\n"
        "model = store.create_model('dn', 'IMAGE_CLASSIFICATION', None, src, 'DenseNet')\n"
        "uri = 'synthetic://images?classes=4&n=64&w=8&h=8&c=3&seed={}'\n"
        "job = store.create_train_job('app', 'IMAGE_CLASSIFICATION', None, uri.format(0),\n"
        "                             uri.format(1), {'MODEL_TRIAL_COUNT': 2})\n"
        "store.create_sub_train_job(job['id'], model['id'])\n"
        "class Fixed:\n"
        "    def __call__(self, advisor_id, n):\n"
        "        return [dict(depth=22, growth=12, batch_size=64, epochs=1, seed=0,\n"
        "                     learning_rate=1e-3 * (j + 1)) for j in range(n)]\n"
        "sched = LocalScheduler(store, params)\n"
        "sched.advisors.propose_batch = Fixed()\n"
        "res = sched.run_train_job(job['id'], devices=[torch.device('cpu')], trial_pack=2)\n"
        "assert res.status == 'COMPLETED', res\n"
        "assert [t['status'] for t in res.trials] == ['COMPLETED'] * 2, res.trials\n"
        "assert telemetry.get_counter('worker.packed_rounds') == 1\n"
        "text = 'synthetic://text?vocab=81&classes=5&n={}&len=16&seed={}'\n"
        "test_model_class(get_model_class('Transformer'), 'TEXT_CLASSIFICATION',\n"
        "                 text.format(64, 0), text.format(32, 1), queries=[[1] * 16],\n"
        "                 knobs=dict(embed_dim=32, num_heads=2, num_layers=1,\n"
        "                            learning_rate=1e-3, batch_size=32, epochs=1, seed=0),\n"
        "                 device='cpu')\n"
        "corpus = 'synthetic://corpus?vocab=80&tags=6&n={}&len=12&seed={}'\n"
        "test_model_class(get_model_class('PosBiLstm'), 'POS_TAGGING', corpus.format(64, 0),\n"
        "                 corpus.format(32, 1), queries=[[5, 9, 3]],\n"
        "                 knobs=dict(embed_dim=32, hidden=32, learning_rate=1e-3,\n"
        "                            batch_size=32, epochs=1, seed=0), device='cpu')\n"
        f"bad = sorted(n for n in sys.modules if n.split('.')[0] in {FORBIDDEN + ('sklearn',)!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_entry_points_raise_without_cuda_unless_cpu_is_asked(monkeypatch):
    from rafiki_tpu_torch.models.ff import FeedForward
    from rafiki_tpu_torch.models.vgg import Vgg
    from rafiki_tpu_torch.ops.train import TrainLoop
    from rafiki_tpu_torch.utils.backend import local_devices, resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    knobs = dict(depth=11, width_mult=0.25, dropout=0.0, learning_rate=1e-3,
                 batch_size=64, epochs=1, seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Vgg(**knobs)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        local_devices()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FeedForward(hidden_layers=1, hidden_units=32, learning_rate=1e-3, batch_size=32,
                    epochs=1, seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TrainLoop(None, None, None, hyper={"lr": 1e-3})
    assert resolve_device("cpu") == torch.device("cpu")
    assert local_devices("cpu") == [torch.device("cpu")]
    assert Vgg(device="cpu", **knobs).device == torch.device("cpu")


def test_checkpoints_and_recovery_run_with_nothing_of_jax_loaded(tmp_path):
    """The recovery sweep, the checkpoint payloads and the packages'
    public API import, and a trial killed after its checkpoints is
    recovered on the CPU from its newest one, with nothing of JAX or the
    JAX package loaded."""
    from tests.test_torch_checkpoint import FF3_SOURCE, KNOBS, TRAIN, VAL

    mods = _port_modules()
    for name in ("scheduler.recovery", "model", "models", "ops", "parallel", "bus",
                 "predictor", "worker"):
        assert f"rafiki_tpu_torch.{name}" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "import torch\n"
        "torch.set_num_threads(2)\n"
        "from rafiki_tpu_torch.model import TorchModel, load_model_class, tune_model\n"
        "from rafiki_tpu_torch.scheduler.recovery import recover_orphaned_trials\n"
        "from rafiki_tpu_torch.store import MetaStore, ParamsStore\n"
        "from rafiki_tpu_torch.worker import TrainWorker\n"
        f"store = MetaStore({str(tmp_path / 'm.sqlite3')!r})\n"
        f"params = ParamsStore({str(tmp_path / 'p')!r})\n"
        f"row = store.create_model('ff3', 'IMAGE_CLASSIFICATION', None, {FF3_SOURCE!r}, 'FF3')\n"
        f"job = store.create_train_job('app', 'IMAGE_CLASSIFICATION', None, {TRAIN!r}, {VAL!r},\n"
        "                             {'MODEL_TRIAL_COUNT': 1})\n"
        "sub = store.create_sub_train_job(job['id'], row['id'])\n"
        "cls = load_model_class(row['model_file'], 'FF3')\n"
        "class Dying(cls):\n"
        "    def evaluate(self, uri):\n"
        "        raise KeyboardInterrupt\n"
        "svc = store.create_service('TRAIN_WORKER')\n"
        f"w = TrainWorker(store, params, sub['id'], Dying, None, {TRAIN!r}, {VAL!r},\n"
        "                {'MODEL_TRIAL_COUNT': 1}, async_persist=False, checkpoint_every=1,\n"
        "                devices=[torch.device('cpu')])\n"
        "w.service_id = svc['id']\n"
        "try:\n"
        f"    w.run_trial({KNOBS!r})\n"
        "except KeyboardInterrupt:\n"
        "    pass\n"
        "store.update_service(svc['id'], status='ERRORED')\n"
        "rows = recover_orphaned_trials(store, params, devices=[torch.device('cpu')])\n"
        "assert [r['status'] for r in rows] == ['COMPLETED'], rows\n"
        f"bad = sorted(n for n in sys.modules if n.split('.')[0] in {FORBIDDEN!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_obs_plane_and_a_journaled_job_run_with_nothing_of_jax_loaded(tmp_path):
    """The observability plane imports, and a journaled job of two
    FeedForward trials on the CPU writes its spans, events, ledger and
    perf records, which the port's CLI reads back (a FLOP count and an
    epoch for the trials' program), with nothing of JAX or the JAX
    package loaded."""
    obs = ("obs", "obs.context", "obs.journal", "obs.ledger", "obs.prom", "obs.recorder",
           "obs.cli", "obs.perf", "obs.perf.anomaly", "obs.perf.profiler", "obs.perf.slo")
    mods = _port_modules()
    for name in obs:
        assert f"rafiki_tpu_torch.{name}" in mods
    code = (
        "import importlib, io, json, sys\n"
        "from contextlib import redirect_stdout\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "import torch\n"
        "torch.set_num_threads(2)\n"
        "from rafiki_tpu_torch import obs\n"
        "from rafiki_tpu_torch.obs import cli\n"
        "from rafiki_tpu_torch.scheduler import LocalScheduler\n"
        "from rafiki_tpu_torch.store import MetaStore, ParamsStore\n"
        "assert obs.configure_from_env(role='job')\n"
        "src = open('rafiki_tpu_torch/models/ff.py', 'rb').read()\n"
        f"store = MetaStore({str(tmp_path / 'm.sqlite3')!r})\n"
        f"params = ParamsStore({str(tmp_path / 'p')!r})\n"
        "model = store.create_model('ff', 'IMAGE_CLASSIFICATION', None, src, 'FeedForward')\n"
        "uri = 'synthetic://images?classes=4&n=128&w=8&h=8&seed={}'\n"
        "job = store.create_train_job('app', 'IMAGE_CLASSIFICATION', None, uri.format(0),\n"
        "                             uri.format(1), {'MODEL_TRIAL_COUNT': 2})\n"
        "store.create_sub_train_job(job['id'], model['id'])\n"
        "sched = LocalScheduler(store, params)\n"
        "sched.advisors.propose = lambda advisor_id: dict(hidden_layers=1, hidden_units=32,\n"
        "    batch_size=32, epochs=2, seed=0, learning_rate=1e-3)\n"
        "res = sched.run_train_job(job['id'], devices=[torch.device('cpu')])\n"
        "assert res.status == 'COMPLETED', res\n"
        "obs.journal.journal.close()\n"
        f"[row] = cli.profile_rows({str(tmp_path / 'log')!r})\n"
        "assert row['flops'] > 0 and row['epochs'] == 2 and row['steps'] == 4, row\n"
        "buf = io.StringIO()\n"
        "with redirect_stdout(buf):\n"
        f"    assert cli.main(['--dir', {str(tmp_path / 'log')!r}, 'tail', '-n', '500']) == 0\n"
        "for line in ('event   trial_started', 'span    trial.total', 'ledger  trial:',\n"
        "             'perf    cost', 'trial   epoch_eval'):\n"
        "    assert line in buf.getvalue(), line\n"
        f"bad = sorted(n for n in sys.modules if n.split('.')[0] in {FORBIDDEN!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["RAFIKI_LOG_DIR"] = str(tmp_path / "log")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_obs_cli_reads_journals_without_torch(tmp_path):
    """``python -m rafiki_tpu_torch.obs tail <dir>`` in an interpreter
    where torch cannot be imported: the forensics CLI reads journals on
    a machine with no accelerator stack."""
    from rafiki_tpu_torch.obs.journal import Journal

    j = Journal(tmp_path, role="w")
    j.record("event", "trial_started", trial_id="t1")
    j.record("span", "trial.total", dur_s=1.5)
    j.close()
    code = ("import runpy, sys\n"
            "sys.modules['torch'] = None\n"
            f"sys.argv = ['obs', '--dir', {str(tmp_path)!r}, 'tail']\n"
            "try:\n"
            "    runpy.run_module('rafiki_tpu_torch.obs', run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    assert e.code == 0, e.code\n"
            "assert sys.modules['torch'] is None\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "trial_started" in out.stdout and "trial.total" in out.stdout


def test_the_chaos_plane_and_a_capsule_replay_run_with_nothing_of_jax_loaded(tmp_path):
    """The chaos package and the replay capsules import with nothing of JAX
    or the JAX package loaded; in an interpreter where ``jax`` and
    ``rafiki_tpu`` cannot be imported at all, a chaos scenario passes on
    the CPU, and a trial poisoned by ``train.nan`` banks a capsule that
    ``python -m rafiki_tpu_torch.obs replay <capsule> --device cpu
    --json`` reproduces."""
    mods = _port_modules()
    for name in ("chaos", "chaos.plane", "chaos.runner", "chaos.scenarios",
                 "obs.health.capsule"):
        assert f"rafiki_tpu_torch.{name}" in mods
    blocked = ("jax", "jaxlib", "flax", "optax", "rafiki_tpu")
    code = (
        "import contextlib, io, json, runpy, sys\n"
        f"for name in {blocked!r}: sys.modules[name] = None\n"
        "import importlib\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "import torch\n"
        "torch.set_num_threads(2)\n"
        "from rafiki_tpu_torch.chaos import FaultPlane, install, uninstall\n"
        "from rafiki_tpu_torch.chaos.runner import run_scenario\n"
        "from rafiki_tpu_torch.models.ff import FeedForward\n"
        "from rafiki_tpu_torch.obs.health import DivergenceError\n"
        "from rafiki_tpu_torch.obs.journal import journal\n"
        "report = run_scenario('checkpoint-write-failure', device='cpu')\n"
        "assert report.passed, report.to_dict()\n"
        f"journal.configure({str(tmp_path)!r}, role='test')\n"
        "install(FaultPlane.from_spec('seed=3;train.nan:nan:times=1'))\n"
        "m = FeedForward(device='cpu', hidden_layers=1, hidden_units=32, learning_rate=1e-3,\n"
        "                batch_size=32, epochs=1, seed=0)\n"
        "try:\n"
        "    m.train('synthetic://images?classes=4&n=128&w=8&h=8&c=1&seed=0')\n"
        "    raise SystemExit('no divergence')\n"
        "except DivergenceError as e:\n"
        "    cap = e.verdict['capsule']\n"
        "uninstall()\n"
        "journal.close()\n"
        "sys.argv = ['obs', 'replay', cap, '--device', 'cpu', '--json']\n"
        "out = io.StringIO()\n"
        "with contextlib.redirect_stdout(out):\n"
        "    try:\n"
        "        runpy.run_module('rafiki_tpu_torch.obs', run_name='__main__')\n"
        "    except SystemExit as e:\n"
        "        assert e.code == 0, (e.code, out.getvalue())\n"
        "verdict = json.loads(out.getvalue())\n"
        "assert verdict['reproduced'] and verdict['steps_replayed'] == 3, verdict\n"
        f"bad = sorted(n for n in sys.modules if n.split('.')[0] in {FORBIDDEN!r}\n"
        "             and sys.modules[n] is not None)\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "RAFIKI_CHAOS")}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_process_scheduler_and_a_dp_job_run_with_nothing_of_jax_loaded(tmp_path):
    """The process plane (the advisor over HTTP, the ProcessScheduler,
    the worker entry point and its follower, the dp mesh and its batch
    slices) imports, and a job of two FeedForward trials at width 2 (two
    gloo ranks, one subprocess each) completes on the CPU, with nothing
    of JAX, the JAX package, werkzeug or requests loaded here."""
    new = ("advisor.app", "scheduler.process", "worker.main", "worker.follower",
           "parallel.mesh", "parallel.multihost")
    mods = _port_modules()
    for name in new:
        assert f"rafiki_tpu_torch.{name}" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "from rafiki_tpu_torch.scheduler import ProcessScheduler\n"
        "from rafiki_tpu_torch.store import MetaStore, ParamsStore\n"
        "src = open('rafiki_tpu_torch/models/ff.py', 'rb').read()\n"
        f"store = MetaStore({str(tmp_path / 'm.sqlite3')!r})\n"
        f"params = ParamsStore({str(tmp_path / 'p')!r})\n"
        "model = store.create_model('ff', 'IMAGE_CLASSIFICATION', None, src, 'FeedForward')\n"
        "uri = 'synthetic://images?classes=4&n=128&w=8&h=8&seed={}'\n"
        "job = store.create_train_job('app', 'IMAGE_CLASSIFICATION', None, uri.format(0),\n"
        "                             uri.format(1), {'MODEL_TRIAL_COUNT': 2})\n"
        "store.create_sub_train_job(job['id'], model['id'])\n"
        "res = ProcessScheduler(store, params).run_train_job(\n"
        "    job['id'], devices_per_trial=2, advisor_kind='random', platform='cpu', poll_s=0.2)\n"
        "assert res.status == 'COMPLETED', res\n"
        "assert [t['status'] for t in res.trials] == ['COMPLETED'] * 2, res.trials\n"
        f"bad = sorted(n for n in sys.modules if n.split('.')[0] in {FORBIDDEN!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
