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
