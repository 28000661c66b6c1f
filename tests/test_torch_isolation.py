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
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "ml_dtypes", "werkzeug", "rafiki_tpu")


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
