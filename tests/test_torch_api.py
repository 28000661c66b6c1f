"""The port exports the JAX package's public API, on the CPU.

Every name in the ``__all__`` of the reference's ``model``, ``models``,
``ops``, ``parallel``, ``bus``, ``predictor``, ``worker``, ``scheduler``,
``shard``, ``autoscale`` and ``store`` packages, and every public name of its
``tenancy`` package (which has no ``__all__``), imports from the port's
package of the same name (``JaxModel`` read as ``TorchModel``), but for
the names of modules not ported yet, listed in ``UNPORTED`` with their
ROADMAP item. Then the class-level gaps:
``Dataset.split`` draws the reference's permutation,
``parse_model_install_command`` reports the same names, the loop has
``hyper``, and a template overriding ``make_optimizer`` trains in both
packages to the same params within ``tests/test_torch_ff.py``'s float32
bounds.
"""

import importlib
import inspect

import numpy as np
import pytest
import torch

from rafiki_tpu.model import dataset as jax_dataset
from rafiki_tpu.model.base import parse_model_install_command as jax_parse
from rafiki_tpu_torch.model import TorchModel, dataset as port_dataset, parse_model_install_command
from rafiki_tpu_torch.ops import TrainLoop
from tests.test_torch_ff import F32_TOL, FF32, FF_KNOBS, IMAGES, JaxFF32, ff_blob
from tests.test_torch_train import blob_params, check_readings, readings, train_one

# See test_torch_train.py: two intra-op threads per xdist worker.
torch.set_num_threads(2)

PACKAGES = ("model", "models", "ops", "parallel", "bus", "predictor", "worker", "scheduler",
            "shard", "tenancy", "store", "autoscale")
RENAMED = {"JaxModel": "TorchModel"}
#: Names of the reference's exports the port does not have yet, with
#: their ROADMAP Queue 1 item.
UNPORTED = {}


def _exports(mod):
    """``__all__``, else the public names a package binds that are not
    its submodules."""
    if hasattr(mod, "__all__"):
        return list(mod.__all__)
    return [n for n, v in vars(mod).items()
            if not n.startswith("_") and not inspect.ismodule(v)]


@pytest.mark.parametrize("package", PACKAGES)
def test_the_port_exports_the_reference_api(package):
    ref = importlib.import_module(f"rafiki_tpu.{package}")
    port = importlib.import_module(f"rafiki_tpu_torch.{package}")
    missing = []
    exports = _exports(ref)
    for name in exports:
        if name in UNPORTED:
            assert not hasattr(port, name), f"{name} is ported: take it off UNPORTED"
            continue
        if not hasattr(port, RENAMED.get(name, name)):
            missing.append(name)
    assert missing == []
    want = {RENAMED.get(n, n) for n in exports if n not in UNPORTED}
    assert set(port.__all__) == want


def test_dataset_split_draws_the_reference_permutation():
    uri = "synthetic://images?classes=4&n=50&w=4&h=4&seed=3"
    ref, port = jax_dataset.dataset_utils.load(uri), port_dataset.dataset_utils.load(uri)
    for frac, seed in ((0.8, 0), (0.3, 7)):
        for a, b in zip(ref.split(frac, seed=seed), port.split(frac, seed=seed)):
            np.testing.assert_array_equal(a.x, b.x)
            np.testing.assert_array_equal(a.y, b.y)
            assert a.classes == b.classes and a.meta == b.meta and b.mask is None


def test_parse_model_install_command_reports_the_same_names():
    deps = {"numpy": "1", "scikit-learn": "1", "Pillow": "1", "no-such-pkg-xyz": "1"}
    assert parse_model_install_command(deps) == jax_parse(deps) == ["no-such-pkg-xyz"]
    assert parse_model_install_command({}) == []


def test_train_loop_hyper_is_the_trials_float32_scalars():
    m = FF32(device="cpu", **FF_KNOBS)
    m.init_parameters(10, (8, 8, 1))
    assert isinstance(m._loop, TrainLoop)
    assert {k: float(v) for k, v in m._loop.hyper.items()} == {
        "lr": np.float32(1e-3), "warmup": float(m._warmup_steps())}
    assert all(v.dtype == torch.float32 for v in m._loop.hyper.values())


class JaxCustom(JaxFF32):
    def make_optimizer(self):
        return super().make_optimizer()


class PortCustom(FF32):
    def make_optimizer(self):
        return super().make_optimizer()


@pytest.mark.parametrize("steps", [2, 5])
def test_a_make_optimizer_template_trains_as_in_the_jax_package(steps):
    """optax's adam over linear_schedule(0, lr, warmup), the lr baked in:
    the template leaves the per-trial lr path (no lr or warmup in the
    hyper dict, every knob but the seed in its program key; it packs, as
    in the JAX package, with members that differ only by seed) and trains to the JAX package's params within F32_TOL. Its first
    update is zero (the schedule starts at 0), so one step moves nothing."""
    knobs = dict(FF_KNOBS, learning_rate=3e-3)
    blob = ff_blob()
    args = (knobs, blob, IMAGES.format(n=32 * steps, seed=0), IMAGES.format(n=100, seed=1))
    ref = train_one("jax", JaxCustom, *args)
    got = train_one("port", PortCustom, *args)
    check_readings(readings(ref, got, blob_params(blob)), F32_TOL)
    m = got["model"]
    assert dict(m._loop.hyper) == {} and type(m._loop.state[1]).__name__ == "AdamState"
    assert m._loop.state[1].count == steps
    fns = m._loop_fns(10, (8, 8, 1))
    assert fns["program_key"][5] is True and ("learning_rate", repr(3e-3)) in fns["program_key"][4]
    assert PortCustom.packable() and FF32.packable()
    assert TorchModel.make_optimizer is not PortCustom.make_optimizer
