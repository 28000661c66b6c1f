"""The port's mid-trial checkpoints and resume, against the JAX package's,
on the CPU.

``tests/test_checkpoint_resume.py`` in the port, on an FF3 template of
the port's own; a checkpoint written by either package restored in the
other (params, Adam's moments and count, the step and the hyper carried
exactly, the remaining epochs trained to the other package's params
within the float32 bounds of ``tests/test_torch_ff.py`` and
``tests/test_torch_train.py``, at dropout 0: the dropout streams of the
two packages differ); the payload keys and RTPK1 tree names of both; a
split run at dropout 0.2 resumed bit for bit; and a pack's per-member
checkpoints resumed serially to the serial trials' params, byte for
byte.
"""

import pickle

import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from rafiki_tpu.utils.serial import dump_pytree
from rafiki_tpu_torch.advisor import AdvisorService
from rafiki_tpu_torch.convert import state_dict_to_flax
from rafiki_tpu_torch.model.base import GENERATOR_KEY, load_model_class
from rafiki_tpu_torch.models.vgg import Vgg
from rafiki_tpu_torch.store import MetaStore, ParamsStore
from rafiki_tpu_torch.utils.serial import load_flat
from rafiki_tpu_torch.worker.train import InProcAdvisorHandle, TrainWorker
from tests.test_torch_ff import F32_TOL as FF_F32_TOL, FF32, JaxFF32, ff_blob
from tests.test_torch_train import F32_TOL as VGG_F32_TOL, IMAGES_8, JaxVggF32, VggF32, vgg_blob

# See test_torch_train.py: two intra-op threads per xdist worker.
torch.set_num_threads(2)

FF3_SOURCE = b"""
from rafiki_tpu_torch.model.base import TorchModel
from rafiki_tpu_torch.model.knobs import FixedKnob, FloatKnob


class FF3(TorchModel):
    @staticmethod
    def get_knob_config():
        return {
            "learning_rate": FloatKnob(1e-3, 1e-2, is_exp=True),
            "batch_size": FixedKnob(32),
            "epochs": FixedKnob(3),
        }

    def build_module(self, num_classes, input_shape):
        from rafiki_tpu_torch.models.ff import _Mlp
        return _Mlp(1, 16, num_classes, input_shape)
"""

TRAIN = "synthetic://images?classes=5&n=256&w=8&h=8&seed=0"
VAL = "synthetic://images?classes=5&n=128&w=8&h=8&seed=1"
CPU = [torch.device("cpu")]
KNOBS = {"learning_rate": 3e-3, "batch_size": 32, "epochs": 3}


@pytest.fixture()
def env(tmp_path):
    store = MetaStore(tmp_path / "meta.sqlite3")
    params = ParamsStore(tmp_path / "params")
    row = store.create_model("ff3", "IMAGE_CLASSIFICATION", None, FF3_SOURCE, "FF3")
    job = store.create_train_job("ckptapp", "IMAGE_CLASSIFICATION", None,
                                 TRAIN, VAL, {"MODEL_TRIAL_COUNT": 1})
    sub = store.create_sub_train_job(job["id"], row["id"])
    cls = load_model_class(row["model_file"], "FF3")
    advisors = AdvisorService()
    aid = advisors.create_advisor(cls.get_knob_config(), kind="random")
    return store, params, sub, cls, InProcAdvisorHandle(advisors, aid)


def _worker(store, params, sub, cls, advisor, async_persist=False, **kw):
    return TrainWorker(store, params, sub["id"], cls, advisor, TRAIN, VAL,
                       {"MODEL_TRIAL_COUNT": 1}, async_persist=async_persist, devices=CPU, **kw)


def _crashy(cls):
    class Crashy(cls):
        def evaluate(self, uri):
            raise RuntimeError("simulated worker crash")

    Crashy.__name__ = cls.__name__
    return Crashy


# -- tests/test_checkpoint_resume.py in the port --------------------------------


def test_checkpoints_written_and_cleaned(env):
    store, params, sub, cls, advisor = env
    _worker(store, params, sub, cls, advisor, checkpoint_every=1).run()
    t = store.get_trials_of_sub_train_job(sub["id"])[0]
    assert t["status"] == "COMPLETED"
    # superseded by the final params, and deleted
    assert params.latest_checkpoint(t["id"]) is None
    assert t["params_id"] in params.list()


def test_checkpoint_roundtrip_exact(env):
    """A 1+2-epoch split run equals a 3-epoch run, params and score."""
    cls = env[3]
    blobs = {}
    m1 = cls(device="cpu", **KNOBS)
    m1.set_checkpoint_sink(lambda epoch, mk: blobs.__setitem__(epoch, mk()))
    m1.train(TRAIN)
    full_score, full_params = m1.evaluate(VAL), m1.dump_parameters()

    m2 = cls(device="cpu", **KNOBS)
    assert m2.restore_checkpoint(blobs[0]) == 1
    m2.train(TRAIN)
    assert abs(m2.evaluate(VAL) - full_score) < 1e-6
    assert m2.dump_parameters() == full_params  # bitwise identical resume


def test_resume_trial_after_crash(env):
    """A trial interrupted after its 3 epochs resumes from its checkpoint
    and completes, its stale error cleared and its checkpoints deleted."""
    store, params, sub, cls, advisor = env
    t = _worker(store, params, sub, _crashy(cls), advisor, checkpoint_every=1).run_trial(KNOBS)
    assert t["status"] == "ERRORED"
    assert params.latest_checkpoint(t["id"]) is not None  # progress survived

    out = _worker(store, params, sub, cls, advisor, checkpoint_every=1).resume_trial(t["id"])
    assert out["status"] == "COMPLETED"
    assert out["error"] is None
    assert out["score"] is not None
    assert params.latest_checkpoint(t["id"]) is None


def test_resume_with_async_persist_reports_final_status(env):
    """resume_trial drains the saver (restarting one a run() closed), so
    the caller sees the terminal status."""
    store, params, sub, cls, advisor = env
    t = _worker(store, params, sub, _crashy(cls), advisor, checkpoint_every=1).run_trial(KNOBS)
    w = _worker(store, params, sub, cls, advisor, async_persist=True, checkpoint_every=1)
    w.run()  # closes the saver thread...
    out = w.resume_trial(t["id"])  # ...which must restart for this
    assert out["status"] == "COMPLETED"
    assert out["params_id"] and len(params.load(out["params_id"])) > 100


def test_a_failed_checkpoint_write_is_counted_and_the_trial_goes_on(env, monkeypatch):
    from rafiki_tpu_torch import telemetry

    store, params, sub, cls, advisor = env

    def full_disk(*args):
        raise OSError("No space left on device")

    monkeypatch.setattr(params, "save_checkpoint", full_disk)
    before = telemetry.get_counter("worker.checkpoint_write_failed")
    t = _worker(store, params, sub, cls, advisor, checkpoint_every=1).run_trial(KNOBS)
    assert t["status"] == "COMPLETED"
    assert telemetry.get_counter("worker.checkpoint_write_failed") == before + 3


# -- across the two packages ---------------------------------------------------

CASES = {
    # float32 FF 2x32 on 8x8x1, 2 steps an epoch; VGG11 w0.25 on 8x8x3, 1.
    "ff": (JaxFF32, FF32, dict(hidden_layers=2, hidden_units=32, learning_rate=1e-3,
                               batch_size=32, epochs=3, seed=0),
           "synthetic://images?classes=10&w=8&h=8&c=1&n=64&seed=0", ff_blob, FF_F32_TOL),
    "vgg": (JaxVggF32, VggF32, dict(depth=11, width_mult=0.25, dropout=0.0,
                                    learning_rate=1e-3, batch_size=64, epochs=3, seed=0),
            IMAGES_8.format(n=64, seed=0), vgg_blob, VGG_F32_TOL),
}


def _trained(side, cls, knobs, blob, uri):
    """A 3-epoch trial from ``blob``'s params with every epoch's
    checkpoint kept; returns the model and the checkpoints."""
    m = cls(**knobs) if side == "jax" else cls(device="cpu", **knobs)
    m._planned_steps = knobs["epochs"] * (64 // knobs["batch_size"])
    m.load_parameters(blob)
    ckpts = {}
    m.set_checkpoint_sink(lambda epoch, mk: ckpts.__setitem__(epoch, mk()))
    m.train(uri)
    return m, ckpts


def _params(side, m):
    if side == "jax":
        return {k: np.asarray(v) for k, v in flatten_dict(m._loop.params, sep="/").items()}
    return {k: v.numpy() for k, v in state_dict_to_flax(m._module).items()}


def _carried(tree):
    """The state a checkpoint carries: params, moments and count, step,
    hyper (the rng key is each package's own)."""
    return {k: np.asarray(v) for k, v in tree.items() if k != "3"}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_checkpoint_resumes_in_the_other_package(case, writer):
    jax_cls, port_cls, knobs, uri, blob_fn, tol = CASES[case]
    classes = {"jax": jax_cls, "port": port_cls}
    reader = "port" if writer == "jax" else "jax"
    blob = blob_fn()
    full, ckpts = _trained(writer, classes[writer], knobs, blob, uri)
    written = load_flat(pickle.loads(ckpts[0])["state_packed"])

    m = classes[reader](**knobs) if reader == "jax" else classes[reader](device="cpu", **knobs)
    assert m.restore_checkpoint(ckpts[0]) == 1
    if reader == "jax":
        restored = load_flat(dump_pytree(m._loop.state, cast_f32_to_bf16=False))
    else:
        restored = load_flat(pickle.loads(m.dump_checkpoint())["state_packed"])
    want, got = _carried(written), _carried(restored)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    assert int(got["2"]) == int(got["1/count"]) == 64 // knobs["batch_size"]

    m.train(uri)
    a, b = _params(reader, m), _params(writer, full)
    start = {k: v.float().numpy() for k, v in load_flat(pickle.loads(blob)["packed"]).items()}
    gap = max(float(np.abs(a[k] - b[k]).max()) for k in a)
    rel = np.sqrt(sum(float(((a[k] - b[k]) ** 2).sum()) for k in a)) / np.sqrt(
        sum(float(((b[k] - start[k]) ** 2).sum()) for k in a))
    print("CROSS_RESUME", case, writer, gap, rel)
    assert gap <= tol["param_max_abs"] and rel <= tol["param_rel_l2"], (gap, rel)


@pytest.mark.parametrize("case", sorted(CASES))
def test_the_payload_and_tree_are_the_jax_packages(case):
    jax_cls, port_cls, knobs, uri, blob_fn, _ = CASES[case]
    blob = blob_fn()
    jax_blob = pickle.loads(_trained("jax", jax_cls, knobs, blob, uri)[1][1])
    port_blob = pickle.loads(_trained("port", port_cls, knobs, blob, uri)[1][1])
    assert set(port_blob) == set(jax_blob) | {GENERATOR_KEY}
    for key in ("arch", "epoch", "planned_steps", "dataset_meta"):
        assert port_blob[key] == jax_blob[key], key
    jt, pt = load_flat(jax_blob["state_packed"]), load_flat(port_blob["state_packed"])
    assert sorted(pt) == sorted(jt)
    for k in jt:
        assert (pt[k].dtype, tuple(pt[k].shape)) == (jt[k].dtype, tuple(jt[k].shape)), k
    assert pt["3"].tolist() == [0, 0]  # PRNGKey(seed)
    assert port_blob[GENERATOR_KEY]["device"] == "cpu"


# -- within the port -------------------------------------------------------------

SMALL = dict(depth=11, width_mult=0.25, dropout=0.2, learning_rate=3e-3, batch_size=64,
             epochs=3, seed=0)
VGG_TRAIN = IMAGES_8.format(n=128, seed=0)


def _vgg(seed=0, **knobs):
    m = Vgg(device="cpu", **dict(SMALL, **knobs))
    m._seed = seed
    return m


def test_a_split_run_with_dropout_resumes_bit_for_bit():
    """The generator's state travels with the checkpoint: a run resumed
    after epoch 0 or 1 at dropout 0.2 ends with the params of the run
    that was never interrupted, byte for byte."""
    full = _vgg()
    ckpts = {}
    full.set_checkpoint_sink(lambda epoch, mk: ckpts.__setitem__(epoch, mk()))
    full.train(VGG_TRAIN)
    want = full.dump_parameters()
    for epoch in (0, 1):
        m = _vgg()
        assert m.restore_checkpoint(ckpts[epoch]) == epoch + 1
        m.train(VGG_TRAIN)
        assert m.dump_parameters() == want, epoch
    # Without its generator state a blob resumes from the trial's seed,
    # as a JAX-written one does: the dropout masks then differ.
    payload = pickle.loads(ckpts[0])
    del payload[GENERATOR_KEY]
    m = _vgg()
    m.restore_checkpoint(pickle.dumps(payload))
    m.train(VGG_TRAIN)
    assert m.dump_parameters() != want


def test_a_checkpoint_that_does_not_fit_keeps_params_and_step():
    """The salvage path: a state whose optimizer layout does not fit the
    template restores its params and step with a fresh optimizer."""
    m = _vgg(epochs=2)
    ckpts = {}
    m.set_checkpoint_sink(lambda epoch, mk: ckpts.__setitem__(epoch, mk()))
    m.train(VGG_TRAIN)
    payload = pickle.loads(ckpts[0])
    flat = load_flat(payload["state_packed"])
    from rafiki_tpu_torch.utils.serial import dump_flat

    payload["state_packed"] = dump_flat({k: v for k, v in flat.items()
                                         if not k.startswith("1/mu/")}, cast_f32_to_bf16=False)
    r = _vgg(epochs=2)
    assert r.restore_checkpoint(pickle.dumps(payload)) == 1
    module, opt, step, _, _ = r._loop.state
    assert opt is None and step == int(flat["2"])
    for k, v in state_dict_to_flax(module).items():
        assert torch.equal(v, flat[f"0/{k}"]), k


def test_pack_checkpoints_resume_serially_to_the_serial_trials():
    """Two trials trained as one pack with a checkpoint per member per
    epoch; each member resumed serially from its epoch-0 and epoch-1
    checkpoints ends byte-equal to its uninterrupted serial trial."""
    members = ({"learning_rate": 1e-3, "dropout": 0.1}, {"learning_rate": 3e-3, "dropout": 0.2})
    models = [_vgg(i, **kn) for i, kn in enumerate(members)]
    ckpts = {}

    def sink(rnd, make_blobs):
        for mi, epoch, blob in make_blobs():
            assert epoch == rnd
            ckpts[(mi, epoch)] = blob

    Vgg.train_packed(models, VGG_TRAIN, checkpoint_sink=sink)
    assert sorted(ckpts) == [(i, e) for i in range(2) for e in range(3)]
    for i, kn in enumerate(members):
        serial = _vgg(i, **kn)
        serial.train(VGG_TRAIN)
        want = serial.dump_parameters()
        assert models[i].dump_parameters() == want
        for epoch in (0, 1):
            m = _vgg(i, **kn)
            assert m.restore_checkpoint(ckpts[(i, epoch)]) == epoch + 1
            m.train(VGG_TRAIN)
            assert m.dump_parameters() == want, (i, epoch)
        with pytest.raises(ValueError, match="resume from checkpoint"):
            Vgg.train_packed([m], VGG_TRAIN)
