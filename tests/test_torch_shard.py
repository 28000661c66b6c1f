"""The sharded-trial lane in the port against its serial loop and the JAX
package's lane, on the CPU (the counterpart of ``tests/test_shard.py``
and of ``tests/test_zoo.py::test_transformer_declares_a_shard_plan``).

The invariant everything downstream leans on: a sharded loop is
BIT-IDENTICAL to the port's serial loop at any width (gather -> the
serial step -> reslice moves data only). Then the plan math against the
JAX package's at its per-chip figure, the reshard round trips, the
manifest's failure modes (a missing chunk, a wrong-width chunk, an
inconsistent manifest: each fails naming the chunk or the width), and
manifests across packages: a width-2 manifest of either package
restores in the other at widths 1 and 2 with equal leaves (flax names
and layouts, ``convert.py``), the port re-writes a JAX manifest's
chunks byte for byte but for the generator leaf, and the port's width-2
trial resumed from the JAX package's epoch-0 manifest ends within
F32_TOL of the JAX package's width-2 trial (the Transformer in float32,
which has no dropout). Every member of a group is ``cpu`` here.
"""

import json
import pickle

import jax
import numpy as np
import pytest
import torch

from rafiki_tpu.obs.twin.calibration import HBM_BYTES_PER_CHIP
from rafiki_tpu.shard import (ShardPlan as JaxShardPlan, gather_state as jax_gather,
                              restore_sharded as jax_restore, save_sharded as jax_save,
                              shard_axis as jax_shard_axis, solve_width as jax_solve_width,
                              train_sharded as jax_train_sharded)
from rafiki_tpu.shard.plan import state_bytes as jax_state_bytes
from rafiki_tpu.store.params import ParamsStore as JaxParamsStore
from rafiki_tpu_torch.shard import (ShardPlan, gather_state, is_manifest, load_manifest,
                                    restore_sharded, save_sharded, shard_axis, solve_width,
                                    train_sharded)
from rafiki_tpu_torch.shard.plan import state_bytes
from rafiki_tpu_torch.store import ParamsStore
from rafiki_tpu_torch.utils.serial import load_flat
from tests.test_torch_train import F32_TOL
from tests.test_torch_zoo import FAMILIES, _f32_pair
from tests.test_torch_zoo_train import _zero_gradient_leaves

# See test_torch_train.py: two intra-op threads per xdist worker.
torch.set_num_threads(2)

CPU = torch.device("cpu")
JaxTf, PortTf = _f32_pair("transformer")
KNOBS = dict(FAMILIES["transformer"][2], epochs=2)  # lr 1e-3, batch 32
TRAIN = FAMILIES["transformer"][3].format(n=96, seed=0)  # 3 steps an epoch
VAL = FAMILIES["transformer"][3].format(n=40, seed=1)


def _port_run(width, epochs=2, resume_from=None, sink=None):
    m = PortTf(device="cpu", **dict(KNOBS, epochs=epochs))
    loop, history = train_sharded(m, TRAIN, [CPU] * width, checkpoint_sink=sink,
                                  resume_from=resume_from)
    return m, loop, history


def _flat_jax(state):
    flat = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(jax_gather(state))[0]:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", getattr(p, "name", p))))
                       for p in path)
        flat[key] = torch.from_numpy(np.array(leaf))
    return flat


@pytest.fixture(scope="module")
def lane(tmp_path_factory):
    """The port's serial trial and its sharded trials at widths 1/2/4,
    and the JAX package's width-2 trial with its epoch-0 manifest (one
    fixture: every test shares the runs)."""
    serial = PortTf(device="cpu", **KNOBS)
    serial.train(TRAIN)
    loops = {w: _port_run(w) for w in (1, 2, 4)}
    d = tmp_path_factory.mktemp("jax-manifest")
    jstore = JaxParamsStore(d)

    def sink(epoch, loop):
        if epoch == 0:
            jax_save(jstore, "jt", 0, loop.state, loop.width)

    jm = JaxTf(**KNOBS)
    jloop, _ = jax_train_sharded(jm, TRAIN, jax.devices()[:2], checkpoint_sink=sink)
    return {"serial": serial, "loops": loops, "jax_dir": d, "jax_model": jm, "jax_loop": jloop}


# -- plan math -----------------------------------------------------------------


SHAPES = [(16, 4), (4, 16), (6, 8), (3, 5), (), (16,), (2,), (81, 32), (32, 2, 16), (8, 8)]


@pytest.mark.parametrize("width", [1, 2, 4, 8])
def test_shard_axis_is_the_jax_packages(width):
    assert [shard_axis(s, width) for s in SHAPES] == [jax_shard_axis(s, width) for s in SHAPES]
    assert shard_axis((16, 4), 2) == 0 and shard_axis((4, 16), 2) == 1
    assert shard_axis((3, 5), 2) is None and shard_axis((16,), 1) is None


def test_solve_width_matches_the_jax_package_at_its_per_chip_figure(monkeypatch):
    monkeypatch.delenv("RAFIKI_SHARD_WIDTH", raising=False)
    for frac in (0.5, 0.9, 1.5, 3.0, 7.5, 100.0):
        hbm = int(frac * HBM_BYTES_PER_CHIP)
        assert solve_width(hbm, per_chip_bytes=HBM_BYTES_PER_CHIP) == jax_solve_width(hbm)
        assert solve_width(hbm, cap=4, per_chip_bytes=HBM_BYTES_PER_CHIP) == \
            jax_solve_width(hbm, cap=4)
    assert solve_width(int(3.0 * HBM_BYTES_PER_CHIP), per_chip_bytes=HBM_BYTES_PER_CHIP) == 4
    # the pin overrides the solve entirely
    monkeypatch.setenv("RAFIKI_SHARD_WIDTH", "2")
    assert solve_width(int(100 * HBM_BYTES_PER_CHIP), per_chip_bytes=1.0) == \
        jax_solve_width(int(100 * HBM_BYTES_PER_CHIP)) == 2


def test_the_cpu_has_no_per_chip_figure(monkeypatch):
    """No TPU figure is a default: on the CPU the solve needs a named
    figure, and a plan without one keeps the pin or width 1."""
    monkeypatch.delenv("RAFIKI_SHARD_WIDTH", raising=False)
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError):
        solve_width(10 ** 12)
    module = torch.nn.Linear(64, 32)
    plan = ShardPlan.for_params(module, device="cpu")
    assert (plan.width, plan.per_chip_bytes, plan.hbm_frac()) == (1, 0, 0.0)
    monkeypatch.setenv("RAFIKI_SHARD_WIDTH", "4")
    assert ShardPlan.for_params(module, device="cpu").width == 4


def test_plan_figures_match_the_jax_packages(lane):
    """The same params in both packages: raw bytes, the 4x estimate, the
    width and headroom at the JAX package's figure, and every leaf's
    axis at widths 2 and 4 (the manifest's spec)."""
    jm, m = lane["jax_model"], lane["serial"]
    jparams = jm._loop.params
    assert state_bytes(m._module) == jax_state_bytes(jparams)
    got = ShardPlan.for_params(m._module, family="t", per_chip_bytes=HBM_BYTES_PER_CHIP)
    want = JaxShardPlan.for_params(jparams, family="t")
    assert (got.width, got.hbm_bytes) == (want.width, want.hbm_bytes)
    assert got.hbm_frac() == pytest.approx(want.hbm_frac(), rel=1e-12)
    man = load_manifest(JaxParamsStore(lane["jax_dir"]).latest_checkpoint("jt")[1])
    shapes = {e["k"]: tuple(e["shape"]) for e in man["spec"]}
    assert ShardPlan(width=2).axes_map(shapes) == {e["k"]: e["axis"] for e in man["spec"]}
    assert lane["loops"][2][1].state.axes == {e["k"]: e["axis"] for e in man["spec"]}
    assert lane["loops"][4][1].state.axes == ShardPlan(width=4).axes_map(shapes)


# -- the lane: width invariance and reshard round trips ------------------------


def _leaves(blob):
    return load_flat(pickle.loads(blob)["packed"])


def _equal(a, b):
    return set(a) == set(b) and all(a[k].dtype == b[k].dtype and torch.equal(a[k], b[k])
                                    for k in a)


@pytest.mark.parametrize("width", [1, 2, 4])
def test_sharded_trial_is_byte_identical_to_the_serial_trial(lane, width):
    from rafiki_tpu_torch.convert import state_dict_to_flax

    m, loop, history = lane["loops"][width]
    serial = lane["serial"]
    # float32 params and Adam's state, and the served blob
    assert _equal(state_dict_to_flax(m._module), state_dict_to_flax(serial._module))
    got, want = m._loop.state[1], serial._loop.state[1]
    assert got.count == want.count and m._loop.state[2] == serial._loop.state[2]
    assert all(torch.equal(a, b) for a, b in zip(got.mu + got.nu, want.mu + want.nu))
    assert _equal(_leaves(m.dump_parameters()), _leaves(serial.dump_parameters()))
    assert m.evaluate(VAL) == serial.evaluate(VAL)
    assert loop.width == width and [h["epoch"] for h in history] == [0, 1]
    # the group's own full-batch eval (member 0's gathered state)
    ds = m._prepared_dataset(VAL)
    assert loop.evaluate(ds, 8) == lane["loops"][1][1].evaluate(ds, 8)
    assert history[-1]["loss"] == lane["loops"][1][2][-1]["loss"]
    # every member's slice is a copy on its own device; together they
    # gather to the serial state
    assert all(s[k].device == CPU for s in loop.state.shards for k in s)


@pytest.mark.parametrize("from_w,to_w", [(1, 2), (2, 1), (2, 4), (4, 2)])
def test_reshard_roundtrip_bitmatches(lane, tmp_path, from_w, to_w):
    src, dst = lane["loops"][from_w][1], lane["loops"][to_w][1]
    store = ParamsStore(tmp_path)
    save_sharded(store, "t1", 1, src.state, src.width)
    epoch, blob = store.latest_checkpoint("t1")
    assert epoch == 1 and is_manifest(blob)
    restored = restore_sharded(store, blob, dst.state, dst.devices, dst.plan)
    assert restored.width == to_w
    assert _equal(gather_state(restored), gather_state(src.state))
    assert restored.generator == src.state.generator


def test_missing_chunk_fails_naming_the_chunk(lane, tmp_path):
    src = lane["loops"][2][1]
    store = ParamsStore(tmp_path)
    save_sharded(store, "t1", 0, src.state, 2)
    man = json.loads(store.latest_checkpoint("t1")[1].decode())
    man["shards"][1] = "t1_ckpt_0_s1of2_GONE"
    with pytest.raises(IOError, match="t1_ckpt_0_s1of2_GONE"):
        restore_sharded(store, json.dumps(man).encode(), src.state, src.devices, src.plan)


def test_doctored_wrong_width_chunk_is_caught(lane, tmp_path):
    """A width-4 chunk spliced into a width-2 manifest: every sharded leaf
    in it is a 1/4 slice where the manifest promises 1/2; the reader
    refuses, naming the chunk."""
    src2, src4 = lane["loops"][2][1], lane["loops"][4][1]
    store = ParamsStore(tmp_path)
    save_sharded(store, "a", 0, src2.state, 2)
    save_sharded(store, "b", 0, src4.state, 4)
    man = json.loads(store.latest_checkpoint("a")[1].decode())
    man["shards"][0] = "b_ckpt_0_s0of4"
    with pytest.raises(IOError, match="b_ckpt_0_s0of4"):
        restore_sharded(store, json.dumps(man).encode(), src2.state, src2.devices, src2.plan)


def test_inconsistent_manifest_width_is_refused(lane, tmp_path):
    src = lane["loops"][2][1]
    store = ParamsStore(tmp_path)
    save_sharded(store, "t1", 0, src.state, 2)
    man = json.loads(store.latest_checkpoint("t1")[1].decode())
    man["width"] = 3  # claims 3, lists 2 chunks
    with pytest.raises(IOError, match="wrong-width"):
        load_manifest(json.dumps(man).encode())
    with pytest.raises(IOError, match="wrong format"):
        load_manifest(b'{"format": "not-a-manifest"}')
    assert not is_manifest(b"\x80\x05...pickled") and not is_manifest(b'{"format": "other"}')


# -- manifests across packages --------------------------------------------------


@pytest.mark.parametrize("width", [1, 2])
def test_a_jax_manifest_restores_in_the_port(lane, width):
    """The JAX package's width-2 epoch-0 manifest restored at ``width``:
    the port's trial state holds every leaf of it, by name, in flax's
    layout, but the threefry key (leaf ``3``: the port keeps its own
    generator), and resumes after epoch 0."""
    store = ParamsStore(lane["jax_dir"])
    _, blob = store.latest_checkpoint("jt")
    m, loop, history = _port_run(width, epochs=1, resume_from=(store, "jt"))
    assert history == []  # epoch 0 restored, nothing left of a 1-epoch trial
    saved = {e["k"]: e for e in load_manifest(blob)["spec"]}
    from rafiki_tpu_torch.shard.checkpoint import _ShardReader

    reader = _ShardReader(store, load_manifest(blob))
    got = gather_state(loop.state)
    assert set(got) == set(saved)
    for k, e in saved.items():
        if k == "3":
            continue
        n = e["shape"][e["axis"]] if e["axis"] is not None else 1
        assert torch.equal(got[k], reader.leaf_range(k, 0, n)), k
    # ...and the serial loop it hands over holds those params
    from rafiki_tpu_torch.convert import state_dict_to_flax

    params = state_dict_to_flax(m._module)
    assert all(torch.equal(params[k], got[f"0/{k}"]) for k in params)
    assert load_manifest(blob)["extra"] == {}  # a JAX manifest names no package


@pytest.mark.parametrize("width", [1, 2])
def test_a_port_manifest_restores_in_the_jax_package(lane, tmp_path, width):
    src = lane["loops"][2][1]
    store = ParamsStore(tmp_path)
    save_sharded(store, "pt", 1, src.state, 2)
    blob = store.latest_checkpoint("pt")[1]
    assert load_manifest(blob)["extra"]["package"] == "rafiki_tpu_torch"
    jloop = lane["jax_loop"] if width == 2 else None
    if jloop is None:
        from rafiki_tpu.shard import ShardedTrainLoop as JaxLoop

        jm, ds = lane["jax_model"], None
        ds = jm._prepared_dataset(TRAIN)
        fns = jm._loop_fns(*jm._dataset_arch(ds))
        jloop = JaxLoop(fns["init_fn"], fns["apply_eval"], fns["loss_fn"], fns["optimizer"],
                        devices=jax.devices()[:1], seed=0, hyper=fns["hyper"],
                        plan=JaxShardPlan(width=1))
    state = jax_restore(JaxParamsStore(tmp_path), blob, jloop.state, jloop.mesh, jloop.plan)
    got, want = _flat_jax(state), gather_state(src.state)
    assert set(got) == set(want)
    assert all(torch.equal(got[k], want[k]) for k in want), \
        [k for k in want if not torch.equal(got[k], want[k])]


def test_the_port_rewrites_a_jax_manifests_chunks_byte_for_byte(lane, tmp_path):
    """Restored at width 2 and saved again, a JAX manifest's chunks come
    back with the same leaf names, shapes, axes and bytes; only shard 0,
    which carries the generator leaf ``3`` (the port writes its seed
    key), differs, and only in that leaf."""
    jstore = ParamsStore(lane["jax_dir"])
    _, jblob = jstore.latest_checkpoint("jt")
    _, loop, _ = _port_run(2, epochs=1, resume_from=(jstore, "jt"))
    store = ParamsStore(tmp_path)
    save_sharded(store, "jt", 0, loop.state, 2)
    jman, man = load_manifest(jblob), load_manifest(store.latest_checkpoint("jt")[1])
    assert man["spec"] == jman["spec"] and man["shards"] == jman["shards"]
    assert store.load("jt_ckpt_0_s1of2") == jstore.load("jt_ckpt_0_s1of2")
    a, b = load_flat(store.load("jt_ckpt_0_s0of2")), load_flat(jstore.load("jt_ckpt_0_s0of2"))
    assert set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a if k != "3")


def test_the_port_width2_trial_agrees_with_the_jax_packages(lane):
    """Both packages resume epoch 1 of the same width-2 trial from the
    JAX package's epoch-0 manifest (the same params and Adam state):
    the port's final params are within F32_TOL of the JAX package's
    width-2 trial's, its score too (readings: params 6.0e-8 max abs and
    7.7e-7 of the distance moved, key bias aside; scores equal)."""
    jm = lane["jax_model"]
    store = ParamsStore(lane["jax_dir"])
    m, _, _ = _port_run(2, resume_from=(store, "jt"))
    from rafiki_tpu.shard.checkpoint import _ShardReader as JaxReader
    from rafiki_tpu.shard.checkpoint import load_manifest as jax_load_manifest

    reader = JaxReader(JaxParamsStore(lane["jax_dir"]),
                       jax_load_manifest(store.latest_checkpoint("jt")[1]))
    start = {}
    for e in reader._man["spec"]:
        if e["k"].startswith("0/"):
            n = e["shape"][e["axis"]] if e["axis"] is not None else 1
            start[e["k"][2:]] = np.asarray(reader.leaf_range(e["k"], 0, n), np.float32)
    from flax.traverse_util import flatten_dict

    from rafiki_tpu_torch.convert import state_dict_to_flax

    ref = {"params": {k: np.asarray(v) for k, v in
                      flatten_dict(jax.device_get(jm._loop.params), sep="/").items()}}
    got = {"params": {k: v.numpy() for k, v in state_dict_to_flax(m._module).items()}}
    _zero_gradient_leaves((ref, got), start, KNOBS["learning_rate"], 3)
    gap = max(float(np.abs(ref["params"][k] - got["params"][k]).max()) for k in got["params"])
    num = np.sqrt(sum(float(((ref["params"][k] - got["params"][k]) ** 2).sum())
                      for k in got["params"]))
    den = np.sqrt(sum(float(((ref["params"][k] - start[k]) ** 2).sum()) for k in got["params"]))
    print("width-2 trial vs the JAX package's:", gap, num / den)
    assert gap <= F32_TOL["param_max_abs"] and num / den <= F32_TOL["param_rel_l2"]
    assert abs(m.evaluate(VAL) - jm.evaluate(VAL)) <= F32_TOL["score"]


def test_the_generator_rides_a_port_manifest(lane, tmp_path):
    """A port manifest carries the dropout generator's state; restored on
    the same device type it becomes every member's."""
    src = lane["loops"][2][1]
    store = ParamsStore(tmp_path)
    gen = torch.Generator().manual_seed(1234)
    torch.rand(7, generator=gen)
    src.state.generator = {"device": "cpu", "state": bytes(gen.get_state().numpy())}
    save_sharded(store, "g", 0, src.state, 2)
    _, loop, _ = _port_run(4, epochs=1, resume_from=(store, "g"))
    for member in loop._members:
        assert torch.equal(member[3].get_state(), gen.get_state())


# -- the zoo's sharded-lane citizen and the lane through the sweep ----------------


def test_transformer_declares_a_shard_plan(monkeypatch):
    """The zoo's sharded-lane citizen: its plan solves from the parameter
    shapes (width 1 on this small config without the pin) and honours the
    pin, the exact decision point the scheduler's lane fork reads. Its
    estimate is the JAX package's plus the embedding rows the JAX package
    leaves out (its plan builds the module before it reads the dataset's
    vocabulary, so it counts an embedding of 2 rows, not 81)."""
    from rafiki_tpu.models.transformer import Transformer as JaxTransformer
    from rafiki_tpu_torch.models.transformer import Transformer

    knobs = dict(embed_dim=32, num_heads=2, num_layers=1, learning_rate=5e-3, batch_size=32,
                 epochs=1, seed=0)
    uri = "synthetic://text?vocab=81&classes=5&n=64&len=16&seed=0"
    m, jm = Transformer(device="cpu", **knobs), JaxTransformer(**knobs)
    ds = m._prepared_dataset(uri)
    monkeypatch.delenv("RAFIKI_SHARD_WIDTH", raising=False)
    plan = m.shard_plan(ds)
    assert isinstance(plan, ShardPlan)
    assert plan.width == 1 and plan.hbm_bytes > 0 and m._loop is None
    jplan = jm.shard_plan(jm._prepared_dataset(uri))
    assert plan.hbm_bytes == jplan.hbm_bytes + 4 * 4 * 32 * (81 - 2)
    at = m.shard_plan(ds, per_chip_bytes=HBM_BYTES_PER_CHIP)
    assert (at.width, at.hbm_frac()) == (1, plan.hbm_bytes / HBM_BYTES_PER_CHIP)
    monkeypatch.setenv("RAFIKI_SHARD_WIDTH", "2")
    assert m.shard_plan(ds).width == 2 == jm.shard_plan(jm._prepared_dataset(uri)).width


def test_a_width2_group_trial_through_the_sweep(tmp_path, monkeypatch, capsys):
    """RAFIKI_SHARD_WIDTH=2: the sweep buckets the proposal on the
    sharded lane, a GroupHandle trains it on both chips, the stored
    params equal the serial trial's byte for byte, and ``obs shard``
    reads the width history back out of the journal."""
    from rafiki_tpu_torch.chaos.scenarios import SHARD_SOURCE, SHARD_TRAIN, SHARD_VAL
    from rafiki_tpu_torch.model.base import load_model_class
    from rafiki_tpu_torch.obs import cli
    from rafiki_tpu_torch.obs.journal import journal
    from rafiki_tpu_torch.scheduler import MeshSweepScheduler
    from rafiki_tpu_torch.store import MetaStore

    monkeypatch.setenv("RAFIKI_SHARD_WIDTH", "2")
    monkeypatch.setenv("RAFIKI_CHECKPOINT_EVERY", "1")
    store, params = MetaStore(tmp_path / "meta.sqlite3"), ParamsStore(tmp_path / "params")
    model = store.create_model("shardtf", "TEXT_CLASSIFICATION", None, SHARD_SOURCE, "ShardTf")
    job = store.create_train_job("s", "TEXT_CLASSIFICATION", None, SHARD_TRAIN, SHARD_VAL,
                                 {"MODEL_TRIAL_COUNT": 1})
    store.create_sub_train_job(job["id"], model["id"])
    journal.configure(tmp_path / "obs", role="test")
    try:
        result = MeshSweepScheduler(store, params).run_sweep(
            job["id"], chips=2, trials_per_chip=1, advisor_kind="random", devices=[CPU, CPU])
    finally:
        journal.close()
    assert result.status == "COMPLETED", result.errors
    [t] = result.trials
    assert t["worker_id"].endswith("-shard-g0") and t["score"] is not None
    assert params.latest_checkpoint(t["id"]) is None  # superseded, deleted
    ref = load_model_class(SHARD_SOURCE, "ShardTf")(device="cpu", **t["knobs"])
    ref.train(SHARD_TRAIN)
    assert _equal(_leaves(params.load(t["params_id"])), _leaves(ref.dump_parameters()))
    capsys.readouterr()
    assert cli.main(["--dir", str(tmp_path / "obs"), "shard"]) == 0
    out = capsys.readouterr().out
    assert "width history: 2" in out and "plan    family=ShardTf width=2" in out
    assert "3 group epoch wall(s)" in out
    assert cli.main(["--dir", str(tmp_path), "shard"]) == 1  # no journal there
