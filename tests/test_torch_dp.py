"""Within-trial data parallelism of the port against the JAX package's
dp mesh and against its own width-1 trial, on the CPU over gloo.

A width-2 dp trial is two processes (``tests/torch_dp_rank.py``), one
rank each of a gloo group, as the ``ProcessScheduler`` runs one. Both
start from the same flax-drawn float32 params:

  * a FeedForward 2 x 32 for 5 steps at dropout 0 against the JAX
    package's trial on a 2-device mesh and against the port's width-1
    trial: the last epoch's loss and accuracy, the sentinel norms, the
    eval score and the final params within ``tests/test_torch_train.py``
    F32_TOL (the gradients are summed in another order, nothing else
    differs);
  * a VGG11 w0.25 for 3 steps at dropout 0.3 against the port's width-1
    trial, within the same F32_TOL: each rank's dropout mask and batch
    rows are the width-1 trial's rows ``[r*B/2, (r+1)*B/2)``, bit for bit.

Both ranks end with identical params. In one process, a width-1 gloo
mesh gives the no-mesh trial's params bit for bit (the CPU counterpart
of the card's width-1 NCCL check), the program cache keys the mesh, and
the pieces (batch slices, masks, the reduction, collective failures,
refusals) are checked one by one.

The in-process mesh (several devices in one process, the JAX package's
one program over k devices) runs its replicas on ``[cpu] * k``: at one
intra-op thread its width 2 is the gloo pair bit for bit (the same pair
of rank processes serves both tests), widths 2 and 4 are within
F32_TOL of the JAX package's 2- and 4-device meshes, its replicas end
equal, and at dropout 0.3 each replica takes the width-1 trial's rows
and masks.
"""

import datetime
import json
import os
import pickle
import socket
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from rafiki_tpu.models.ff import _Mlp as JaxMlp
from rafiki_tpu.models.vgg import _Vgg as JaxVggModule
from rafiki_tpu.parallel.mesh import data_parallel_mesh as jax_mesh
from rafiki_tpu_torch.model.dataset import dataset_utils
from rafiki_tpu_torch.ops import train as ops_train
from rafiki_tpu_torch.parallel.mesh import data_parallel_mesh
from rafiki_tpu_torch.parallel.multihost import global_put, is_leader
from tests import torch_dp_rank
from tests.test_torch_ff import JaxFF32
from tests.test_torch_train import F32_TOL, blob_params, flax_init_blob, readings, train_one

# See test_torch_train.py: two intra-op threads per xdist worker.
torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
IMAGES_1 = "synthetic://images?classes=10&w=8&h=8&c=1&n={n}&seed={seed}"
IMAGES_3 = "synthetic://images?classes=10&w=8&h=8&c=3&n={n}&seed={seed}"
FF_KNOBS = dict(hidden_layers=2, hidden_units=32, learning_rate=1e-3, batch_size=32,
                epochs=1, seed=0)
VGG_KNOBS = dict(depth=11, width_mult=0.25, dropout=0.3, learning_rate=1e-3, batch_size=64,
                 epochs=1, seed=0)
RANK_TIMEOUT_S = 120


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_ranks(tmp_path, world, template, knobs, blob, train_uri, val_uri):
    """``world`` rank processes of one dp trial; their results by rank."""
    blob_path = tmp_path / "init.blob"
    blob_path.write_bytes(blob)
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(ROOT), os.environ.get("PYTHONPATH")) if p), OMP_NUM_THREADS="1")
    procs, outs = [], []
    for r in range(world):
        out = tmp_path / f"rank{r}.pkl"
        outs.append(out)
        procs.append(subprocess.Popen(
            [sys.executable, str(ROOT / "tests" / "torch_dp_rank.py"), str(r), str(world),
             str(port), template, json.dumps(knobs), str(blob_path), train_uri, val_uri,
             str(out)], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=RANK_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0] * world, logs
    return [pickle.loads(o.read_bytes()) for o in outs]


class JaxFFDp(JaxFF32):
    """The JAX package's float32 FF trial on a 2-device dp mesh."""

    def __init__(self, **knobs):
        super().__init__(**knobs)
        self.set_mesh(jax_mesh(jax.devices()[:2]))


def _check(ref, got, start, label):
    r = readings(ref, got, start)
    print(label, r)
    assert r["nonfinite"] == (0, 0) and r["bad_step"] == (-1, -1), r
    for key, bound in F32_TOL.items():
        assert r[key] <= bound, (label, key, r)


@pytest.fixture(scope="module")
def ff_width2(tmp_path_factory):
    """The FeedForward trial's start params, its datasets and the results
    of its two gloo ranks: one pair of rank processes for every test that
    reads them."""
    blob = flax_init_blob(JaxMlp(hidden_layers=2, hidden_units=32, num_classes=10,
                                 dtype=jnp.float32), (8, 8, 1))
    train_uri, val_uri = IMAGES_1.format(n=32 * 5, seed=0), IMAGES_1.format(n=100, seed=1)
    ranks = _run_ranks(tmp_path_factory.mktemp("ff_ranks"), 2, "ff", FF_KNOBS, blob,
                       train_uri, val_uri)
    return blob, train_uri, val_uri, ranks


def test_width2_ff_matches_the_jax_mesh_and_the_width1_trial(ff_width2):
    """The two ranks' half-batch gradients are summed, then halved, where
    the width-1 step sums the whole batch. Readings (-s prints them):
    against the JAX mesh, loss 1.0e-7 rel, update norm 1.7e-6, params
    3.0e-8 max abs and 5.6e-7 of the distance moved; against the port's
    width 1, loss 1.0e-7, params 1.5e-8 and 3.6e-7; accuracies and
    scores equal. Held to F32_TOL."""
    blob, train_uri, val_uri, ranks = ff_width2
    start = blob_params(blob)
    jax_dp = train_one("jax", JaxFFDp, FF_KNOBS, blob, train_uri, val_uri)
    port_w1 = torch_dp_rank.train("ff", FF_KNOBS, blob, train_uri, val_uri)
    _check(jax_dp, ranks[0], start, "port width 2 vs jax mesh of 2")
    _check(port_w1, ranks[0], start, "port width 2 vs port width 1")
    for k in ranks[0]["params"]:
        np.testing.assert_array_equal(ranks[0]["params"][k], ranks[1]["params"][k])
    assert ranks[0]["values"] == ranks[1]["values"]
    assert ranks[0]["health"] == ranks[1]["health"]
    assert ranks[0]["score"] == ranks[1]["score"]


def test_width2_vgg_with_dropout_matches_the_width1_trial(tmp_path):
    """At dropout 0.3 each rank draws the width-1 trial's masks, so the
    ranks train what the width-1 trial trains, within F32_TOL. Readings:
    loss equal, grad norm 3.2e-7 rel, params 1.6e-6 max abs and 2.7e-6
    of the distance moved, score equal."""
    blob = flax_init_blob(JaxVggModule(depth=11, width_mult=0.25, num_classes=10, dropout=0.0,
                                       dtype=jnp.float32), (8, 8, 3))
    train_uri, val_uri = IMAGES_3.format(n=64 * 3, seed=0), IMAGES_3.format(n=100, seed=1)
    ranks = _run_ranks(tmp_path, 2, "vgg", VGG_KNOBS, blob, train_uri, val_uri)
    port_w1 = torch_dp_rank.train("vgg", VGG_KNOBS, blob, train_uri, val_uri)
    _check(port_w1, ranks[0], blob_params(blob), "vgg port width 2 vs width 1")
    b = VGG_KNOBS["batch_size"] // 2
    data = dataset_utils.load(train_uri)
    first = np.random.default_rng(VGG_KNOBS["seed"]).permutation(data.size)[:2 * b]
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got["mask"], port_w1["mask"][r * b:(r + 1) * b])
        np.testing.assert_array_equal(got["rows"]["x"], data.x[first[r * b:(r + 1) * b]])
        np.testing.assert_array_equal(got["rows"]["y"], data.y[first[r * b:(r + 1) * b]])
    assert 0.6 < port_w1["mask"].mean() < 0.8  # rate 0.3 did drop
    for k in ranks[0]["params"]:
        np.testing.assert_array_equal(ranks[0]["params"][k], ranks[1]["params"][k])


# -- one process: the in-process mesh ---------------------------------------------


def _replicas_equal(m) -> bool:
    """Every replica of an in-process trial holds replica 0's params."""
    own = list(m._module.parameters())
    return all(len(own) == len(list(rep.parameters())) and
               all(torch.equal(a, b) for a, b in zip(own, rep.parameters()))
               for rep, _ in m._loop.plan.replicas)


def _in_process(template, knobs, blob, train_uri, val_uri, width, threads=None):
    """One trial of the port on an in-process mesh of ``width`` CPU
    replicas (``threads``: the intra-op threads it runs with)."""
    before = torch.get_num_threads()
    if threads is not None:
        torch.set_num_threads(threads)
    try:
        mesh = data_parallel_mesh([torch.device("cpu")] * width)
        got = torch_dp_rank.train(template, knobs, blob, train_uri, val_uri, mesh=mesh)
    finally:
        torch.set_num_threads(before)
    return got


def test_in_process_width2_ff_is_the_gloo_group_bit_for_bit(ff_width2, monkeypatch):
    """At one intra-op thread, as each rank process runs, the in-process
    replicas compute each rank's rows as the rank does, and the sum of
    two gradients is the same in either order: the params, every
    epoch's values, the sentinels and the score are rank 0's exactly,
    and the replicas end equal."""
    blob, train_uri, val_uri, ranks = ff_width2
    trials = []
    build = torch_dp_rank.FF32.train

    def keep(self, uri):
        trials.append(self)
        return build(self, uri)

    monkeypatch.setattr(torch_dp_rank.FF32, "train", keep)
    got = _in_process("ff", FF_KNOBS, blob, train_uri, val_uri, 2, threads=1)
    assert got["values"] == ranks[0]["values"] and got["health"] == ranks[0]["health"]
    assert got["score"] == ranks[0]["score"]
    assert sorted(got["params"]) == sorted(ranks[0]["params"])
    for k in got["params"]:
        np.testing.assert_array_equal(got["params"][k], ranks[0]["params"][k])
    m = trials[0]
    assert m._loop.plan.mesh.world_size == 2 and _replicas_equal(m)
    assert m._loop._perf_key[1] == (("dp",), ("cpu", "cpu"))


class JaxFFDp4(JaxFF32):
    """The JAX package's float32 FF trial on a 4-device dp mesh."""

    def __init__(self, **knobs):
        super().__init__(**knobs)
        self.set_mesh(jax_mesh(jax.devices()[:4]))


@pytest.mark.parametrize("width", [2, 4])
def test_in_process_ff_matches_the_jax_mesh(width, monkeypatch):
    """Widths 2 and 4 of the in-process mesh against the JAX package's
    trial on a mesh of as many devices, held to F32_TOL, with the
    replicas equal bit for bit after training."""
    blob = flax_init_blob(JaxMlp(hidden_layers=2, hidden_units=32, num_classes=10,
                                 dtype=jnp.float32), (8, 8, 1))
    train_uri, val_uri = IMAGES_1.format(n=32 * 5, seed=0), IMAGES_1.format(n=100, seed=1)
    trials = []
    build = torch_dp_rank.FF32.train

    def keep(self, uri):
        trials.append(self)
        return build(self, uri)

    monkeypatch.setattr(torch_dp_rank.FF32, "train", keep)
    got = _in_process("ff", FF_KNOBS, blob, train_uri, val_uri, width)
    ref = train_one("jax", JaxFFDp if width == 2 else JaxFFDp4, FF_KNOBS, blob, train_uri,
                    val_uri)
    _check(ref, got, blob_params(blob), f"port in-process width {width} vs jax mesh")
    assert trials[0]._loop.plan.mesh.world_size == width and _replicas_equal(trials[0])


def test_in_process_width2_vgg_with_dropout_takes_the_width1_rows_and_masks(monkeypatch):
    """At dropout 0.3 the step's global noise is drawn once from the
    trial's generator: each replica's first mask and rows are the width-1
    trial's rows ``[r*B/2, (r+1)*B/2)``, bit for bit, and the trial is
    within F32_TOL of the width-1 trial."""
    from rafiki_tpu_torch.parallel import multihost

    blob = flax_init_blob(JaxVggModule(depth=11, width_mult=0.25, num_classes=10, dropout=0.0,
                                       dtype=jnp.float32), (8, 8, 3))
    train_uri, val_uri = IMAGES_3.format(n=64 * 3, seed=0), IMAGES_3.format(n=100, seed=1)
    masks, rows = {}, []
    noise, put = ops_train.DpGenerator.noise, multihost.replica_put
    keep = 1.0 - torch.tensor(VGG_KNOBS["dropout"], dtype=torch.float32)

    def spy_noise(self, x):
        out = noise(self, x)
        masks.setdefault(self.rank, (out < keep).numpy())
        return out

    def spy_put(batch, mesh):
        out = put(batch, mesh)
        if not rows:
            rows.extend({k: v.numpy().copy() for k, v in part.items()} for part in out)
        return out

    monkeypatch.setattr(ops_train.DpGenerator, "noise", spy_noise)
    monkeypatch.setattr(multihost, "replica_put", spy_put)
    got = _in_process("vgg", VGG_KNOBS, blob, train_uri, val_uri, 2)
    monkeypatch.undo()
    port_w1 = torch_dp_rank.train("vgg", VGG_KNOBS, blob, train_uri, val_uri)
    _check(port_w1, got, blob_params(blob), "vgg port in-process width 2 vs width 1")
    b = VGG_KNOBS["batch_size"] // 2
    data = dataset_utils.load(train_uri)
    first = np.random.default_rng(VGG_KNOBS["seed"]).permutation(data.size)[:2 * b]
    assert sorted(masks) == [0, 1] and len(rows) == 2
    for r in range(2):
        np.testing.assert_array_equal(masks[r], port_w1["mask"][r * b:(r + 1) * b])
        np.testing.assert_array_equal(rows[r]["x"], data.x[first[r * b:(r + 1) * b]])
        np.testing.assert_array_equal(rows[r]["y"], data.y[first[r * b:(r + 1) * b]])


def test_several_devices_without_a_group_give_the_in_process_mesh():
    mesh = data_parallel_mesh(["cpu", torch.device("cpu")])
    assert mesh.in_process and mesh.world_size == 2 and mesh.rank == 0
    assert mesh.devices == (torch.device("cpu"),) * 2 and mesh.device == torch.device("cpu")
    assert ops_train.mesh_cache_key(mesh) == (("dp",), ("cpu", "cpu"))
    assert ops_train.mesh_cache_key(mesh) != ops_train.mesh_cache_key(
        types.SimpleNamespace(axis_names=("dp",), world_size=2, device=torch.device("cpu")))
    with pytest.raises(RuntimeError, match="process group"):
        data_parallel_mesh([torch.device("cpu")])
    with pytest.raises(ValueError, match="one type"):
        data_parallel_mesh([torch.device("cpu"), torch.device("cuda", 0)])


def test_the_in_process_reduce_is_the_mean_in_replica_order():
    """The flat sums run on devices[0] in replica order, then the mean is
    copied back into every replica's tensors, in place."""
    plan = ops_train._ShardingPlan(data_parallel_mesh(["cpu"] * 3))
    rng = np.random.default_rng(0)
    per = [[torch.from_numpy(rng.normal(size=(2, 3)).astype(np.float32)),
            torch.tensor(float(r))] for r in range(3)]
    want = [(per[0][i] + per[1][i] + per[2][i]) / 3 for i in range(2)]
    ids = [[id(t) for t in ts] for ts in per]
    plan.reduce_replicas(per)
    for ts, before in zip(per, ids):
        assert [id(t) for t in ts] == before
        for t, w in zip(ts, want):
            assert torch.equal(t, w)


# -- one process: a width-1 gloo group ------------------------------------------


@pytest.fixture()
def group1():
    """A one-rank gloo group in this process, destroyed afterwards."""
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{_free_port()}",
                            world_size=1, rank=0, timeout=datetime.timedelta(seconds=30))
    try:
        yield data_parallel_mesh([torch.device("cpu")])
    finally:
        dist.destroy_process_group()


def test_a_width1_gloo_trial_is_the_no_mesh_trial_bit_for_bit(group1):
    """One rank: its all-reduce and the division by 1 change no bit, and
    the host-formed batches are the resident path's, so the params, the
    metrics and the sentinels are the no-mesh trial's exactly."""
    blob = flax_init_blob(JaxVggModule(depth=11, width_mult=0.25, num_classes=10, dropout=0.0,
                                       dtype=jnp.float32), (8, 8, 3))
    train_uri, val_uri = IMAGES_3.format(n=64 * 3, seed=0), IMAGES_3.format(n=100, seed=1)
    plain = torch_dp_rank.train("vgg", VGG_KNOBS, blob, train_uri, val_uri)
    meshed = torch_dp_rank.train("vgg", VGG_KNOBS, blob, train_uri, val_uri, mesh=group1)
    assert meshed["values"] == plain["values"] and meshed["health"] == plain["health"]
    assert meshed["score"] == plain["score"]
    for k in plain["params"]:
        np.testing.assert_array_equal(meshed["params"][k], plain["params"][k])
    np.testing.assert_array_equal(meshed["mask"], plain["mask"])
    assert group1.rank == 0 and group1.world_size == 1 and is_leader()


def test_the_program_cache_keys_the_mesh(group1):
    key = ops_train.mesh_cache_key(group1)
    assert key == (("dp",), 1, "cpu") and ops_train.mesh_cache_key(None) is None
    m = torch_dp_rank.TEMPLATES["ff"](device="cpu", **FF_KNOBS)
    m.set_mesh(group1)
    m.init_parameters(10, (8, 8, 1))
    assert m._loop._perf_key[1] == key and m._loop.plan.mesh is group1
    plain = torch_dp_rank.TEMPLATES["ff"](device="cpu", **FF_KNOBS)
    plain.init_parameters(10, (8, 8, 1))
    assert plain._loop._perf_key[1] is None
    assert plain._loop._perf_key[0] == m._loop._perf_key[0]


def test_the_plan_averages_over_the_group_and_raises_a_collective_error(group1, monkeypatch):
    plan = ops_train._ShardingPlan(group1)
    ts = [torch.arange(6, dtype=torch.float32).reshape(2, 3), torch.tensor(2.5)]
    out = plan.reduce(ts)
    assert all(torch.equal(a, b) and a.shape == b.shape for a, b in zip(out, ts))

    def broken(*args, **kwargs):
        raise RuntimeError("Connection closed by peer")

    monkeypatch.setattr(dist, "all_reduce", broken)
    with pytest.raises(ops_train.CollectiveError, match="Connection closed by peer"):
        plan.reduce(ts)


def test_a_mesh_refuses_several_devices_and_the_wrong_backend(group1):
    """Inside a process group a rank owns one device: several (the JAX
    package's multihost hybrid) are refused, as is a backend that is not
    the device's."""
    with pytest.raises(NotImplementedError, match="hybrid"):
        data_parallel_mesh([torch.device("cpu"), torch.device("cpu")])
    with pytest.raises(ValueError, match="nccl"):
        data_parallel_mesh([torch.device("cuda", 0)])


# -- the pieces, no group ------------------------------------------------------


@pytest.mark.parametrize("world", [2, 4])
def test_global_put_tiles_the_global_batch(world):
    rng = np.random.default_rng(world)
    batch = {"x": rng.normal(size=(8, 3, 2)).astype(np.float32),
             "y": rng.integers(0, 9, size=8)}
    parts = [global_put(batch, types.SimpleNamespace(rank=r, world_size=world,
                                                     device=torch.device("cpu")))
             for r in range(world)]
    for k in batch:
        np.testing.assert_array_equal(np.concatenate([p[k].numpy() for p in parts]), batch[k])
    with pytest.raises(ValueError, match="does not split"):
        global_put({"x": np.zeros((6, 2))}, types.SimpleNamespace(
            rank=0, world_size=4, device=torch.device("cpu")))


@pytest.mark.parametrize("world", [2, 4])
def test_a_ranks_dropout_mask_is_its_rows_of_the_width1_mask(world):
    x = torch.ones(16, 5, 3)
    want = ops_train.dropout(x, torch.tensor(0.4), torch.Generator().manual_seed(3), False)
    b = 16 // world
    for r in range(world):
        g = torch.Generator().manual_seed(3)
        got = ops_train.dropout(x[:b], torch.tensor(0.4), ops_train.DpGenerator(g, r, world),
                                False)
        assert torch.equal(got, want[r * b:(r + 1) * b])
        # The rank's stream moved on as the width-1 stream did.
        ref = torch.Generator().manual_seed(3)
        torch.rand(16, 5, 3, generator=ref)
        assert torch.equal(g.get_state(), ref.get_state())
