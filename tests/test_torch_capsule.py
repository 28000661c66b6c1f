"""Replay capsules in the port, on the CPU: the counterparts of
``tests/test_health.py``'s capsule, containment and CLI tests.

A divergence banks a capsule (``rafiki_tpu_torch/obs/health/
capsule.py``) whose replay re-executes the bad epoch's prefix and
reproduces its sentinel values bit for bit, serial or out of a pack;
no journal, or ``RAFIKI_HEALTH_CAPSULE=off``, means no snapshot and no
capsule; the worker contains the divergence, serial and packed; the
CLI's ``health``, ``curves`` and ``replay`` read it back. The capsule's
payload and the replay's verdict carry the JAX package's keys for the
same spec, seed and model.
"""

import glob
import io
import math
import os
import pickle
from contextlib import redirect_stdout

import pytest
import torch

from rafiki_tpu.chaos import FaultPlane as JaxFaultPlane
from rafiki_tpu.chaos import install as jax_install, uninstall as jax_uninstall
from rafiki_tpu.models.ff import FeedForward as JaxFeedForward
from rafiki_tpu.obs.health import DivergenceError as JaxDivergenceError
from rafiki_tpu.obs.health import capsule as jax_capsule
from rafiki_tpu.obs.journal import journal as jax_journal
from rafiki_tpu_torch.chaos import FaultPlane, install, uninstall
from rafiki_tpu_torch.model.base import GENERATOR_KEY, TorchModel
from rafiki_tpu_torch.models.ff import FeedForward
from rafiki_tpu_torch.models.vgg import Vgg
from rafiki_tpu_torch.obs import cli
from rafiki_tpu_torch.obs.health import DivergenceError, HealthMonitor, capsule
from rafiki_tpu_torch.obs.health import detector as health
from rafiki_tpu_torch.obs.journal import journal, read_dir
from rafiki_tpu_torch.utils.serial import dump_flat, load_flat

torch.set_num_threads(2)

TRAIN = "synthetic://images?classes=4&n=128&w=8&h=8&c=1&seed=0"
VAL = "synthetic://images?classes=4&n=64&w=8&h=8&c=1&seed=1"
FF_KNOBS = dict(hidden_layers=1, hidden_units=32, learning_rate=1e-3, batch_size=32,
                epochs=2, seed=0)


@pytest.fixture(autouse=True)
def _clean_plane():
    uninstall()
    health.reset_stats()
    yield
    uninstall()
    health.reset_stats()


@pytest.fixture
def journaled(tmp_path):
    journal.configure(tmp_path, role="test")
    try:
        yield tmp_path
    finally:
        journal.close()


def _ff(seed=0, **over):
    m = FeedForward(device="cpu", **dict(FF_KNOBS, **over))
    m._seed = seed
    return m


def _nan_epoch(bad_step=2):
    nan = float("nan")
    return {"health_grad_norm": nan, "health_update_norm": nan, "health_param_norm": 10.0,
            "health_nonfinite": 7, "health_bad_step": bad_step, "health_bad_grad_norm": nan,
            "health_bad_update_norm": nan, "health_bad_nonfinite": 7}


def _serial_divergence():
    install(FaultPlane.from_spec("seed=3;train.nan:nan:times=1"))
    m = _ff()
    with pytest.raises(DivergenceError) as ei:
        m.train(TRAIN)
    uninstall()
    return m, ei.value


# -- snapshots ---------------------------------------------------------------


def test_capsule_switch_disables_snapshots(monkeypatch, journaled):
    monkeypatch.setenv(health.ENV_CAPSULE, "off")
    m = _ff()
    m.init_parameters(4, (8, 8, 1))
    mon = HealthMonitor("t")
    assert not mon.capsules_enabled
    assert mon.snapshot_state(m._loop.state) is None
    v = mon.observe(_nan_epoch(), epoch_seed=0, idx=None, poison=None, snapshot=None)
    assert v is not None and v["capsule"] is None  # detection stays live


def test_snapshots_need_a_journal_and_reuse_their_buffers(tmp_path):
    """No journal, no copy. With one, the pre-epoch state is copied on its
    device into the same buffers epoch after epoch, and the copy holds
    the state as it was when taken."""
    m = _ff()
    m.init_parameters(4, (8, 8, 1))
    mon = HealthMonitor("t")
    assert mon.capsules_enabled and mon.snapshot_state(m._loop.state) is None
    journal.configure(tmp_path, role="test")
    try:
        snap = mon.snapshot_state(m._loop.state)
        first = snap.member(None)
        ptrs = [p.data_ptr() for p in first["params"]]
        with torch.no_grad():
            for p in m._loop.params.parameters():
                p.add_(1.0)
        again = mon.snapshot_state(m._loop.state)
        second = again.member(None)
    finally:
        journal.close()
    assert again is snap and [p.data_ptr() for p in second["params"]] == ptrs
    for got, live in zip(second["params"], m._loop.params.parameters()):
        assert torch.equal(got, live.detach())
    assert second["step"] == 0 and second["generator"]["device"] == "cpu"


# -- serial containment and capsule replay ------------------------------------


def test_serial_divergence_fails_fast_with_capsule(journaled):
    m, err = _serial_divergence()
    v = err.verdict
    assert v["divergence"] == "nonfinite" and v["bad_step"] == 2  # n_steps // 2 of 4
    assert v["capsule"] is not None and "non-finite" in str(err)
    cap = capsule.load(v["capsule"])
    assert cap["kind"] == "nonfinite" and cap["bad_step"] == 2 and not cap["packed"]
    assert cap["idx"].shape == (3, 32)  # truncated at the bad step
    assert cap["poison"].shape == (3,) and cap["poison"][:2].tolist() == [1.0, 1.0]
    assert cap["model"]["qualname"] == "FeedForward" and cap["env"]["platform"] == "cpu"
    result = capsule.replay(v["capsule"], device="cpu")
    assert result["reproduced"], result["mismatches"]
    assert result["steps_replayed"] == 3 and result["poisoned"]
    # The loss at the bad step, taken before the poison, is finite.
    assert math.isfinite(result["comparisons"]["health_bad_loss"]["got"])
    assert result["captured_env"] == result["replay_env"]
    recs = read_dir(journaled)
    assert any(r["kind"] == "health" and r["name"] == "divergence" for r in recs)
    assert any(r["kind"] == "health" and r["name"] == "capsule" for r in recs)
    assert list(journaled.glob("flight-*.json"))
    assert health.stats()["capsules"] == 1


def test_a_replay_runs_on_the_card_unless_the_cpu_is_asked_for(journaled):
    """Without CUDA, a replay that does not ask for the CPU raises; a
    capsule stamped with another device's environment replays on the CPU
    and says so in its verdict."""
    _, err = _serial_divergence()
    path = err.verdict["capsule"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            capsule.replay(path)
    cap = capsule.load(path)
    cap["env"] = dict(cap["env"], platform="cuda", device="NVIDIA H100 80GB HBM3")
    doctored = journaled / "doctored.rcap"
    doctored.write_bytes(pickle.dumps(cap))
    result = capsule.replay(doctored, device="cpu")
    assert result["captured_env"]["device"] == "NVIDIA H100 80GB HBM3"
    assert result["replay_env"]["device"] == "cpu"
    assert result["captured_env"] != result["replay_env"]


def test_clean_run_writes_no_capsules(journaled):
    m = _ff()
    m.train(TRAIN)
    assert not list(journaled.glob("capsule-*.rcap"))
    assert health.stats()["divergences"] == 0


# -- a replay must re-run the prefix ----------------------------------------------


def _changed(path, out, what):
    """A copy of the capsule at ``path`` with one part of its pre-epoch
    state changed: every value of the first parameter, or of its Adam
    first moment, moved by 1e-3, or the dropout generator reseeded."""
    cap = capsule.load(path)
    if what == "generator":
        other = torch.Generator().manual_seed(12345).get_state()
        cap[GENERATOR_KEY] = dict(cap[GENERATOR_KEY], state=bytes(other.numpy()))
    else:
        flat = load_flat(cap["state_packed"])
        key = next(k for k in sorted(flat) if k.startswith("0/")) if what == "params" \
            else next(k for k in sorted(flat) if "/mu/" in k)
        flat[key] = flat[key] + 1e-3
        cap["state_packed"] = dump_flat(flat, cast_f32_to_bf16=False)
    out.write_bytes(pickle.dumps(cap))
    return out


@pytest.mark.parametrize("what", ["params", "moments"])
def test_a_serial_replay_from_another_state_does_not_reproduce(journaled, what):
    """The values at a poisoned step follow from the poison alone; the
    loss at the bad step follows from the prefix. A capsule whose
    pre-epoch params or moments were changed replays to another loss,
    and the verdict says so."""
    _, err = _serial_divergence()
    result = capsule.replay(_changed(err.verdict["capsule"], journaled / "changed.rcap", what),
                            device="cpu")
    assert not result["reproduced"] and result["mismatches"] == ["health_bad_loss"]


def test_a_replay_from_another_dropout_stream_does_not_reproduce(journaled):
    """With dropout on, the capsule's generator state is part of what a
    replay must restore: the capsule reproduces, and a copy with the
    generator reseeded does not."""
    install(FaultPlane.from_spec("seed=3;train.nan:nan:times=1"))
    m = Vgg(device="cpu", depth=11, width_mult=0.25, batch_size=64, epochs=1, dropout=0.3,
            learning_rate=1e-3, seed=0)
    with pytest.raises(DivergenceError) as ei:
        m.train(TRAIN)
    uninstall()
    path = ei.value.verdict["capsule"]
    assert capsule.replay(path, device="cpu")["reproduced"]
    result = capsule.replay(_changed(path, journaled / "changed.rcap", "generator"),
                            device="cpu")
    assert not result["reproduced"] and result["mismatches"] == ["health_bad_loss"]


# -- packed isolation -----------------------------------------------------------


def test_packed_capsule_replays_serially(journaled):
    """A packed member's capsule holds its state sliced to serial shape;
    the replay re-runs it through a serial program and reproduces."""
    install(FaultPlane.from_spec("seed=3;train.nan:nan:times=1:match=@m1"))
    models = [_ff(seed=s) for s in range(2)]
    TorchModel.train_packed(models, TRAIN)
    uninstall()
    assert [getattr(m, "_health_verdict", None) is None for m in models] == [True, False]
    assert health.stats()["evictions"] == 1
    [path] = glob.glob(str(journaled / "capsule-*.rcap"))
    cap = capsule.load(path)
    assert cap["packed"] is True and cap["member"] == 1 and cap["seed"] == 1
    assert cap["idx"].shape == (3, 32) and models[1]._health_verdict["capsule"] == path
    result = capsule.replay(path, device="cpu")
    assert result["reproduced"], result["mismatches"]
    assert result["member"] == 1 and result["steps_replayed"] == 3
    # The member's slice is what the replay re-ran: changed, it does not reproduce.
    changed = capsule.replay(_changed(path, journaled / "changed.rcap", "params"), device="cpu")
    assert not changed["reproduced"] and changed["mismatches"] == ["health_bad_loss"]


# -- worker containment (serial and packed) ------------------------------------


class _ScriptedAdvisor:
    def __init__(self):
        self.fed = []

    def propose(self):
        return dict(FF_KNOBS)

    def propose_batch(self, n):
        return [self.propose() for _ in range(n)]

    def feedback(self, score, knobs):
        self.fed.append(round(float(score), 6))


def _mk_worker(tmp_path, n_trials, trial_pack=1):
    from rafiki_tpu_torch.store import MetaStore, ParamsStore
    from rafiki_tpu_torch.worker.train import TrainWorker

    store = MetaStore(tmp_path / "meta.sqlite3")
    params = ParamsStore(tmp_path / "params")
    model = store.create_model("hff", "IMAGE_CLASSIFICATION", None, b"", "FeedForward")
    job = store.create_train_job("app", "IMAGE_CLASSIFICATION", None, TRAIN, VAL,
                                 {"MODEL_TRIAL_COUNT": n_trials})
    sub = store.create_sub_train_job(job["id"], model["id"])
    adv = _ScriptedAdvisor()
    worker = TrainWorker(store, params, sub["id"], FeedForward, adv, TRAIN, VAL,
                         {"MODEL_TRIAL_COUNT": n_trials}, devices=[torch.device("cpu")],
                         async_persist=False, trial_pack=trial_pack)
    return store, worker, adv, sub


def test_worker_serial_contains_divergence(tmp_path, journaled):
    install(FaultPlane.from_spec("seed=3;train.nan:nan:times=1"))
    store, worker, adv, sub = _mk_worker(tmp_path, n_trials=2)
    assert worker.run() == 2
    uninstall()
    trials = store.get_trials_of_sub_train_job(sub["id"])
    assert sorted(t["status"] for t in trials) == ["COMPLETED", "ERRORED"]
    bad = next(t for t in trials if t["status"] == "ERRORED")
    assert "diverged" in (bad["error"] or "")
    assert 0.0 in adv.fed
    assert health.stats()["contained"] == 1
    good = next(t for t in trials if t["status"] == "COMPLETED")
    assert good["score"] is not None


def test_worker_packed_contains_divergence(tmp_path, journaled):
    from rafiki_tpu_torch.model.knobs import knob_config_signature
    from rafiki_tpu_torch.worker.train import PackedTrialRunner

    install(FaultPlane.from_spec("seed=3;train.nan:nan:times=1:match=@m1"))
    store, worker, adv, sub = _mk_worker(tmp_path, n_trials=2, trial_pack=2)
    rows = []
    for _ in range(2):
        kn = adv.propose()
        t = store.create_trial(sub["id"], "FeedForward", kn,
                               shape_sig=knob_config_signature(FeedForward.get_knob_config(), kn),
                               budget_max=2)
        rows.append((t["id"], kn))
    assert PackedTrialRunner(worker, 2).run_assigned(rows, budget_max=2) == 2
    uninstall()
    trials = {t["id"]: t for t in store.get_trials_of_sub_train_job(sub["id"])}
    t0, t1 = trials[rows[0][0]], trials[rows[1][0]]
    assert t0["status"] == "COMPLETED" and t0["score"] is not None
    assert t1["status"] == "ERRORED" and "diverged" in (t1["error"] or "")
    assert 0.0 in adv.fed
    assert health.stats()["contained"] == 1 and health.stats()["evictions"] == 1
    assert PackedTrialRunner(worker, 2).run_assigned([]) == 0


# -- the CLI ---------------------------------------------------------------------


def _cli(argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = cli.main(argv)
    return rc, buf.getvalue()


def test_cli_health_curves_replay(tmp_path, journaled):
    install(FaultPlane.from_spec("seed=3;train.nan:nan:times=1"))
    store, worker, adv, sub = _mk_worker(tmp_path, n_trials=2)
    worker.run()
    uninstall()
    journal.close()
    rc, out = _cli(["--dir", str(journaled), "health"])
    assert rc == 0 and "divergences: 1" in out and "capsule" in out
    rc, out = _cli(["--dir", str(journaled), "--json", "health"])
    assert rc == 0 and '"capsules": [{' in out
    rc, out = _cli(["--dir", str(journaled), "curves"])
    assert rc == 0 and "trial " in out and "epoch" in out
    [cap] = glob.glob(str(journaled / "capsule-*.rcap"))
    rc, out = _cli(["replay", cap, "--device", "cpu"])
    assert rc == 0 and "reproduced" in out
    rc, out = _cli(["replay", cap, "--device", "cpu", "--json"])
    assert rc == 0 and '"reproduced": true' in out
    empty = tmp_path / "empty"
    empty.mkdir()
    rc, out = _cli(["--dir", str(empty), "health"])
    assert rc == 0 and "clean" in out
    assert _cli(["--dir", str(empty), "curves"])[0] == 1


def test_cli_replay_rejects_garbage(tmp_path):
    bad = tmp_path / "not-a-capsule.rcap"
    bad.write_bytes(b"\x80\x04N.")  # a pickled None
    assert _cli(["replay", str(bad), "--device", "cpu"])[0] == 2
    jax_made = tmp_path / "jax.rcap"  # the JAX package's payload: no "env"
    jax_made.write_bytes(pickle.dumps({"version": 1, "jax_version": "0.9.0", "idx": None}))
    assert _cli(["replay", str(jax_made), "--device", "cpu"])[0] == 2
    assert _cli(["replay", str(tmp_path / "absent.rcap"), "--device", "cpu"])[0] == 2


def test_cli_health_reads_a_jax_package_journal(tmp_path):
    """A journal the JAX package wrote (one divergence and its capsule)
    reads the same in the port's ``health`` and ``curves``."""
    from rafiki_tpu.obs import cli as jax_cli

    jax_journal.configure(tmp_path, role="jax")
    try:
        jax_journal.record("health", "divergence", divergence="nonfinite", member=None,
                           bad_step=2, badput_s=0.5, capsule="/x/capsule-1-0.rcap",
                           diagnosis="non-finite numerics at step 2")
        jax_journal.record("health", "capsule", path="/x/capsule-1-0.rcap",
                           divergence="nonfinite", member=None, bad_step=2)
        jax_journal.record("trial", "epoch_eval", trial_id="t1", epoch=0, score=0.5,
                           loss=1.0, acc=0.5, wall_s=1.25, packed=False)
    finally:
        jax_journal.close()
    for verb in ("health", "curves"):
        want = io.StringIO()
        with redirect_stdout(want):
            assert jax_cli.main(["--dir", str(tmp_path), verb]) == 0
        rc, got = _cli(["--dir", str(tmp_path), verb])
        assert rc == 0 and got == want.getvalue()


# -- the JAX package's keys -------------------------------------------------------


def test_capsule_and_verdict_keys_equal_the_jax_packages(tmp_path):
    """The same spec, seed and model in both packages: the capsules carry
    the same keys (``jax_version`` in the JAX package's, ``env`` and the
    generator's state in the port's), and the two replays' verdicts the
    same keys and outcome."""
    spec = "seed=3;train.nan:nan:times=1"
    jax_journal.configure(tmp_path / "jax", role="test")
    jax_install(JaxFaultPlane.from_spec(spec))
    try:
        with pytest.raises(JaxDivergenceError) as want:
            JaxFeedForward(**FF_KNOBS).train(TRAIN)
    finally:
        jax_uninstall()
        jax_journal.close()
    journal.configure(tmp_path / "port", role="test")
    try:
        _, got = _serial_divergence()
    finally:
        journal.close()
    jcap = jax_capsule.load(want.value.verdict["capsule"])
    pcap = capsule.load(got.verdict["capsule"])
    assert set(pcap) - {"env", GENERATOR_KEY} == set(jcap) - {"jax_version"}
    assert set(got.verdict) - {"epoch_seed"} == set(want.value.verdict)
    for key in ("kind", "bad_step", "member", "packed", "seed", "planned_steps", "batch_size",
                "train_uri", "epoch_seed"):
        assert pcap[key] == jcap[key], key
    assert pcap["idx"].tolist() == jcap["idx"].tolist()
    assert set(pcap["model"]) == set(jcap["model"])
    jv = jax_capsule.replay(want.value.verdict["capsule"])
    pv = capsule.replay(got.verdict["capsule"], device="cpu")
    assert set(pv) == set(jv)
    for key in ("kind", "bad_step", "member", "steps_replayed", "poisoned", "reproduced"):
        assert pv[key] == jv[key], key
    # The port compares one key more: the loss at the bad step.
    assert set(pv["comparisons"]) == set(jv["comparisons"]) | {"health_bad_loss"}
    assert os.path.basename(got.verdict["capsule"]).startswith(f"capsule-{os.getpid()}-")
