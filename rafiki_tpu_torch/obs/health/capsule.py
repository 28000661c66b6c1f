"""Divergence replay capsules: freeze the bad step, re-execute it, and
check that it reproduces bit for bit.

The port's own copy of ``rafiki_tpu/obs/health/capsule.py`` (``f32_bits``,
``write``, ``load``, ``_rebuild_model``, ``replay``). A capsule is an
atomically written pickle (``capsule-<pid>-<seq>.rcap`` in the journal
directory) that the HealthMonitor banks at a trip. It carries what a
fresh process needs to re-run the divergent epoch's prefix:

* the train state as it was BEFORE the bad epoch, as ``state_packed``:
  the checkpoint tree of ``TorchModel.dump_checkpoint`` (params, Adam's
  moments and counts, the step, the hyper scalars) at full precision,
  with the dropout generator's state under the checkpoint's own key
  (``model/base.py GENERATOR_KEY``). A pack member's state is sliced to
  serial shape: pack ≡ serial makes the serial re-run bit-identical;
* the epoch's batch-index rows and the chaos poison column, truncated
  at the first bad step (an injected fault must be re-applied for the
  replay to reproduce);
* the model's identity (import path, knobs, and the uploaded source
  when the template came from ``load_model_class``), the train dataset
  URI, the batch size, the seed and the planned steps;
* in place of the JAX package's ``jax_version``, ``env``: the card's
  name, the torch, CUDA and cuDNN versions, and the numerics switches
  in force (``cudnn.deterministic``, ``cudnn.benchmark``, both
  ``allow_tf32`` flags, ``CUBLAS_WORKSPACE_CONFIG`` when set).

The pre-epoch state is copied on its device by :class:`DeviceSnapshot`
(``HealthMonitor.snapshot_state``), into buffers reused from epoch to
epoch, only while capsules are on; it reaches the host only at a trip.

``python -m rafiki_tpu_torch.obs replay <capsule>`` applies the
capsule's switches before its first CUDA call, rebuilds the model,
restores the state through ``restore_checkpoint`` (the generator's
state before a step runs, so before ``StepRunner`` registers it with a
graph), re-runs the truncated epoch through the same ``Program.
train_epoch`` and compares the sentinel surface as uint32 views of the
float32 values (NaNs compare equal at the bit level). It runs on the
card unless ``--device cpu`` is asked for, and never falls back to the
CPU; a capsule replayed on another device or build than the one it was
banked on says so in the verdict's ``captured_env``/``replay_env``.
"""

from __future__ import annotations

import os
import pickle
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np

VERSION = 1
SUFFIX = ".rcap"

#: The sentinel keys a replay must reproduce bit for bit for every
#: capsule kind. ``bad_*`` values are taken AT the first bad step (step 0
#: for a clean or explosion epoch), so they are well defined for
#: truncated and full-epoch replays alike. At a poisoned step the
#: first four follow from the poison alone (every gradient NaN); the
#: loss at the bad step (``sentinel.at_bad_step``, the port's own key)
#: follows from the whole replayed prefix: params, moments, dropout
#: stream and batches.
_ALWAYS_KEYS = ("health_bad_step", "health_bad_nonfinite",
                "health_bad_grad_norm", "health_bad_update_norm", "health_bad_loss")
#: Compared too when the replay covers the FULL epoch (explosion
#: capsules, bad_step < 0): whole-epoch reductions match only when the
#: replayed step count matches the observed one.
_FULL_EPOCH_KEYS = ("health_grad_norm", "health_update_norm",
                    "health_param_norm", "health_nonfinite")
_INT_KEYS = ("health_bad_step", "health_bad_nonfinite", "health_nonfinite")

#: The process environment variable among the numerics switches.
_CUBLAS_ENV = "CUBLAS_WORKSPACE_CONFIG"


def f32_bits(x: float) -> int:
    """The uint32 bit pattern of ``x`` as a float32: the equality domain
    of replay verification (NaN bit patterns compare equal where NaN
    floats would not)."""
    return int(np.float32(x).view(np.uint32))


def capsule_dir() -> Optional[Path]:
    """Where capsules go: the open journal's directory; None when the
    process does not journal (or closed its journal), and then no
    capsule, and no snapshot, is taken."""
    from rafiki_tpu_torch.obs.journal import journal

    return journal.log_dir if journal.configured else None


# -- the numerics environment ------------------------------------------------


def numerics_switches() -> Dict[str, Any]:
    """The switches that choose the card's kernels and their rounding."""
    import torch

    return {"cudnn.deterministic": bool(torch.backends.cudnn.deterministic),
            "cudnn.benchmark": bool(torch.backends.cudnn.benchmark),
            "cuda.matmul.allow_tf32": bool(torch.backends.cuda.matmul.allow_tf32),
            "cudnn.allow_tf32": bool(torch.backends.cudnn.allow_tf32),
            _CUBLAS_ENV: os.environ.get(_CUBLAS_ENV)}


def apply_switches(switches: Dict[str, Any]) -> None:
    """Set exactly ``switches`` (a capsule's), before the first CUDA call:
    a switch the training process did not set is unset here too
    (``CUBLAS_WORKSPACE_CONFIG`` alone changes cuBLAS's kernel choice)."""
    import torch

    torch.backends.cudnn.deterministic = switches["cudnn.deterministic"]
    torch.backends.cudnn.benchmark = switches["cudnn.benchmark"]
    torch.backends.cuda.matmul.allow_tf32 = switches["cuda.matmul.allow_tf32"]
    torch.backends.cudnn.allow_tf32 = switches["cudnn.allow_tf32"]
    if switches[_CUBLAS_ENV] is None:
        os.environ.pop(_CUBLAS_ENV, None)
    else:
        os.environ[_CUBLAS_ENV] = str(switches[_CUBLAS_ENV])


def numerics_env(device) -> Dict[str, Any]:
    """The build and switches a step ran under on ``device``."""
    import torch

    dev = torch.device(device)
    return {"platform": dev.type,
            "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "cudnn": (torch.backends.cudnn.version()
                      if torch.backends.cudnn.is_available() else None),
            "switches": numerics_switches()}


# -- the pre-epoch snapshot --------------------------------------------------


def _generator_state(generator) -> Optional[Dict[str, Any]]:
    if generator is None:
        return None
    return {"device": generator.device.type, "state": bytes(generator.get_state().numpy())}


class DeviceSnapshot:
    """A train state copied on its own device, into buffers that later
    epochs copy into again (one allocation while the shapes stay; a
    pack that changes width reallocates). Params and Adam's moments are
    copied on the device; step counts, generator states (host-side
    seeds and offsets) and the hyper scalars are small host copies.
    :meth:`member` gives one trial's serial-shaped state out of it."""

    def __init__(self) -> None:
        self._bufs: Dict[str, List[Any]] = {}
        self._snap: Dict[str, Any] = {}

    def _copy(self, name: str, tensors: List[Any]) -> List[Any]:
        import torch

        bufs = self._bufs.get(name)
        fits = (bufs is not None and len(bufs) == len(tensors)
                and all(b.shape == t.shape and b.dtype == t.dtype and b.device == t.device
                        for b, t in zip(bufs, tensors)))
        if not fits:
            bufs = self._bufs[name] = [t.detach().clone() for t in tensors]
        elif bufs:
            torch._foreach_copy_(bufs, [t.detach() for t in tensors])
        return bufs

    def _opt(self, opt: Any) -> Any:
        from rafiki_tpu_torch.ops.optim import AdamState, ScaleByAdamState

        if opt is None:
            return None
        if isinstance(opt, AdamState):
            return AdamState(adam=self._opt(opt.adam), count=opt.count)
        if opt.mu is None:
            return ScaleByAdamState(count=opt.count, mu=None, nu=None)
        return ScaleByAdamState(count=opt.count, mu=self._copy("mu", opt.mu),
                                nu=self._copy("nu", opt.nu))

    def take(self, state: Any) -> None:
        """Copy ``state``: a serial ``(module, opt_state, step, generator,
        hyper)`` tuple or a pack's ``PackedState``."""
        from rafiki_tpu_torch.ops.train import PackedState

        if isinstance(state, PackedState):
            self._snap = {
                "packed": True, "structure": state.base,
                "params": self._copy("params", list(state.params.values())),
                "opt": self._opt(state.opt), "steps": list(state.steps),
                "generators": [_generator_state(g) for g in state.generators],
                "hyper": {k: v.clone() for k, v in state.hyper.items()}}
            return
        module, opt, step, generator, hyper = state
        self._snap = {
            "packed": False, "structure": module,
            "params": self._copy("params", list(module.parameters())),
            "opt": self._opt(opt), "step": int(step),
            "generator": _generator_state(generator),
            "hyper": {k: v.clone() for k, v in hyper.items()}}

    def member(self, j: Optional[int]) -> Dict[str, Any]:
        """One trial's pre-epoch state: ``structure`` (a module whose
        parameter names and layers the tensors map to), ``params`` (one
        tensor per parameter, in its order), ``opt``, ``step``,
        ``generator`` (its state) and ``hyper``. ``j`` is the pack slot;
        None for a serial snapshot."""
        s = self._snap
        if not s["packed"]:
            return {k: s[k] for k in ("structure", "params", "opt", "step", "generator",
                                      "hyper")}
        from rafiki_tpu_torch.ops.optim import member_opt_state

        opt = member_opt_state(s["opt"], j)
        return {"structure": s["structure"], "params": [p[j] for p in s["params"]],
                "opt": opt, "step": s["steps"][j], "generator": s["generators"][j],
                "hyper": {k: v[j].clone() for k, v in s["hyper"].items()}}


# -- writing and reading ----------------------------------------------------


def write(monitor: Any, *, member: Optional[int], kind: str,
          health: Dict[str, float], epoch_seed: Optional[int], idx: Any,
          poison: Any, state: Dict[str, Any], seq: int) -> Optional[Path]:
    """Bank one capsule; returns its path, or None (no journal directory
    or no model context). ``state`` is :meth:`DeviceSnapshot.member`'s.
    Called from the HealthMonitor's trip path, which guards it: a
    capsule that fails never fails training."""
    ctx = monitor._member_ctx(member)
    model = ctx.get("model")
    d = capsule_dir()
    if d is None or not model:
        return None
    from rafiki_tpu_torch.model.base import GENERATOR_KEY, _state_tree, _to_host
    from rafiki_tpu_torch.utils.serial import dump_flat

    bad_step = int(health.get("health_bad_step", -1))
    if idx is not None:
        idx = np.asarray(idx, np.int32)
        if bad_step >= 0:
            idx = idx[: bad_step + 1]
    if poison is not None:
        poison = np.asarray(poison, np.float32)
        if bad_step >= 0:
            poison = poison[: bad_step + 1]
    seed = int(ctx.get("seed", 0))
    tree = _state_tree((state["structure"], state["opt"], state["step"], None, state["hyper"]),
                       seed, state["params"])
    device = state["params"][0].device
    payload = {
        "version": VERSION,
        "created_ts": time.time(),
        "platform": device.type,
        "env": numerics_env(device),
        "kind": kind,
        "perf_key": monitor.key,
        "member": member,
        "packed": member is not None,
        "bad_step": bad_step,
        "observed": {k: float(v) for k, v in health.items()},
        "epoch_seed": None if epoch_seed is None else int(epoch_seed),
        "idx": idx,
        "poison": poison,
        "state_packed": dump_flat(_to_host([tree])[0], cast_f32_to_bf16=False),
        GENERATOR_KEY: state["generator"],
        "model": dict(model),
        "train_uri": ctx.get("train_uri"),
        "batch_size": ctx.get("batch_size"),
        "seed": seed,
        "planned_steps": ctx.get("planned_steps"),
    }
    d.mkdir(parents=True, exist_ok=True)
    path = d / f"capsule-{os.getpid()}-{seq}{SUFFIX}"
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "wb") as f:
        pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(tmp, path)
    from rafiki_tpu_torch.obs.journal import journal

    journal.record("health", "capsule", path=str(path), divergence=kind,
                   member=member, bad_step=bad_step)
    return path


def load(path: str | os.PathLike) -> Dict[str, Any]:
    with open(path, "rb") as f:
        cap = pickle.load(f)
    if not isinstance(cap, dict) or cap.get("version") != VERSION:
        raise ValueError(f"{path}: not a v{VERSION} rafiki health capsule")
    if "env" not in cap:
        raise ValueError(f"{path}: a capsule of the JAX package (no 'env'); "
                         "replay it with python -m rafiki_tpu.obs")
    return cap


def _rebuild_model(cap: Dict[str, Any], device):
    """Re-instantiate the diverged trial's template on ``device``: from
    the embedded uploaded source when there is one, else by importing
    the recorded module path."""
    m = cap["model"]
    if m.get("source"):
        from rafiki_tpu_torch.model.base import load_model_class

        cls = load_model_class(m["source"], m["qualname"].split(".")[0])
    else:
        import functools
        import importlib

        mod = importlib.import_module(m["module"])
        cls = functools.reduce(getattr, m["qualname"].split("."), mod)
    return cls(device=device, **(m.get("knobs") or {}))


def replay(path: str | os.PathLike, device=None) -> Dict[str, Any]:
    """Re-execute a capsule's divergent epoch prefix on ``device`` (the
    card unless the CPU is asked for) and bit-compare the sentinel
    surface. Returns a verdict document (JSON-able)."""
    cap = load(path)
    captured = cap["env"]
    # Before the first CUDA call: the training process's switches, no more.
    apply_switches(captured["switches"])
    import torch

    from rafiki_tpu_torch.model.base import GENERATOR_KEY, _portable_meta
    from rafiki_tpu_torch.ops.train import get_device_dataset
    from rafiki_tpu_torch.utils.backend import resolve_device

    idx = cap.get("idx")
    if idx is None:
        raise ValueError(f"{path}: capsule carries no batch indices (the trial ran "
                         "outside the device-resident path); replay is not supported")
    dev = resolve_device(device)
    model = _rebuild_model(cap, dev)
    ds = model._prepared_dataset(cap["train_uri"])
    model._seed = int(cap.get("seed", 0))
    model.restore_checkpoint(pickle.dumps({
        "arch": model._dataset_arch(ds),
        "state_packed": cap["state_packed"],
        "epoch": 0,
        "planned_steps": cap.get("planned_steps"),
        "dataset_meta": _portable_meta(dict(ds.meta)),
        GENERATOR_KEY: cap.get(GENERATOR_KEY),
    }))
    loop = model._loop
    X, Y = get_device_dataset(ds, dev)
    idx = np.asarray(idx, np.int64)
    poison = cap.get("poison")
    if poison is not None:
        poison = np.asarray(poison, np.float32)
    _, metrics = loop.program.train_epoch(loop.state, X, Y, torch.from_numpy(idx).to(dev),
                                          poison)
    got = {k: float(v) for k, v in metrics.items() if k.startswith("health_")}

    expected = cap["observed"]
    keys = list(_ALWAYS_KEYS)
    if cap["bad_step"] < 0:
        keys += list(_FULL_EPOCH_KEYS)
    mismatches = []
    comparisons = {}
    for k in keys:
        if k in _INT_KEYS:
            e, g = int(expected[k]), int(got[k])
            ok = e == g
            comparisons[k] = {"expected": e, "got": g, "match": ok}
        else:
            e, g = f32_bits(expected[k]), f32_bits(got[k])
            ok = e == g
            comparisons[k] = {"expected": float(np.float32(expected[k])),
                              "got": float(np.float32(got[k])),
                              "expected_bits": f"{e:08x}",
                              "got_bits": f"{g:08x}", "match": ok}
        if not ok:
            mismatches.append(k)
    return {
        "capsule": str(path),
        "kind": cap["kind"],
        "bad_step": cap["bad_step"],
        "member": cap.get("member"),
        "steps_replayed": int(idx.shape[0]),
        "poisoned": poison is not None,
        # A NOT-reproduced verdict across differing builds or devices is
        # expected, not alarming: the two say where the capsule was
        # banked and where it ran.
        "captured_env": captured,
        "replay_env": numerics_env(dev),
        "comparisons": comparisons,
        "reproduced": not mismatches,
        "mismatches": mismatches,
    }
