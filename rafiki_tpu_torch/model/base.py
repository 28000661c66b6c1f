"""The model contract, and the PyTorch base class of the port.

``BaseModel`` is the port's own copy of the reference-compatible
surface in ``rafiki_tpu/model/base.py`` (``get_knob_config / train /
evaluate / predict / dump_parameters / load_parameters / destroy``).

``TorchModel`` is the counterpart of ``JaxModel``: a subclass returns
an ``nn.Module`` from ``build_module(num_classes, input_shape)`` and
gets ``train`` / ``evaluate`` (``ops/train.py TrainLoop``),
``predict`` / ``predict_proba``, and params blobs that the JAX package
reads too (same pickle payload ``{"arch", "packed", "dataset_meta"}``,
same RTPK1 leaves and flax key names; see ``utils/serial.py`` and
``convert.py``).

``load_model_class`` loads an uploaded template (``.py`` source bytes)
as the JAX package's does, and requires a subclass of the port's
``BaseModel``.

Trial packing (docs/trial_packing.md): ``packable``, ``packing_key``,
``train_packed`` and ``evaluate_packed`` train and score k same-key
trials as one stacked program (``ops/train.py PackedTrainLoop``), each
member ending where a serial ``train()`` of its trial ends.

Mid-trial checkpoints: ``set_checkpoint_sink``, ``dump_checkpoint`` and
``restore_checkpoint`` write and read the JAX package's payload (``arch``,
``state_packed``, ``epoch``, ``planned_steps``, ``dataset_meta``; the
RTPK1 tree is described above ``GENERATOR_KEY``), so a checkpoint of either
package resumes in the other; ``train()`` starts at the restored epoch,
and ``train_packed``'s ``checkpoint_sink`` writes one serial-format
checkpoint per member. The health plane's replay capsules
(``obs/health/capsule.py``) carry that same checkpoint tree, the
template's identity (``_health_model_identity``, with the uploaded
source) and rebuild the trial through ``_dataset_arch`` and
``restore_checkpoint``. ``make_optimizer`` is the legacy complete-
optimizer hook (such a template packs too, its members differing only by
seed); ``parse_model_install_command`` checks a template's
dependencies.

Within-trial data parallelism: ``set_mesh`` (the scheduler's hook, as
in the JAX package) makes the trial one rank of a dp mesh, or, under an
in-process mesh, the whole trial over its replicas (``parallel/mesh.py``);
``train`` then runs ``TrainLoop(mesh=...)``. Under an in-process mesh the
loop's state is replica 0's, on the mesh's first device, so ``evaluate``,
``predict_proba``, ``dump_parameters``, checkpoints and capsules read
replica 0, and a restored checkpoint reaches every replica at the next
epoch (``ops/train.py``). A pack takes no mesh.

The learning-curve early kill: a serial trial ends from its log sink
(``worker/train.py EarlyKilled``, raised out of ``logger.log`` between
epochs, when no capture is open and no card lock is held), and
``train_packed``'s ``kill_predicate`` evicts a pack member with reason
``"killed"``.
"""

from __future__ import annotations

import abc
import functools
import importlib.util
import inspect
import math
import os
import pickle
import sys
import types
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from rafiki_tpu_torch.convert import flax_to_state_dict, state_dict_to_flax
from rafiki_tpu_torch.model.dataset import Dataset, dataset_utils
from rafiki_tpu_torch.model.knobs import KnobConfig, Knobs, validate_knobs
from rafiki_tpu_torch.model.log import logger
from rafiki_tpu_torch.ops import train as _ops
from rafiki_tpu_torch.ops.graphs import device_lock
from rafiki_tpu_torch.ops.layers import GroupNorm
from rafiki_tpu_torch.ops.optim import Adam, AdamState, ScaleByAdamState, adam, linear_schedule, scale_by_adam
from rafiki_tpu_torch.utils.backend import DeviceLike, resolve_device
from rafiki_tpu_torch.utils.serial import dump_flat, load_flat

# flax's lecun_normal draws from a normal truncated at two standard
# deviations, rescaled by this factor so the variance is 1/fan_in.
_TRUNC_STD = 0.87962566103423978


class BaseModel(abc.ABC):
    """Abstract model template (reference-compatible surface).

    Lifecycle of one trial:
      model = ModelClass(**knobs)      # reference: init(knobs)
      model.train(train_uri)
      score = model.evaluate(val_uri)
      blob = model.dump_parameters()
      ... later, for serving ...
      model = ModelClass(**knobs); model.load_parameters(blob)
      out = model.predict(queries)
    """

    def __init__(self, **knobs: Any):
        self.knobs: Knobs = validate_knobs(self.get_knob_config(), knobs)

    # -- static declarations -------------------------------------------------

    @staticmethod
    @abc.abstractmethod
    def get_knob_config() -> KnobConfig:
        """Declare the hyperparameter space."""

    # -- trial hooks ---------------------------------------------------------

    @abc.abstractmethod
    def train(self, dataset_uri: str) -> None: ...

    @abc.abstractmethod
    def evaluate(self, dataset_uri: str) -> float: ...

    @abc.abstractmethod
    def predict(self, queries: List[Any]) -> List[Any]: ...

    def dump_parameters(self) -> bytes:
        raise NotImplementedError

    def load_parameters(self, blob: bytes) -> None:
        raise NotImplementedError

    def destroy(self) -> None:
        """Release device/host resources (optional)."""

    # -- conveniences --------------------------------------------------------

    @classmethod
    def knob_config(cls) -> KnobConfig:
        return cls.get_knob_config()


class TorchModel(BaseModel):
    """PyTorch base: a subclass provides an ``nn.Module`` + knob config.

    The module's ``forward(x, train=False)`` returns logits; a module
    whose ``forward`` also takes ``dropout_rate`` (and ``generator``)
    gets the ``dropout`` knob as a float32 scalar, so a dropout sweep
    runs one code path. ``device`` is where the trial runs: the CUDA
    card by default, ``"cpu"`` only on request; without CUDA and without
    that request the constructor raises.
    """

    def __init__(self, *, device: DeviceLike = None, **knobs: Any):
        super().__init__(**knobs)
        self.device = resolve_device(device)
        self._loop: Optional[_ops.TrainLoop] = None  # built at train/init/load
        self._arch = None
        self._seed = int(self.knobs.get("seed", 0))
        self._dataset_meta: Dict[str, Any] = {}
        self._ckpt_sink = None  # set by the worker for mid-trial checkpoints
        self._start_epoch = 0  # > 0 after restore_checkpoint
        self._mesh = None  # a dp mesh, injected by the worker (set_mesh)

    @property
    def _module(self) -> Optional[nn.Module]:
        """The trial's module (its params), or None before train/load."""
        return None if self._loop is None else self._loop.params

    # -- knob conventions ----------------------------------------------------

    @property
    def batch_size(self) -> int:
        return int(self.knobs.get("batch_size", 64))

    @property
    def epochs(self) -> int:
        return int(self.knobs.get("epochs", 1))

    @property
    def learning_rate(self) -> float:
        return float(self.knobs.get("learning_rate", 1e-3))

    # -- subclass surface ----------------------------------------------------

    @abc.abstractmethod
    def build_module(self, num_classes: int, input_shape: tuple) -> nn.Module:
        """Return an nn.Module mapping a float32 batch of
        ``(B,) + input_shape`` queries to logits."""

    def make_base_optimizer(self):
        """Lr-free optimizer core: the train step applies
        ``-effective_lr(hyper, step)`` itself."""
        return scale_by_adam()

    def _warmup_steps(self) -> int:
        """Linear warmup over 10% of the planned steps, at most 100 (the
        JAX package's rule: deep GroupNorm nets in bf16 collapse early
        at high learning rates without it)."""
        planned = getattr(self, "_planned_steps", None) or 1000
        return int(self.knobs.get("warmup_steps", min(100, max(1, planned // 10))))

    def make_optimizer(self):
        """Legacy override hook: return a complete optimizer (the lr baked
        in; ``ops/optim.py adam``). A template that overrides it opts out
        of the per-trial lr path: its step applies the optimizer's
        updates as they are, every knob but the seed (and the planned
        steps) keys its program, so its trials pack only with trials that
        differ from them by seed. Prefer ``make_base_optimizer`` and
        the lr knob. The default is optax's ``adam(linear_schedule(0,
        lr, warmup))``."""
        return adam(linear_schedule(0.0, self.learning_rate, self._warmup_steps()))

    def preprocess(self, x: np.ndarray) -> np.ndarray:
        """Optional input transform. MUST NOT modify ``x`` in place;
        return a new array."""
        return x

    def loss(self, batch, generator, apply_fn):
        logits = apply_fn(batch, train=True, generator=generator)
        loss, acc = _ops.cross_entropy_loss(logits, batch["y"])
        return loss, {"acc": acc}

    def should_stop_early(self, epoch: int, metrics: Dict[str, float]) -> bool:
        """Per-epoch early-stop hook: return True to end training after
        ``epoch`` (metrics are that epoch's train metrics)."""
        return False

    def _input_dtype(self):
        return np.float32

    # -- internal wiring -----------------------------------------------------

    def set_mesh(self, mesh) -> None:
        """Train this trial as one rank of a dp mesh
        (``parallel/mesh.py data_parallel_mesh``) on the mesh's device, or
        over an in-process mesh's replicas, replica 0 on the mesh's first
        device; None trains on one device. Set before ``train``."""
        self._mesh = mesh

    def _dynamic_hyper(self, takes_dropout: bool) -> Dict[str, float]:
        """The per-trial float32 scalars the train step reads."""
        hyper = {"lr": float(self.learning_rate),
                 "warmup": float(self._warmup_steps())}
        if takes_dropout and "dropout" in self.knobs:
            hyper["dropout"] = float(self.knobs["dropout"])
        return hyper

    def _program_key(self, num_classes: int, input_shape: tuple, takes_dropout: bool,
                     custom_opt: bool):
        """What reaches the step's computation, apart from the knobs that
        reach it only through the hyper dict or not at all
        (``ops/train.py DYNAMIC_KNOBS``; ``dropout`` only when the module
        takes it as a rate): the template, the arch and the baked knobs.
        A custom ``make_optimizer`` may bake any knob and the planned
        step count, so only the seed is left out and the planned steps
        are keyed in. The process-wide program cache (``ops/train.py
        get_program``) and trial packing key on it, as the JAX package's
        do."""
        if custom_opt:
            dyn = {"seed"}
            extra = (getattr(self, "_planned_steps", None),)
        else:
            dyn = set(_ops.DYNAMIC_KNOBS) if takes_dropout else set(_ops.DYNAMIC_KNOBS) - {"dropout"}
            extra = ()
        baked = tuple(sorted((k, repr(v)) for k, v in self.knobs.items() if k not in dyn))
        return (type(self).__module__, type(self).__qualname__, num_classes,
                tuple(input_shape), baked, custom_opt) + extra

    def _health_model_identity(self) -> Dict[str, Any]:
        """What a replay capsule needs to re-create this template in a
        fresh process: a template loaded from uploaded source carries the
        bytes (``load_model_class`` stamps ``__rafiki_source__`` on its
        scratch module)."""
        mod = sys.modules.get(type(self).__module__)
        return {"module": type(self).__module__, "qualname": type(self).__qualname__,
                "source": getattr(mod, "__rafiki_source__", None),
                "knobs": dict(self.knobs)}

    def _dataset_arch(self, ds: Dataset) -> tuple:
        """``(num_classes, input_shape)`` of a dataset: what a module is
        built for."""
        return ds.classes, tuple(ds.x.shape[1:])

    def _loop_fns(self, num_classes: int, input_shape: tuple) -> Dict[str, Any]:
        """Everything a TrainLoop or PackedTrainLoop needs: the module,
        the closures, the optimizer, this trial's hyper dict and its
        program key."""
        module = self.build_module(num_classes, input_shape)
        takes_dropout = "dropout_rate" in inspect.signature(type(module).forward).parameters

        def apply_train(module, batch, train=False, generator=None, hyper=None):
            kwargs = {}
            if takes_dropout:
                kwargs["generator"] = generator
                if hyper is not None and "dropout" in hyper:
                    kwargs["dropout_rate"] = hyper["dropout"]
            return module(batch["x"], train=train, **kwargs)

        def apply_eval(module, batch):
            return apply_train(module, batch, train=False)

        def init_fn(generator):
            _lecun_init(module, generator)
            return module

        def loss_fn(module, batch, generator, hyper):
            return self.loss(batch, generator,
                             functools.partial(apply_train, module, hyper=hyper))

        custom_opt = type(self).make_optimizer is not TorchModel.make_optimizer
        hyper = self._dynamic_hyper(takes_dropout)
        if custom_opt:
            optimizer = self.make_optimizer()
            hyper.pop("lr", None)  # the lr lives inside the custom optimizer
            hyper.pop("warmup", None)
        else:
            optimizer = self.make_base_optimizer()
        return {
            "module": module,
            "init_fn": init_fn,
            "apply_eval": apply_eval,
            "loss_fn": loss_fn,
            "optimizer": optimizer,
            "hyper": hyper,
            "program_key": self._program_key(num_classes, input_shape, takes_dropout, custom_opt),
        }

    def _build_loop(self, num_classes: int, input_shape: tuple,
                    fill: Optional[Callable[[nn.Module], None]] = None) -> None:
        """A fresh TrainLoop for this trial. Its params come from the
        loop's seeded init, or from ``fill(module)`` when given."""
        fns = self._loop_fns(num_classes, tuple(input_shape))
        init_fn = fns["init_fn"]
        if fill is not None:
            def init_fn(_generator, module=fns["module"]):
                fill(module)
                return module
        self._loop = _ops.TrainLoop(
            init_fn, fns["apply_eval"], fns["loss_fn"], fns["optimizer"],
            seed=self._seed, hyper=fns["hyper"], program_key=fns["program_key"],
            device=self.device, mesh=self._mesh)
        self._loop.params.eval()
        self._arch = (num_classes, tuple(input_shape))

    def _prepared_dataset(self, dataset_uri: str) -> Dataset:
        """Load + preprocess. With the identity preprocess the cached
        Dataset object is used as it is, so its device copy is shared
        across trials; a custom preprocess gets a fresh wrapper."""
        ds = dataset_utils.load(dataset_uri)
        x = self.preprocess(ds.x)
        if x is ds.x:
            return ds
        return Dataset(x, ds.y, ds.classes, ds.mask, ds.meta)

    def _check_label_space(self, ds: Dataset) -> None:
        """Fail loudly when an eval dataset's label meaning diverges from
        the train dataset's (same class count, other tag set)."""
        train_tags = self._dataset_meta.get("tag_map")
        eval_tags = ds.meta.get("tag_map")
        if train_tags and eval_tags and train_tags != eval_tags:
            raise ValueError(
                f"Eval dataset tag map {eval_tags} != train tag map "
                f"{train_tags}; the datasets label different tag sets")

    # -- trial hooks ---------------------------------------------------------

    def train(self, dataset_uri: str) -> None:
        ds = self._prepared_dataset(dataset_uri)
        self._dataset_meta = dict(ds.meta)
        num_classes, input_shape = self._dataset_arch(ds)
        self._planned_steps = self.epochs * max(1, ds.size // self.batch_size)
        if self._loop is None:
            self._build_loop(num_classes, input_shape)
        elif self._arch != (num_classes, input_shape):
            raise ValueError(
                f"Dataset architecture {(num_classes, input_shape)} does not match "
                f"the loaded model {self._arch}; use a fresh model instance")
        self._loop.health.set_context(
            model=self._health_model_identity(), train_uri=dataset_uri, batch_size=self.batch_size, seed=self._seed,
            planned_steps=self._planned_steps)
        logger.define_plot("Training", ["loss", "acc"], x_axis="epoch")
        for epoch in range(self._start_epoch, self.epochs):
            metrics = self._loop.run_epoch(ds, self.batch_size, epoch_seed=self._seed + epoch)
            logger.log(epoch=epoch, **metrics)
            self._epochs_done = epoch
            if self._ckpt_sink is not None:
                # The sink decides whether to take this epoch's snapshot
                # (a device-to-host copy of the whole train state).
                self._ckpt_sink(epoch, self.dump_checkpoint)
            if self.should_stop_early(epoch, metrics):
                break

    def evaluate(self, dataset_uri: str) -> float:
        if self._loop is None:
            raise RuntimeError("Model has no parameters: call train() or load_parameters() first")
        ds = self._prepared_dataset(dataset_uri)
        self._check_label_space(ds)
        return float(self._loop.evaluate(ds, self.batch_size))

    # -- trial packing (docs/trial_packing.md) -------------------------------

    @classmethod
    def packable(cls) -> bool:
        """Whether instances may join a trial pack. A pack shares one
        device-resident dataset, so a template with its own
        ``preprocess`` (which may depend on per-trial knobs) may not. A
        template with its own ``make_optimizer`` may: its program key
        bakes every knob but the seed, so its pack's members differ only
        by seed, and each applies its complete optimizer's updates."""
        return cls.preprocess is TorchModel.preprocess

    def packing_key(self, ds: Dataset):
        """Two models train in one pack iff their keys are equal: the same
        program (template, arch, baked knobs), the same step geometry
        (batch size, epochs) and the same hyper key set. Like ``train``,
        it adopts ``ds``'s planned steps and meta (a text template sizes
        its embedding from the meta's ``vocab``), so the module a pack
        is built from is the one a serial trial would build. (The JAX
        package's ``train_packed`` builds the pack's module before the
        members read the meta, so its packed Transformer embeds a
        vocabulary of 2 and trains to NaN.)"""
        num_classes, input_shape = self._dataset_arch(ds)
        self._dataset_meta = dict(ds.meta)
        self._planned_steps = self.epochs * max(1, ds.size // self.batch_size)
        fns = self._loop_fns(num_classes, input_shape)
        return (fns["program_key"], self.batch_size, self.epochs, tuple(sorted(fns["hyper"])))

    @classmethod
    def train_packed(cls, models: List["TorchModel"], dataset_uri: str, on_epoch=None,
                     checkpoint_sink=None, backfill=None, on_evict=None,
                     kill_predicate=None) -> List[List[Dict[str, float]]]:
        """Train k model instances as one stacked program on their device.

        All models share a packing key (the caller buckets) and a device.
        Model i ends with the params, dropout stream and shuffle order a
        serial ``train()`` of it would reach. Returns the per-model epoch
        histories (``{"loss", "acc", ..., "epoch"}`` dicts), which the
        caller writes to each trial's log; ``on_epoch(round)`` fires after
        each packed epoch.

        Elastic membership: a member whose epochs are done
        (``"finished"``), whose ``should_stop_early`` fires
        (``"early_stop"``) or whose numerics diverge (``"diverged"``; the
        verdict rides on ``model._health_verdict``) while pack-mates go
        on is evicted into a detached serial ``TrainLoop`` and
        ``on_evict(model_index, epoch, reason)`` fires (not for
        ``"finished"``). ``backfill(n)`` may then return freshly made
        models of the same key; they are appended to ``models`` and to
        the histories and admitted at their own epoch 0. When every live
        member leaves in one round the pack ends, and its members keep
        live slices of it, which :meth:`evaluate_packed` scores in one
        shared pass.

        ``checkpoint_sink(round, make_blobs)``, when given, fires after
        each round, before ``on_epoch``; ``make_blobs()`` returns one
        serial-format checkpoint blob per current member as ``[(model
        index, epoch, blob), ...]``, each stamped with that member's own
        epoch counter and sliced out of the live pack (the pack itself
        is never serialized), so a killed pack's members resume serially
        through :meth:`restore_checkpoint`. A member restored from a
        checkpoint (``_start_epoch > 0``) is refused: it resumes serially.

        ``kill_predicate(model_index, epoch, metrics)``, when given, is
        consulted at each member's epoch boundary after the divergence,
        budget and early-stop checks decline (``metrics`` are the epoch's
        host floats, already synced); True evicts the member with reason
        ``"killed"``, into a detached serial loop like an early stop, and
        ``on_evict`` fires: the learning-curve early kill
        (docs/early_kill.md). The pack's program shrinks to the members
        left, each keeping its own state, so a survivor ends bit-equal to
        its serial trial. The caller owns the bookkeeping (the worker's
        ``on_evict`` marks the trial errored and sends the advisor its
        consolation feedback); None consults nothing.
        """
        from rafiki_tpu_torch.obs.health import detector as _detector

        if not models:
            return []
        if any(m._mesh is not None for m in models):
            raise ValueError("packed trials are single-device; mesh is set")
        if any(m._start_epoch > 0 for m in models):
            raise ValueError("packed trials cannot resume from checkpoint")
        lead = models[0]
        ds = lead._prepared_dataset(dataset_uri)
        key = repr(lead.packing_key(ds))
        if any(repr(m.packing_key(ds)) != key for m in models[1:]):
            raise ValueError("train_packed models do not share a packing key; "
                             "bucket with packing_key() first")
        if len({m.device for m in models}) != 1:
            raise ValueError("train_packed models are on different devices")
        if ds.mask is not None:
            raise ValueError("packed training does not support masked datasets")
        num_classes, input_shape = lead._dataset_arch(ds)
        epochs, batch_size = lead.epochs, lead.batch_size
        arch = (num_classes, input_shape)
        planned = epochs * max(1, ds.size // batch_size)

        # One set of closures (the lead's: equal keys make them
        # interchangeable) and k hyper dicts and seeds.
        fns = lead._loop_fns(num_classes, input_shape)
        hypers = {}
        for i, m in enumerate(models):
            m._planned_steps = planned
            hypers[i] = m._loop_fns(num_classes, input_shape)["hyper"]
        packed = _ops.PackedTrainLoop(
            fns["init_fn"], fns["apply_eval"], fns["loss_fn"], fns["optimizer"],
            seeds=[m._seed for m in models], hypers=[hypers[i] for i in range(len(models))],
            program_key=fns["program_key"], packing_key=key, device=lead.device)

        def install_detached(mi: int, state, epoch: int) -> None:
            """An evicted member carries on in an ordinary serial loop."""
            m = models[mi]
            m._loop = _ops.TrainLoop(
                fns["init_fn"], fns["apply_eval"], fns["loss_fn"], fns["optimizer"],
                seed=m._seed, hyper=hypers[mi], program_key=fns["program_key"],
                initial_state=state, device=m.device)
            m._arch = arch
            m._epochs_done = epoch

        histories: List[List[Dict[str, float]]] = [[] for _ in models]
        slots = list(range(len(models)))  # slot j <-> pack member j
        epochs_done = {mi: 0 for mi in slots}  # epochs completed so far
        packed.health.set_context(
            model=lead._health_model_identity(), train_uri=dataset_uri,
            batch_size=batch_size, planned_steps=planned,
            member_info=lambda j: {"model": models[slots[j]]._health_model_identity(),
                                   "seed": models[slots[j]]._seed})
        portable = _portable_meta(dict(ds.meta))
        rnd = 0
        while slots:
            # Serial parity: a member's shuffle seed is its seed plus its
            # own epoch index; a backfilled member counts from 0.
            mts = packed.run_epoch(ds, batch_size,
                                   [models[mi]._seed + epochs_done[mi] for mi in slots])
            for j, mi in enumerate(slots):
                histories[mi].append(dict(mts[j], epoch=epochs_done[mi]))
            if checkpoint_sink is not None:
                ents = [(mi, epochs_done[mi], models[mi]._seed) for mi in slots]
                checkpoint_sink(rnd, lambda e=ents: cls._packed_checkpoint_blobs(
                    packed, arch, e, planned, portable))
            if on_epoch is not None:
                on_epoch(rnd)
            rnd += 1

            verdicts = packed.last_verdicts
            leavers = []  # (slot, model index, epoch just run, reason)
            for j, mi in enumerate(slots):
                e = epochs_done[mi]
                verdict = verdicts[j] if j < len(verdicts) else None
                if verdict is not None:
                    models[mi]._health_verdict = verdict
                    leavers.append((j, mi, e, "diverged"))
                elif e + 1 >= epochs:
                    leavers.append((j, mi, e, "finished"))
                elif models[mi].should_stop_early(e, mts[j]):
                    leavers.append((j, mi, e, "early_stop"))
                elif kill_predicate is not None and kill_predicate(mi, e, mts[j]):
                    leavers.append((j, mi, e, "killed"))
            for mi in slots:
                epochs_done[mi] += 1

            if len(leavers) == len(slots):
                # The whole pack ends together: live slices, one eval pass.
                for j, mi, e, reason in leavers:
                    m = models[mi]
                    m._loop = packed.slice(j)
                    m._arch = arch
                    m._epochs_done = e
                    if reason == "diverged":
                        _detector.note_eviction()
                    if on_evict is not None and reason != "finished":
                        on_evict(mi, e, reason)
                break

            # Members done before their pack-mates leave, highest slot
            # first so the lower slots keep their indices.
            for j, mi, e, reason in sorted(leavers, reverse=True):
                install_detached(mi, packed.evict(j), e)
                slots.pop(j)
                if reason == "diverged":
                    _detector.note_eviction()
                if on_evict is not None:
                    on_evict(mi, e, reason)

            if leavers and backfill is not None:
                for m2 in (backfill(len(leavers)) or []):
                    if repr(m2.packing_key(ds)) != key:
                        raise ValueError("backfill model's packing_key differs from the "
                                         "live pack's; the caller must bucket first")
                    if m2.device != lead.device:
                        raise ValueError("backfill model is on another device than the pack")
                    m2._planned_steps = planned
                    mi2 = len(models)
                    hypers[mi2] = m2._loop_fns(num_classes, input_shape)["hyper"]
                    models.append(m2)
                    histories.append([])
                    packed.admit(m2._seed, hypers[mi2])
                    slots.append(mi2)
                    epochs_done[mi2] = 0
        return histories

    @staticmethod
    def _packed_checkpoint_blobs(packed: _ops.PackedTrainLoop, arch, entries, planned_steps,
                                 dataset_meta) -> List[tuple]:
        """Serial-format checkpoint blobs out of a live pack, one per
        current member. ``entries`` is ``[(model index, epoch, seed),
        ...]`` in slot order; returns ``[(model index, epoch, blob),
        ...]``. Each member's state comes from ``trial_state(i)``, and
        every member's device-to-host copies start before any blob is
        assembled, so the k transfers overlap. The payload is
        :meth:`dump_checkpoint`'s: :meth:`restore_checkpoint` cannot
        tell a pack-sliced snapshot from a serial one."""
        trees = []
        for i, (_, _, seed) in enumerate(entries):
            state = packed.trial_state(i)
            trees.append((_state_tree(state, seed), _generator_state(state[3])))
        hosts = _to_host([t for t, _ in trees])
        return [(mi, epoch, pickle.dumps({
            "arch": arch,
            "state_packed": dump_flat(host, cast_f32_to_bf16=False),
            "epoch": epoch,
            "planned_steps": planned_steps,
            "dataset_meta": dataset_meta,
            GENERATOR_KEY: gen,
        })) for (mi, epoch, _), host, (_, gen) in zip(entries, hosts, trees)]

    @classmethod
    def evaluate_packed(cls, models: List["TorchModel"], dataset_uri: str) -> List[float]:
        """Score models straight out of one ``train_packed`` in one shared
        eval pass; any other mix is scored model by model."""
        if not models:
            return []
        loops = [m._loop for m in models]
        if not all(isinstance(lp, _ops.PackedSliceLoop) for lp in loops) or \
                len({id(lp.packed) for lp in loops}) != 1:
            return [m.evaluate(dataset_uri) for m in models]
        ds = models[0]._prepared_dataset(dataset_uri)
        for m in models:
            m._check_label_space(ds)
        scores = loops[0].packed.evaluate(ds, models[0].batch_size)
        return [float(scores[lp.index]) for lp in loops]

    # -- params --------------------------------------------------------------

    def init_parameters(self, num_classes: int, input_shape: tuple,
                        generator: Optional[torch.Generator] = None) -> None:
        """Seeded random weights, as ``train`` starts from: conv and
        dense kernels from flax's lecun_normal distribution, norm scales
        1, biases 0. Drawn on the CPU from ``generator`` (default: the
        loop's own, seeded with the ``seed`` knob), so the weights are
        the same whatever the device."""
        fill = None if generator is None else (lambda m: _lecun_init(m, generator))
        self._build_loop(num_classes, input_shape, fill)

    def dump_parameters(self) -> bytes:
        """The JAX package's serving blob: float32 leaves stored as
        bfloat16 unless ``RAFIKI_TPU_SERVING_PARAMS_DTYPE=float32``."""
        if self._loop is None:
            raise RuntimeError("No parameters to dump: model not trained/loaded")
        cast = os.environ.get("RAFIKI_TPU_SERVING_PARAMS_DTYPE", "bfloat16") == "bfloat16"
        payload = {
            "arch": self._arch,
            "packed": dump_flat(state_dict_to_flax(self._module), cast_f32_to_bf16=cast),
            "dataset_meta": _portable_meta(self._dataset_meta),
        }
        return pickle.dumps(payload)

    def load_parameters(self, blob: bytes) -> None:
        payload = pickle.loads(blob)
        if "packed" not in payload:
            raise ValueError(
                "params blob is in the legacy flax-msgpack format, which "
                "rafiki_tpu_torch cannot read; re-dump it with rafiki_tpu "
                "(RTPK1 'packed' payload)")
        num_classes, input_shape = payload["arch"]
        self._dataset_meta = payload.get("dataset_meta", {})
        flat = load_flat(payload["packed"])
        self._build_loop(num_classes, input_shape,
                         lambda m: m.load_state_dict(flax_to_state_dict(flat, m)))

    # -- serving -------------------------------------------------------------

    def predict(self, queries: List[Any]) -> List[List[float]]:
        return self.predict_proba(np.asarray(queries, dtype=self._input_dtype())).tolist()

    def predict_proba(self, x: np.ndarray) -> np.ndarray:
        """Array-in/array-out fast path used by the ensemble predictor."""
        if self._loop is None:
            raise RuntimeError("Model has no parameters: call train() or load_parameters() first")
        x = self.preprocess(np.asarray(x, self._input_dtype()))
        return self._loop.predict_proba(x, self.batch_size)

    def destroy(self) -> None:
        self._loop = None

    # -- mid-trial checkpoints -----------------------------------------------

    def set_checkpoint_sink(self, sink) -> None:
        """Install a per-epoch checkpoint hook: ``sink(epoch, make_blob)``,
        where ``make_blob()`` returns the whole train state's snapshot.
        The train worker wires it to the params store, so a trial
        outlives its worker."""
        self._ckpt_sink = sink

    def dump_checkpoint(self) -> bytes:
        """The whole train state, to resume from: params, Adam's moments
        and counts, the step, the hyper scalars and the dropout
        generator (``dump_parameters`` holds the params alone, for
        serving). Full precision, in the JAX package's payload and RTPK1
        tree (see ``GENERATOR_KEY``), so either package restores it."""
        if self._loop is None:
            raise RuntimeError("No state to checkpoint: model not trained")
        state = self._loop.state
        payload = {
            "arch": self._arch,
            "state_packed": dump_flat(_to_host([_state_tree(state, self._seed)])[0],
                                      cast_f32_to_bf16=False),
            "epoch": getattr(self, "_epochs_done", 0),
            "planned_steps": getattr(self, "_planned_steps", None),
            "dataset_meta": _portable_meta(self._dataset_meta),
            GENERATOR_KEY: _generator_state(state[3]),
        }
        return pickle.dumps(payload)

    def restore_checkpoint(self, blob: bytes) -> int:
        """Restore a ``dump_checkpoint`` snapshot of either package;
        returns the epoch to resume from, which ``train()`` starts at. A
        state that does not fit this template's layout keeps its params
        and step, with a fresh optimizer, as the JAX package's salvage
        does. The dropout generator is the blob's own where it was
        written on this device type, else seeded from the trial's seed
        as a fresh trial's is. The loop's state is replaced between
        epochs, and a captured step lives within one epoch
        (``ops/graphs.py``), so no graph reads the tensors it replaces."""
        payload = pickle.loads(blob)
        if "state_packed" not in payload:
            raise ValueError("checkpoint is in the legacy flax-msgpack format, which "
                             "rafiki_tpu_torch cannot read")
        num_classes, input_shape = payload["arch"]
        self._dataset_meta = payload.get("dataset_meta", {})
        if payload.get("planned_steps"):
            self._planned_steps = payload["planned_steps"]
        self._build_loop(num_classes, tuple(input_shape))
        flat = load_flat(payload["state_packed"])
        module, _, _, generator, hyper = self._loop.state
        optimizer = self._loop.program.optimizer
        try:
            module.load_state_dict(flax_to_state_dict(_subtree(flat, "0"), module))
        except (KeyError, ValueError) as e:
            raise ValueError(f"checkpoint params do not fit the template: {e}") from e
        try:
            opt = _opt_from_tree(_subtree(flat, "1"), module, optimizer)
            hyper = {k: v.float() for k, v in _subtree(flat, "4").items()}
            if sorted(hyper) != sorted(self._loop.hyper):
                raise KeyError(f"hyper keys {sorted(hyper)} != {sorted(self._loop.hyper)}")
        except (KeyError, ValueError, TypeError):
            opt = None  # salvage: the params and step, a fresh optimizer
            hyper = self._loop.hyper
        step = int(flat["2"]) if "2" in flat else 0
        gen = payload.get(GENERATOR_KEY)
        if gen is not None and gen["device"] == generator.device.type:
            generator.set_state(torch.frombuffer(bytearray(gen["state"]), dtype=torch.uint8))
        self._loop.state = (module, opt, step, generator, hyper)
        self._start_epoch = int(payload["epoch"]) + 1
        return self._start_epoch


# -- checkpoint payloads ---------------------------------------------------
#
# The state tree is the JAX package's ``(params, opt_state, step, rng,
# hyper)`` tuple, flattened as its RTPK1 blobs are: ``0/<flax params>``,
# ``1/count``, ``1/mu/<...>``, ``1/nu/<...>`` (``1/0/...`` and
# ``1/1/count`` for ``adam``'s chain), ``2`` (int32 step), ``3`` (a
# uint32[2] threefry key) and ``4/<hyper>`` (float32). The port's
# dropout stream is a torch generator, which threefry cannot carry:
# ``3`` holds ``PRNGKey(seed)``, and the generator's state travels
# under its own payload key, which the JAX package does not read.

GENERATOR_KEY = "torch_generator"


def _subtree(flat: Dict[str, torch.Tensor], prefix: str) -> Dict[str, torch.Tensor]:
    p = prefix + "/"
    return {k[len(p):]: v for k, v in flat.items() if k.startswith(p)}


def _adam_tree(st: ScaleByAdamState, module: nn.Module, prefix: str,
               params: Optional[Sequence[torch.Tensor]] = None) -> Dict[str, Any]:
    params = list(module.parameters()) if params is None else list(params)
    mu = st.mu if st.mu is not None else [torch.zeros_like(p) for p in params]
    nu = st.nu if st.nu is not None else [torch.zeros_like(p) for p in params]
    tree: Dict[str, Any] = {f"{prefix}count": np.int32(st.count)}
    tree.update({f"{prefix}mu/{k}": v for k, v in state_dict_to_flax(module, mu).items()})
    tree.update({f"{prefix}nu/{k}": v for k, v in state_dict_to_flax(module, nu).items()})
    return tree


def _state_tree(state, seed: int,
                params: Optional[Sequence[torch.Tensor]] = None) -> Dict[str, Any]:
    """A serial train state as the JAX package's flat checkpoint tree
    (views of the device tensors). ``params`` (one tensor per parameter
    of the state's module, in its order: a snapshot's copies) stand in
    for the module's own values; the module then gives names only."""
    module, opt, step, _, hyper = state
    tree: Dict[str, Any] = {f"0/{k}": v for k, v in state_dict_to_flax(module, params).items()}
    if isinstance(opt, AdamState):
        tree.update(_adam_tree(opt.adam, module, "1/0/", params))
        tree["1/1/count"] = np.int32(opt.count)
    else:
        tree.update(_adam_tree(opt or ScaleByAdamState(0, None, None), module, "1/", params))
    tree["2"] = np.int32(step)
    tree["3"] = np.array([0, int(seed) & 0xFFFFFFFF], np.uint32)
    tree.update({f"4/{k}": v for k, v in hyper.items()})
    return tree


def _adam_from_tree(flat: Dict[str, torch.Tensor], module: nn.Module) -> ScaleByAdamState:
    params = list(module.parameters())

    def moments(name: str) -> List[torch.Tensor]:
        sd = flax_to_state_dict(_subtree(flat, name), module)
        return [torch.empty_like(p).copy_(sd[n]) for (n, _), p in
                zip(module.named_parameters(), params)]

    return ScaleByAdamState(count=int(flat["count"]), mu=moments("mu"), nu=moments("nu"))


def _opt_from_tree(flat: Dict[str, torch.Tensor], module: nn.Module, optimizer):
    """The optimizer state of ``optimizer``'s kind out of a checkpoint's
    ``1/`` subtree; raises KeyError or ValueError where it does not fit."""
    if isinstance(optimizer, Adam):
        return AdamState(adam=_adam_from_tree(_subtree(flat, "0"), module),
                         count=int(flat["1/count"]))
    return _adam_from_tree(flat, module)


def _generator_state(generator: torch.Generator) -> Dict[str, Any]:
    return {"device": generator.device.type, "state": bytes(generator.get_state().numpy())}


def _to_host(trees: Sequence[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Every tensor of ``trees`` on the host. From a card, each copy goes
    into pinned memory without waiting, all of them started before one
    synchronize (the counterpart of jax's ``copy_to_host_async``)."""
    out, cards = [], set()
    for tree in trees:
        host = {}
        for k, v in tree.items():
            if isinstance(v, torch.Tensor) and v.device.type == "cuda":
                buf = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                buf.copy_(v.detach(), non_blocking=True)
                cards.add(v.device)
                v = buf
            host[k] = v
        out.append(host)
    for device in cards:
        with device_lock(device):  # no capture of another thread in flight
            torch.cuda.synchronize(device)
    return out


def _lecun_init(module: nn.Module, generator: torch.Generator) -> None:
    """flax's default initializers, drawn in module order from
    ``generator``: conv and dense kernels from lecun_normal (a normal
    truncated at two standard deviations, variance 1/fan_in), biases 0,
    GroupNorm scales 1; a layer with ``flax_init`` (the embedding,
    LayerNorm, attention and LSTM cells of ``ops/layers.py``, and a
    module's own params such as ``pos_embed``) draws its own."""
    with torch.no_grad():
        for layer in module.modules():
            if hasattr(layer, "flax_init"):
                layer.flax_init(generator)
            if isinstance(layer, (nn.Conv2d, nn.Linear)):
                fan_in = layer.weight[0].numel()
                std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
                nn.init.trunc_normal_(layer.weight, std=std, a=-2 * std,
                                      b=2 * std, generator=generator)
                if layer.bias is not None:
                    layer.bias.zero_()
            elif isinstance(layer, GroupNorm):
                layer.weight.fill_(1.0)
                layer.bias.zero_()


def _portable_meta(meta: Dict[str, Any]) -> Dict[str, Any]:
    """The dataset-meta slice worth persisting in params blobs: scalars,
    plus the label-space signature (``tag_map``)."""
    out = {k: v for k, v in meta.items()
           if isinstance(v, (str, int, float, bool))}
    if isinstance(meta.get("tag_map"), dict):
        out["tag_map"] = dict(meta["tag_map"])
    return out


# ---------------------------------------------------------------------------
# Model file loading (reference: load_model_class executes uploaded .py)
# ---------------------------------------------------------------------------

def load_model_class(model_file_bytes: bytes, model_class: str) -> type:
    """Load a model template class from uploaded ``.py`` source bytes,
    exec-ed into a scratch module as the JAX package does. The uploaded
    source is *trusted* (model developers are authenticated users). The
    class must subclass this package's :class:`BaseModel`."""
    name = f"_rafiki_model_{abs(hash(model_file_bytes)) % (1 << 30):x}"
    mod = types.ModuleType(name)
    mod.__dict__["__file__"] = f"<{name}.py>"
    sys.modules[name] = mod
    try:
        exec(compile(model_file_bytes, f"<{name}.py>", "exec"), mod.__dict__)
    except Exception:
        del sys.modules[name]
        raise
    mod.__rafiki_source__ = model_file_bytes
    if not hasattr(mod, model_class):
        del sys.modules[name]
        raise ValueError(f"Model file defines no class named {model_class!r}")
    cls = getattr(mod, model_class)
    if not (isinstance(cls, type) and issubclass(cls, BaseModel)):
        del sys.modules[name]
        raise ValueError(f"{model_class} must subclass rafiki_tpu_torch BaseModel")
    return cls


def parse_model_install_command(dependencies: Dict[str, str]) -> List[str]:
    """The declared dependencies that do not import here (nothing is
    installed; the reference generated a pip command instead)."""
    missing = []
    for dep in dependencies or {}:
        pkg = {"scikit-learn": "sklearn", "Pillow": "PIL"}.get(dep, dep.replace("-", "_"))
        if importlib.util.find_spec(pkg) is None:
            missing.append(dep)
    return missing
