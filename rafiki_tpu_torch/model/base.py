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

Not ported yet: ``make_optimizer`` (the custom-optimizer path),
``dump_checkpoint`` / ``restore_checkpoint`` and the checkpoint sink
(so ``train_packed`` takes no ``checkpoint_sink``), the learning-curve
kill (so it takes no ``kill_predicate``), and the dp mesh.
"""

from __future__ import annotations

import abc
import functools
import inspect
import math
import os
import pickle
import sys
import types
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from rafiki_tpu_torch.convert import flax_to_state_dict, state_dict_to_flax
from rafiki_tpu_torch.model.dataset import Dataset, dataset_utils
from rafiki_tpu_torch.model.knobs import KnobConfig, Knobs, validate_knobs
from rafiki_tpu_torch.model.log import logger
from rafiki_tpu_torch.ops import train as _ops
from rafiki_tpu_torch.ops.layers import GroupNorm
from rafiki_tpu_torch.ops.optim import scale_by_adam
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

    def _dynamic_hyper(self, takes_dropout: bool) -> Dict[str, float]:
        """The per-trial float32 scalars the train step reads."""
        hyper = {"lr": float(self.learning_rate),
                 "warmup": float(self._warmup_steps())}
        if takes_dropout and "dropout" in self.knobs:
            hyper["dropout"] = float(self.knobs["dropout"])
        return hyper

    def _program_key(self, num_classes: int, input_shape: tuple, takes_dropout: bool):
        """What reaches the step's computation, apart from the knobs that
        reach it only through the hyper dict or not at all
        (``ops/train.py DYNAMIC_KNOBS``; ``dropout`` only when the module
        takes it as a rate): the template, the arch and the baked knobs.
        The JAX package keys its program cache on it; the port keys trial
        packing on it."""
        dyn = set(_ops.DYNAMIC_KNOBS) if takes_dropout else set(_ops.DYNAMIC_KNOBS) - {"dropout"}
        baked = tuple(sorted((k, repr(v)) for k, v in self.knobs.items() if k not in dyn))
        return (type(self).__module__, type(self).__qualname__, num_classes,
                tuple(input_shape), baked, False)

    def _health_model_identity(self) -> Dict[str, Any]:
        return {"module": type(self).__module__, "qualname": type(self).__qualname__,
                "knobs": dict(self.knobs)}

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

        return {
            "module": module,
            "init_fn": init_fn,
            "apply_eval": apply_eval,
            "loss_fn": loss_fn,
            "optimizer": self.make_base_optimizer(),
            "hyper": self._dynamic_hyper(takes_dropout),
            "program_key": self._program_key(num_classes, input_shape, takes_dropout),
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
            seed=self._seed, hyper=fns["hyper"], device=self.device)
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
        num_classes, input_shape = ds.classes, tuple(ds.x.shape[1:])
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
        for epoch in range(self.epochs):
            metrics = self._loop.run_epoch(ds, self.batch_size, epoch_seed=self._seed + epoch)
            logger.log(epoch=epoch, **metrics)
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
        ``preprocess`` (which may depend on per-trial knobs) may not."""
        return cls.preprocess is TorchModel.preprocess

    def packing_key(self, ds: Dataset):
        """Two models train in one pack iff their keys are equal: the same
        program (template, arch, baked knobs), the same step geometry
        (batch size, epochs) and the same hyper key set."""
        num_classes, input_shape = ds.classes, tuple(ds.x.shape[1:])
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

        ``checkpoint_sink`` (per-epoch checkpoints of the pack) and
        ``kill_predicate`` (the learning-curve kill) are not ported yet;
        anything but None is refused.
        """
        if checkpoint_sink is not None:
            raise NotImplementedError("packed checkpoints are not ported to rafiki_tpu_torch")
        if kill_predicate is not None:
            raise NotImplementedError("the learning-curve kill is not ported to rafiki_tpu_torch")
        from rafiki_tpu_torch.obs.health import detector as _detector

        if not models:
            return []
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
        num_classes, input_shape = ds.classes, tuple(ds.x.shape[1:])
        epochs, batch_size = lead.epochs, lead.batch_size
        arch = (num_classes, input_shape)
        planned = epochs * max(1, ds.size // batch_size)

        # One set of closures (the lead's: equal keys make them
        # interchangeable) and k hyper dicts and seeds.
        fns = lead._loop_fns(num_classes, input_shape)
        hypers = {}
        for i, m in enumerate(models):
            m._planned_steps = planned
            m._dataset_meta = dict(ds.meta)
            hypers[i] = m._loop_fns(num_classes, input_shape)["hyper"]
        packed = _ops.PackedTrainLoop(
            fns["init_fn"], fns["apply_eval"], fns["loss_fn"], fns["optimizer"],
            seeds=[m._seed for m in models], hypers=[hypers[i] for i in range(len(models))],
            packing_key=key, device=lead.device)

        def install_detached(mi: int, state, epoch: int) -> None:
            """An evicted member carries on in an ordinary serial loop."""
            m = models[mi]
            m._loop = _ops.TrainLoop(
                fns["init_fn"], fns["apply_eval"], fns["loss_fn"], fns["optimizer"],
                seed=m._seed, hyper=hypers[mi], initial_state=state, device=m.device)
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
        rnd = 0
        while slots:
            # Serial parity: a member's shuffle seed is its seed plus its
            # own epoch index; a backfilled member counts from 0.
            mts = packed.run_epoch(ds, batch_size,
                                   [models[mi]._seed + epochs_done[mi] for mi in slots])
            for j, mi in enumerate(slots):
                histories[mi].append(dict(mts[j], epoch=epochs_done[mi]))
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
                    m2._dataset_meta = dict(ds.meta)
                    mi2 = len(models)
                    hypers[mi2] = m2._loop_fns(num_classes, input_shape)["hyper"]
                    models.append(m2)
                    histories.append([])
                    packed.admit(m2._seed, hypers[mi2])
                    slots.append(mi2)
                    epochs_done[mi2] = 0
        return histories

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


def _lecun_init(module: nn.Module, generator: torch.Generator) -> None:
    """Conv and dense kernels from flax's lecun_normal (a normal truncated
    at two standard deviations, variance 1/fan_in), biases 0, norm
    scales 1; drawn in module order from ``generator``."""
    with torch.no_grad():
        for layer in module.modules():
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
