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

Not ported yet: ``make_optimizer`` (the custom-optimizer path),
``dump_checkpoint`` / ``restore_checkpoint`` and the checkpoint sink,
trial packing and the dp mesh.
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

    def _loop_fns(self, num_classes: int, input_shape: tuple) -> Dict[str, Any]:
        """Everything a TrainLoop needs: the module, the closures, the
        optimizer and this trial's hyper dict."""
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
            model={"module": type(self).__module__, "qualname": type(self).__qualname__,
                   "knobs": dict(self.knobs)},
            train_uri=dataset_uri, batch_size=self.batch_size, seed=self._seed,
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
