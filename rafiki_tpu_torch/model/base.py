"""The model contract, and the PyTorch base class of the port.

``BaseModel`` is the port's own copy of the reference-compatible
surface in ``rafiki_tpu/model/base.py`` (``get_knob_config / train /
evaluate / predict / dump_parameters / load_parameters / destroy``).

``TorchModel`` is the serving half of ``JaxModel``: a subclass returns
an ``nn.Module`` from ``build_module(num_classes, input_shape)`` and
gets ``predict`` / ``predict_proba`` and params blobs that the JAX
package reads too (same pickle payload ``{"arch", "packed",
"dataset_meta"}``, same RTPK1 leaves and flax key names; see
``utils/serial.py`` and ``convert.py``). Training comes with a later
slice; ``init_parameters`` gives seeded weights meanwhile.
"""

from __future__ import annotations

import abc
import math
import os
import pickle
from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from rafiki_tpu_torch.convert import flax_to_state_dict, state_dict_to_flax
from rafiki_tpu_torch.model.knobs import KnobConfig, Knobs, validate_knobs
from rafiki_tpu_torch.ops import train as _ops
from rafiki_tpu_torch.ops.layers import GroupNorm
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

    ``device`` is where the module lives: the CUDA card by default,
    ``"cpu"`` only on request; without CUDA and without that request
    the constructor raises.
    """

    def __init__(self, *, device: DeviceLike = None, **knobs: Any):
        super().__init__(**knobs)
        self.device = resolve_device(device)
        self._module: Optional[nn.Module] = None
        self._arch = None
        self._seed = int(self.knobs.get("seed", 0))
        self._dataset_meta: Dict[str, Any] = {}

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

    def preprocess(self, x: np.ndarray) -> np.ndarray:
        """Optional input transform. MUST NOT modify ``x`` in place;
        return a new array."""
        return x

    def _input_dtype(self):
        return np.float32

    # -- trial hooks ---------------------------------------------------------

    def train(self, dataset_uri: str) -> None:
        raise NotImplementedError(
            "rafiki_tpu_torch serves trained params; its training loop is "
            "not ported yet (train with rafiki_tpu, or use init_parameters)")

    def evaluate(self, dataset_uri: str) -> float:
        raise NotImplementedError(
            "rafiki_tpu_torch.evaluate comes with the training loop; it is "
            "not ported yet")

    # -- params --------------------------------------------------------------

    def _install(self, module: nn.Module, num_classes: int, input_shape: tuple) -> None:
        self._module = module.to(self.device).eval()
        self._arch = (num_classes, tuple(input_shape))

    def init_parameters(self, num_classes: int, input_shape: tuple,
                        generator: Optional[torch.Generator] = None) -> None:
        """Seeded random weights (for serving tests and smoke runs):
        conv and dense kernels from flax's lecun_normal distribution,
        norm scales 1, biases 0. Drawn on the CPU from ``generator``
        (default: seeded with the ``seed`` knob), so the weights are
        the same whatever the device."""
        if generator is None:
            generator = torch.Generator().manual_seed(self._seed)
        module = self.build_module(num_classes, tuple(input_shape))
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
        self._install(module, num_classes, input_shape)

    def dump_parameters(self) -> bytes:
        """The JAX package's serving blob: float32 leaves stored as
        bfloat16 unless ``RAFIKI_TPU_SERVING_PARAMS_DTYPE=float32``."""
        if self._module is None:
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
        module = self.build_module(num_classes, tuple(input_shape))
        module.load_state_dict(flax_to_state_dict(load_flat(payload["packed"]), module))
        self._install(module, num_classes, input_shape)

    # -- serving -------------------------------------------------------------

    def predict(self, queries: List[Any]) -> List[List[float]]:
        return self.predict_proba(np.asarray(queries, dtype=self._input_dtype())).tolist()

    def predict_proba(self, x: np.ndarray) -> np.ndarray:
        """Array-in/array-out fast path used by the ensemble predictor."""
        if self._module is None:
            raise RuntimeError("Model has no parameters: call train() or load_parameters() first")
        x = self.preprocess(np.asarray(x, self._input_dtype()))
        return _ops.predict_proba(self._module, x, self.batch_size, self.device)

    def destroy(self) -> None:
        self._module = None


def _portable_meta(meta: Dict[str, Any]) -> Dict[str, Any]:
    """The dataset-meta slice worth persisting in params blobs: scalars,
    plus the label-space signature (``tag_map``)."""
    out = {k: v for k, v in meta.items()
           if isinstance(v, (str, int, float, bool))}
    if isinstance(meta.get("tag_map"), dict):
        out["tag_map"] = dict(meta["tag_map"])
    return out
