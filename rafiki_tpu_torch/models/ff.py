"""FeedForward MLP template, in PyTorch.

Counterpart of ``rafiki_tpu/models/ff.py`` (``_Mlp`` and
``FeedForward``) with the same knob config: the input flattened,
``hidden_layers`` x (Dense(hidden_units) + ReLU), then Dense to the
classes. Parameters are float32 and each layer casts its input and
parameters to the compute dtype (bfloat16 by default), as flax's
``dtype=bfloat16`` does; no autocast. Layers register in call order,
so ``convert.py`` names them ``Dense_0``, ``Dense_1``, ... as flax does.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from rafiki_tpu_torch.model.base import TorchModel
from rafiki_tpu_torch.model.knobs import CategoricalKnob, FixedKnob, FloatKnob, IntegerKnob


class _Mlp(nn.Module):
    def __init__(self, hidden_layers: int, hidden_units: int, num_classes: int,
                 input_shape: tuple, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        widths = [math.prod(int(s) for s in input_shape)] + [hidden_units] * hidden_layers
        self.layers = nn.ModuleList(
            [nn.Linear(a, b) for a, b in zip(widths[:-1], widths[1:])]
            + [nn.Linear(widths[-1], num_classes)])

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1).to(self.dtype)
        for i, layer in enumerate(self.layers):
            x = F.linear(x, layer.weight.to(self.dtype), layer.bias.to(self.dtype))
            if i < len(self.layers) - 1:
                x = torch.relu(x)
        return x


class FeedForward(TorchModel):
    @staticmethod
    def get_knob_config():
        return {
            "hidden_layers": IntegerKnob(1, 3, affects_shape=True),
            "hidden_units": CategoricalKnob([32, 64, 128, 256], affects_shape=True),
            "learning_rate": FloatKnob(1e-4, 1e-1, is_exp=True),
            "batch_size": CategoricalKnob([32, 64, 128], affects_shape=True),
            "epochs": IntegerKnob(1, 5),
            "seed": FixedKnob(0),
        }

    def build_module(self, num_classes, input_shape):
        return _Mlp(
            hidden_layers=int(self.knobs["hidden_layers"]),
            hidden_units=int(self.knobs["hidden_units"]),
            num_classes=num_classes,
            input_shape=input_shape,
        )
