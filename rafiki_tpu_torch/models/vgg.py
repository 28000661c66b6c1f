"""VGG template for CIFAR-10-class images, in PyTorch.

Counterpart of ``rafiki_tpu/models/vgg.py`` with the same ``_CFGS``
and knob config, and the same network:
  * bias-free 3x3 conv with SAME padding, GroupNorm(gcd(8, ch)) with
    flax's numerics (``ops/layers.py``), ReLU;
  * 2x2 max-pool, applied only while ``min(H, W) >= 2``;
  * flatten in NHWC order, Dense(max(64, 512 * width_mult)), ReLU,
    dropout (training only), Dense to the classes.
Parameters are float32 and each layer casts its input and parameters
to the compute dtype (bfloat16 by default), as flax's
``dtype=bfloat16`` does; no autocast. Queries arrive NHWC and are
viewed as NCHW with a channels-last layout, so no copy is made.
In training the dropout rate may be a float32 tensor
(``ops/train.py dropout``), so a dropout sweep runs one code path; it
falls back to the ``dropout`` attribute when none is passed.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from rafiki_tpu_torch.model.base import TorchModel
from rafiki_tpu_torch.model.knobs import CategoricalKnob, FixedKnob, FloatKnob, IntegerKnob
from rafiki_tpu_torch.ops.layers import GroupNorm
from rafiki_tpu_torch.ops.train import dropout as _dropout

_CFGS = {
    11: [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    13: [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    16: [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M",
         512, 512, 512, "M"],
}


class _Vgg(nn.Module):
    """VGG over NHWC float input ``(B, H, W, C)``; returns logits in the
    compute dtype. ``input_shape`` is ``(H, W, C)``: the Dense after the
    conv stack needs the final spatial size."""

    def __init__(self, depth: int, width_mult: float, num_classes: int,
                 input_shape: tuple, dtype: torch.dtype = torch.bfloat16,
                 dropout: float = 0.0):
        super().__init__()
        self.dtype = dtype
        self.dropout = dropout
        h, w, cin = (int(s) for s in input_shape)
        self.plan = []  # "M" or the conv index, in call order
        convs, norms = [], []
        for v in _CFGS[depth]:
            if v == "M":
                self.plan.append("M")
                if min(h, w) >= 2:
                    h, w = h // 2, w // 2
                continue
            ch = max(8, int(v * width_mult))
            self.plan.append(len(convs))
            convs.append(nn.Conv2d(cin, ch, 3, padding=1, bias=False))
            norms.append(GroupNorm(math.gcd(8, ch), ch, eps=1e-6, dtype=dtype))
            cin = ch
        self.convs = nn.ModuleList(convs)
        self.norms = nn.ModuleList(norms)
        self.fc1 = nn.Linear(h * w * cin, max(64, int(512 * width_mult)))
        self.fc2 = nn.Linear(self.fc1.out_features, num_classes)

    def _dense(self, layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, layer.weight.to(self.dtype), layer.bias.to(self.dtype))

    def forward(self, x: torch.Tensor, train: bool = False, dropout_rate=None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2).to(self.dtype)  # NHWC -> NCHW, channels-last
        for step in self.plan:
            if step == "M":
                if min(x.shape[2], x.shape[3]) >= 2:
                    x = F.max_pool2d(x, 2, 2)
                continue
            conv = self.convs[step]
            x = F.conv2d(x, conv.weight.to(self.dtype), None, padding=1)
            x = torch.relu(self.norms[step](x))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # NHWC flatten
        x = torch.relu(self._dense(self.fc1, x))
        if train:
            rate = self.dropout if dropout_rate is None else dropout_rate
            x = _dropout(x, rate, generator, deterministic=False)
        return self._dense(self.fc2, x)


class Vgg(TorchModel):
    @staticmethod
    def get_knob_config():
        return {
            "depth": CategoricalKnob([11, 13, 16], affects_shape=True),
            "width_mult": CategoricalKnob([0.25, 0.5, 1.0], affects_shape=True),
            "dropout": FloatKnob(0.0, 0.5),
            "learning_rate": FloatKnob(1e-4, 3e-2, is_exp=True),
            "batch_size": CategoricalKnob([64, 128, 256], affects_shape=True),
            "epochs": IntegerKnob(1, 10),
            "seed": FixedKnob(0),
        }

    def build_module(self, num_classes, input_shape):
        return _Vgg(
            depth=int(self.knobs["depth"]),
            width_mult=float(self.knobs["width_mult"]),
            num_classes=num_classes,
            input_shape=input_shape,
            dropout=float(self.knobs["dropout"]),
        )
