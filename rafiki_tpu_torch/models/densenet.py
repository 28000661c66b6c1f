"""DenseNet-BC template for CIFAR-10-class images, in PyTorch.

Counterpart of ``rafiki_tpu/models/densenet.py`` (``_DenseLayer``,
``_Transition``, ``_DenseNet``, ``DenseNet``) with the same knob config
and network:
  * a bias-free 3x3 stem conv to ``2 * growth`` channels;
  * three dense blocks of ``max(1, (depth - 4) // 6)`` bottleneck layers,
    each GroupNorm -> ReLU -> 1x1 conv to ``4 * growth`` -> GroupNorm ->
    ReLU -> 3x3 conv to ``growth``, concatenated onto its input;
  * between blocks a transition: GroupNorm -> ReLU -> 1x1 conv to
    ``max(8, int(C * 0.5))`` channels -> 2x2 average pool while
    ``min(H, W) >= 2``;
  * GroupNorm -> ReLU -> global mean over H and W (bf16 in, bf16 out)
    -> Dense to the classes.
Every GroupNorm has ``gcd(8, C)`` groups (one group where C is odd)
with flax's numerics, every conv is bias-free with SAME padding.
Parameters are float32 and each layer casts to the compute dtype
(bfloat16), as flax's ``dtype=bfloat16`` does. Queries arrive NHWC and
are viewed as channels-last NCHW, as in ``models/vgg.py``. The bottleneck
layers and transitions are flax scopes (``_DenseLayer_i``,
``_Transition_i``), which ``convert.py`` follows by their ``flax_scope``.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from rafiki_tpu_torch.model.base import TorchModel
from rafiki_tpu_torch.model.knobs import CategoricalKnob, FixedKnob, FloatKnob, IntegerKnob
from rafiki_tpu_torch.ops.layers import (GroupNorm, avg_pool2d, channel_concat, conv2d, linear,
                                         spatial_mean)


def _norm(ch: int, dtype: torch.dtype) -> GroupNorm:
    return GroupNorm(math.gcd(8, ch), ch, eps=1e-6, dtype=dtype)


class _DenseLayer(nn.Module):
    flax_scope = "_DenseLayer"

    def __init__(self, in_ch: int, growth: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.norm1 = _norm(in_ch, dtype)
        self.conv1 = nn.Conv2d(in_ch, 4 * growth, 1, bias=False)
        self.norm2 = _norm(4 * growth, dtype)
        self.conv2 = nn.Conv2d(4 * growth, growth, 3, padding=1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.relu(self.norm1(x))
        h = conv2d(h, self.conv1.weight.to(self.dtype))
        h = torch.relu(self.norm2(h))
        h = conv2d(h, self.conv2.weight.to(self.dtype), padding=1)
        return channel_concat(x, h)


class _Transition(nn.Module):
    flax_scope = "_Transition"

    def __init__(self, in_ch: int, out_ch: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.norm = _norm(in_ch, dtype)
        self.conv = nn.Conv2d(in_ch, out_ch, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = conv2d(torch.relu(self.norm(x)), self.conv.weight.to(self.dtype))
        if min(x.shape[2], x.shape[3]) >= 2:
            x = avg_pool2d(x)
        return x


class _DenseNet(nn.Module):
    """DenseNet over NHWC float input ``(B, H, W, C)``; returns logits in
    the compute dtype."""

    def __init__(self, depth: int, growth: int, num_classes: int, in_ch: int,
                 reduction: float = 0.5, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        per_block = max(1, (depth - 4) // 6)
        ch = 2 * growth
        self.conv0 = nn.Conv2d(in_ch, ch, 3, padding=1, bias=False)
        dense, trans = [], []
        for block in range(3):
            for _ in range(per_block):
                dense.append(_DenseLayer(ch, growth, dtype))
                ch += growth
            if block < 2:
                out_ch = max(8, int(ch * reduction))
                trans.append(_Transition(ch, out_ch, dtype))
                ch = out_ch
        self.per_block = per_block
        self.dense = nn.ModuleList(dense)
        self.trans = nn.ModuleList(trans)
        self.norm = _norm(ch, dtype)
        self.fc = nn.Linear(ch, num_classes)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2).to(self.dtype)  # NHWC -> NCHW, channels-last
        x = conv2d(x, self.conv0.weight.to(self.dtype), padding=1)
        for block in range(3):
            for layer in self.dense[block * self.per_block:(block + 1) * self.per_block]:
                x = layer(x)
            if block < 2:
                x = self.trans[block](x)
        x = spatial_mean(torch.relu(self.norm(x)))
        return linear(x, self.fc.weight.to(self.dtype), self.fc.bias.to(self.dtype))


class DenseNet(TorchModel):
    @staticmethod
    def get_knob_config():
        return {
            "depth": CategoricalKnob([22, 40, 58], affects_shape=True),
            "growth": CategoricalKnob([12, 24], affects_shape=True),
            "learning_rate": FloatKnob(1e-4, 3e-2, is_exp=True),
            "batch_size": CategoricalKnob([64, 128], affects_shape=True),
            "epochs": IntegerKnob(1, 10),
            "seed": FixedKnob(0),
        }

    def build_module(self, num_classes, input_shape):
        return _DenseNet(
            depth=int(self.knobs["depth"]),
            growth=int(self.knobs["growth"]),
            num_classes=num_classes,
            in_ch=int(input_shape[-1]),
        )

