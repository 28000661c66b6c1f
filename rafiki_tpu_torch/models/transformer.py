"""Small text-classification transformer template, in PyTorch.

Counterpart of ``rafiki_tpu/models/transformer.py`` (``_Encoder`` and
``Transformer``) with the same knob config and network, over int32
token ids ``(B, L)``:
  * a bf16 token embedding (``Embed_0``) plus a learned ``pos_embed``
    ``(L, E)`` (normal, std 0.02) cast to bf16: the length is the
    training sequence length;
  * per layer, pre-LN: ``LayerNorm`` (float32 out) cast to bf16 ->
    ``SelfAttention`` -> residual add; ``LayerNorm`` cast to bf16 ->
    Dense(4E) -> GELU (flax's ``nn.gelu`` is the tanh approximation) ->
    Dense(E) -> residual add; the residual stream is bf16;
  * a final ``LayerNorm`` (float32), the mean over tokens, cast to bf16,
    and a bf16 Dense to the classes.
The vocabulary size comes from the training dataset's ``vocab`` meta.
``shard_plan`` is the template's sharded-lane declaration (the mesh
sweep's lane fork reads it): the group width solved from the parameter
shapes, built on the ``meta`` device.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from rafiki_tpu_torch.model.base import TorchModel
from rafiki_tpu_torch.model.knobs import CategoricalKnob, FixedKnob, FloatKnob, IntegerKnob
from rafiki_tpu_torch.ops.layers import Embed, LayerNorm, SelfAttention, _member_wise, linear


class _Block(nn.Module):
    """One encoder layer (not a flax scope: its layers are counted in the
    encoder's)."""

    def __init__(self, embed_dim: int, num_heads: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.ln1 = LayerNorm(embed_dim)
        self.attn = SelfAttention(embed_dim, num_heads, dtype)
        self.ln2 = LayerNorm(embed_dim)
        self.mlp1 = nn.Linear(embed_dim, 4 * embed_dim)
        self.mlp2 = nn.Linear(4 * embed_dim, embed_dim)

    def _dense(self, layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        return linear(x, layer.weight.to(self.dtype), layer.bias.to(self.dtype))

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        h = h + self.attn(self.ln1(h).to(self.dtype))
        m = self._dense(self.mlp1, self.ln2(h).to(self.dtype))
        return h + self._dense(self.mlp2, F.gelu(m, approximate="tanh"))


class _Encoder(nn.Module):
    def __init__(self, vocab: int, embed_dim: int, num_heads: int, num_layers: int,
                 num_classes: int, length: int, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.embed = Embed(vocab, embed_dim, dtype)
        self.pos_embed = nn.Parameter(torch.zeros(length, embed_dim))
        self.blocks = nn.ModuleList([_Block(embed_dim, num_heads, dtype)
                                     for _ in range(num_layers)])
        self.ln_f = LayerNorm(embed_dim)
        self.head = nn.Linear(embed_dim, num_classes)

    def flax_init(self, generator: torch.Generator) -> None:
        nn.init.normal_(self.pos_embed, std=0.02, generator=generator)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        # Per member in a pack, so pos_embed's gradient is reduced over
        # the member's own batch as a serial step reduces it.
        h = _member_wise(lambda e, p: e + p.to(self.dtype), self.embed(x), self.pos_embed)
        for block in self.blocks:
            h = block(h)
        h = _member_wise(lambda t: t.mean(1), self.ln_f(h)).to(self.dtype)
        return linear(h, self.head.weight.to(self.dtype), self.head.bias.to(self.dtype))


class Transformer(TorchModel):
    @staticmethod
    def get_knob_config():
        return {
            "embed_dim": CategoricalKnob([32, 64, 128], affects_shape=True),
            "num_heads": CategoricalKnob([2, 4], affects_shape=True),
            "num_layers": IntegerKnob(1, 2, affects_shape=True),
            "learning_rate": FloatKnob(1e-4, 3e-2, is_exp=True),
            "batch_size": CategoricalKnob([16, 32, 64], affects_shape=True),
            "epochs": IntegerKnob(1, 5),
            "seed": FixedKnob(0),
        }

    def _input_dtype(self):
        return np.int32

    def build_module(self, num_classes, input_shape):
        vocab = int(self._dataset_meta.get("vocab", 1) or 1)
        return _Encoder(
            vocab=max(vocab, 2),
            embed_dim=int(self.knobs["embed_dim"]),
            num_heads=int(self.knobs["num_heads"]),
            num_layers=int(self.knobs["num_layers"]),
            num_classes=num_classes,
            length=int(input_shape[0]),
        )

    def shard_plan(self, ds, per_chip_bytes=None):
        """Solve this configuration's group width from the parameters'
        shapes alone: the module is built on the ``meta`` device, so
        nothing is materialised. Against the card's own memory (or
        ``per_chip_bytes``); on the CPU, which has no per-chip figure,
        the width is the pin (``RAFIKI_SHARD_WIDTH``) or 1. Width 1 (the
        answer for this small grid) keeps the trial in the serial and
        packed lanes; tests and smokes pin wider groups."""
        from rafiki_tpu_torch.shard import ShardPlan

        self._dataset_meta = dict(ds.meta)
        num_classes, input_shape = self._dataset_arch(ds)
        with torch.device("meta"):
            module = self.build_module(num_classes, input_shape)
        return ShardPlan.for_params(module, family=type(self).__name__,
                                    per_chip_bytes=per_chip_bytes, device=self.device)
