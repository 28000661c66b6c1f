"""BiLSTM POS tagger template, in PyTorch.

Counterpart of ``rafiki_tpu/models/pos_bilstm.py`` (``_BiLstmTagger``,
``PosBiLstm`` and its ``predict``) with the same knob config and
network, over int32 token ids ``(B, L)``: a bf16 embedding, flax's
``Bidirectional(RNN(LSTMCell), RNN(LSTMCell))`` in float32 over the
whole padded length (``ops/layers.py bidirectional_lstm``; the cells
are ``LSTMCell_0``, forward, and ``LSTMCell_1``, backward), the
``[forward, backward]`` outputs cast to bf16, and a bf16 Dense to the
tags at every position. Corpus datasets carry a mask, so trials of this
template are fed from the host and do not pack, as in the JAX package.
"""

from __future__ import annotations

from typing import Any, List

import numpy as np
import torch
from torch import nn

from rafiki_tpu_torch.model.base import TorchModel
from rafiki_tpu_torch.model.knobs import CategoricalKnob, FixedKnob, FloatKnob, IntegerKnob
from rafiki_tpu_torch.ops.layers import Embed, LstmCell, bidirectional_lstm, linear


class _BiLstmTagger(nn.Module):
    def __init__(self, vocab: int, embed_dim: int, hidden: int, num_tags: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.embed = Embed(vocab, embed_dim, dtype)
        self.forward_cell = LstmCell(embed_dim, hidden)
        self.backward_cell = LstmCell(embed_dim, hidden)
        self.head = nn.Linear(2 * hidden, num_tags)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        h = bidirectional_lstm(self.embed(x), self.forward_cell, self.backward_cell)
        return linear(h.to(self.dtype), self.head.weight.to(self.dtype),
                      self.head.bias.to(self.dtype))


class PosBiLstm(TorchModel):
    @staticmethod
    def get_knob_config():
        return {
            "embed_dim": CategoricalKnob([32, 64, 128], affects_shape=True),
            "hidden": CategoricalKnob([32, 64, 128], affects_shape=True),
            "learning_rate": FloatKnob(1e-4, 3e-2, is_exp=True),
            "batch_size": CategoricalKnob([16, 32, 64], affects_shape=True),
            "epochs": IntegerKnob(1, 10),
            "seed": FixedKnob(0),
        }

    def _input_dtype(self):
        return np.int32

    def build_module(self, num_classes, input_shape):
        vocab = int(self._dataset_meta.get("vocab", 1) or 1)
        return _BiLstmTagger(
            vocab=max(vocab, 2),
            embed_dim=int(self.knobs["embed_dim"]),
            hidden=int(self.knobs["hidden"]),
            num_tags=num_classes,
        )

    def predict(self, queries: List[Any]) -> List[List[int]]:
        """queries: variable-length token-id sequences -> per-token tag
        ids (the argmax over each query's own positions)."""
        if self._loop is None:
            raise RuntimeError("Model has no parameters: call train() or load_parameters() first")
        _, (length,) = self._arch
        x = np.zeros((len(queries), length), dtype=np.int32)
        lens = []
        for i, q in enumerate(queries):
            toks = np.asarray(q, dtype=np.int32)[:length]
            x[i, : len(toks)] = toks
            lens.append(len(toks))
        probs = self._loop.predict_proba(x, self.batch_size)  # (N, L, tags)
        return [np.argmax(probs[i, :n], axis=-1).astype(int).tolist()
                for i, n in enumerate(lens)]
