"""Bigram HMM POS tagger (host model).

The port's own copy of ``rafiki_tpu/models/pos_hmm.py``: count-based
emission and transition tables with Viterbi decoding, in numpy on the
host. It exists for the POS_TAGGING task family and as a non-neural
baseline for the advisor; its pickled params are the JAX package's.
"""

from __future__ import annotations

import pickle
from typing import Any, List

import numpy as np

from rafiki_tpu_torch.model.base import BaseModel
from rafiki_tpu_torch.model.dataset import dataset_utils
from rafiki_tpu_torch.model.knobs import FixedKnob, FloatKnob


class PosBigramHmm(BaseModel):
    @staticmethod
    def get_knob_config():
        return {
            "smoothing": FloatKnob(1e-3, 1.0, is_exp=True),
            "seed": FixedKnob(0),
        }

    def __init__(self, **knobs):
        super().__init__(**knobs)
        self._emit = None       # (tags, vocab) log emission
        self._trans = None      # (tags+1, tags) log transition (row -1 = start)
        self._tags = 0
        self._vocab = 0

    def train(self, dataset_uri: str) -> None:
        ds = dataset_utils.load(dataset_uri)
        alpha = float(self.knobs["smoothing"])
        tags = ds.classes
        vocab = int(ds.meta.get("vocab", int(ds.x.max()) + 1))
        emit = np.full((tags, vocab), alpha)
        trans = np.full((tags + 1, tags), alpha)
        for i in range(ds.size):
            prev = tags  # start state
            for j in range(ds.x.shape[1]):
                if ds.mask is not None and not ds.mask[i, j]:
                    break
                tok, tag = int(ds.x[i, j]), int(ds.y[i, j])
                emit[tag, tok] += 1
                trans[prev, tag] += 1
                prev = tag
        self._emit = np.log(emit / emit.sum(axis=1, keepdims=True))
        self._trans = np.log(trans / trans.sum(axis=1, keepdims=True))
        self._tags, self._vocab = tags, vocab

    def _viterbi(self, tokens: np.ndarray) -> List[int]:
        n = len(tokens)
        if n == 0:
            return []
        T = self._tags
        dp = np.zeros((n, T))
        bp = np.zeros((n, T), dtype=np.int32)
        tok0 = min(int(tokens[0]), self._vocab - 1)
        dp[0] = self._trans[T] + self._emit[:, tok0]
        for t in range(1, n):
            tok = min(int(tokens[t]), self._vocab - 1)
            scores = dp[t - 1][:, None] + self._trans[:T]
            bp[t] = scores.argmax(axis=0)
            dp[t] = scores.max(axis=0) + self._emit[:, tok]
        path = [int(dp[-1].argmax())]
        for t in range(n - 1, 0, -1):
            path.append(int(bp[t, path[-1]]))
        return path[::-1]

    def evaluate(self, dataset_uri: str) -> float:
        ds = dataset_utils.load(dataset_uri)
        correct = total = 0
        for i in range(ds.size):
            mask = ds.mask[i] if ds.mask is not None else np.ones(ds.x.shape[1], bool)
            toks = ds.x[i][mask]
            gold = ds.y[i][mask]
            pred = self._viterbi(toks)
            correct += int((np.asarray(pred) == gold).sum())
            total += len(gold)
        return correct / max(total, 1)

    def predict(self, queries: List[Any]) -> List[List[int]]:
        """queries: list of token-id sequences → list of tag-id sequences."""
        return [self._viterbi(np.asarray(q, dtype=np.int64)) for q in queries]

    def dump_parameters(self) -> bytes:
        return pickle.dumps({"emit": self._emit, "trans": self._trans,
                             "tags": self._tags, "vocab": self._vocab})

    def load_parameters(self, blob: bytes) -> None:
        p = pickle.loads(blob)
        self._emit, self._trans = p["emit"], p["trans"]
        self._tags, self._vocab = p["tags"], p["vocab"]
