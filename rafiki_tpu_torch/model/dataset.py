"""Dataset utilities: URI-addressed datasets and fixed-shape batching.

The port's own copy of ``rafiki_tpu/model/dataset.py`` (numpy only),
covering what the training slice loads: ``Dataset`` with ``batches``
and ``split``,
``synthetic_images``, ``.npz`` image files, and the ``dataset_utils``
front door with its process-wide LRU cache. The same URI gives the same
arrays, byte for byte, as the JAX package's loader.

Not copied yet: the corpus and text generators, corpus ``.npz`` files
and the zip formats (image files, TSV corpora) of the reference; their
models are not ported. ``dataset_utils.load`` raises ``ValueError``
for them.

URI schemes:
  synthetic://images?classes=10&w=28&h=28&c=1&n=2048&seed=0
  /path/to/dataset.npz        (npz with arrays x, y)
  file:///path/to/dataset.npz
"""

from __future__ import annotations

import json
import os
import threading
import urllib.parse
from dataclasses import dataclass, field
from typing import Iterator, Optional, Tuple

import numpy as np


@dataclass
class Dataset:
    """An in-memory dataset of (x, y) numpy arrays.

    For images: x is (N, H, W, C) float32 in [0, 1], y is (N,) int32.
    ``mask`` (optional, (N, L) bool) marks the valid tokens of padded
    sequence data.
    """

    x: np.ndarray
    y: np.ndarray
    classes: int
    mask: Optional[np.ndarray] = None
    meta: dict = field(default_factory=dict)

    @property
    def size(self) -> int:
        return int(self.x.shape[0])

    def split(self, frac: float, seed: int = 0) -> Tuple["Dataset", "Dataset"]:
        """Deterministic shuffled split into (first, second) with
        ``|first| = int(frac * N)``: the JAX package's permutation,
        ``np.random.default_rng(seed).permutation(N)``."""
        order = np.random.default_rng(seed).permutation(self.size)
        k = int(self.size * frac)

        def take(idx: np.ndarray) -> "Dataset":
            return Dataset(self.x[idx], self.y[idx], self.classes,
                           None if self.mask is None else self.mask[idx], dict(self.meta))

        return take(order[:k]), take(order[k:])

    def batches(
        self,
        batch_size: int,
        shuffle: bool = False,
        seed: int = 0,
        drop_remainder: bool = True,
        start: int = 0,
    ) -> Iterator[dict]:
        """Yield dicts of fixed-shape numpy batches.

        drop_remainder=True  -> training mode: every batch is exactly
            batch_size.
        drop_remainder=False -> eval mode: the last batch is padded with
            row 0 to batch_size and carries ``valid`` (bool mask over
            rows) so metrics can ignore the padding.
        start -> skip the first ``start`` rows (in iteration order); used
            when a device-side pass already covered a prefix.
        """
        n = self.size
        order = np.random.default_rng(seed).permutation(n) if shuffle else np.arange(n)
        for start in range(start, n, batch_size):
            idx = order[start : start + batch_size]
            if len(idx) < batch_size:
                if drop_remainder:
                    return
                pad = batch_size - len(idx)
                idx = np.concatenate([idx, np.zeros(pad, dtype=idx.dtype)])
                valid = np.zeros(batch_size, dtype=bool)
                valid[: batch_size - pad] = True
            else:
                valid = np.ones(batch_size, dtype=bool)
            batch = {"x": self.x[idx], "y": self.y[idx], "valid": valid}
            if self.mask is not None:
                batch["mask"] = self.mask[idx]
            yield batch


def synthetic_images(classes=10, w=28, h=28, c=1, n=2048, seed=0, noise=0.35,
                     dist=0, flip=0.0) -> Dataset:
    """Class-conditional Gaussian-blob images.

    Each class k gets a fixed random low-frequency template image;
    samples are template + Gaussian noise, clipped to [0, 1]. ``dist``
    seeds the templates (the task), ``seed`` the draws, so train and
    test splits of one task share ``dist`` and differ in ``seed``.
    ``flip`` relabels that fraction of samples uniformly at random,
    which caps attainable accuracy at (1 - flip) + flip / classes.
    """
    th, tw = max(2, h // 4), max(2, w // 4)
    coarse = (np.random.default_rng(dist)
              .uniform(0.0, 1.0, size=(classes, th, tw, c)).astype(np.float32))
    templates = np.repeat(np.repeat(coarse, h // th + 1, axis=1), w // tw + 1, axis=2)
    templates = templates[:, :h, :w, :]
    rng = np.random.default_rng(seed + 1_000_003)
    y = rng.integers(0, classes, size=n).astype(np.int32)
    x = templates[y] + rng.normal(0.0, noise, size=(n, h, w, c)).astype(np.float32)
    x = np.clip(x, 0.0, 1.0).astype(np.float32)
    if flip > 0:
        flipped = rng.uniform(size=n) < flip
        y = np.where(flipped, rng.integers(0, classes, size=n), y).astype(np.int32)
    return Dataset(x, y, classes, meta={"kind": "images", "synthetic": True})


def _load_npz_images(path: str) -> Dataset:
    with np.load(path, allow_pickle=False) as z:
        if "mask" in z or z["x"].ndim == 2:
            raise ValueError(f"{path!r} holds a corpus; its models are not ported")
        x = z["x"]
        y = z["y"].astype(np.int32)
        saved_meta = (json.loads(str(z["meta_json"]))
                      if "meta_json" in z else {})
    classes = int(y.max()) + 1
    if saved_meta.get("classes"):
        classes = int(saved_meta.pop("classes"))
    if x.dtype == np.uint8:
        x = x.astype(np.float32) / 255.0
    meta = {"kind": "images", "uri": path}
    meta.update(saved_meta)
    return Dataset(x, y, classes=classes, meta=meta)


def _resolve_path(uri: str) -> str:
    if uri.startswith("file://"):
        return urllib.parse.urlparse(uri).path
    return os.path.expanduser(uri)


class DatasetUtils:
    """URI front door, mirroring the reference's ``dataset_utils``.

    Loads are cached process-wide (small LRU, keyed by URI, plus the
    file's mtime for local paths): a worker loads the same URI once
    per trial, and regenerating a CIFAR-scale synthetic set costs about
    as much as a warm trial. Datasets are treated as immutable by every
    consumer; the device copy the training loop uploads is cached on
    the ``Dataset`` object, so it lives as long as the cache entry.
    """

    _CACHE_CAP = 4

    def __init__(self):
        self._cache: dict = {}  # key -> Dataset; insertion order = LRU
        self._lock = threading.Lock()

    def _cache_key(self, uri: str):
        if uri.startswith("synthetic://"):
            return uri
        try:
            return (uri, os.path.getmtime(_resolve_path(uri)))
        except OSError:
            return None  # missing path: let _load raise, uncached

    def load(self, uri: str) -> Dataset:
        key = self._cache_key(uri)
        if key is not None:
            with self._lock:
                ds = self._cache.get(key)
                if ds is not None:
                    self._cache[key] = self._cache.pop(key)  # refresh LRU
                    return ds
        ds = self._load(uri)
        if key is not None:
            with self._lock:
                self._cache[key] = ds
                while len(self._cache) > self._CACHE_CAP:
                    self._cache.pop(next(iter(self._cache)))
        return ds

    def clear_cache(self) -> None:
        with self._lock:
            self._cache.clear()

    def _load(self, uri: str) -> Dataset:
        if uri.startswith("synthetic://"):
            parsed = urllib.parse.urlparse(uri)
            q = {k: int(v[0]) if v[0].lstrip("-").isdigit() else float(v[0])
                 for k, v in urllib.parse.parse_qs(parsed.query).items()}
            if parsed.netloc == "images":
                return synthetic_images(**{k: q[k] for k in q if k in
                                           ("classes", "w", "h", "c", "n", "seed", "noise", "dist", "flip")})
            raise ValueError(f"Unknown or unported synthetic dataset: {parsed.netloc!r}")
        path = _resolve_path(uri)
        if path.endswith(".npz"):
            return _load_npz_images(path)
        raise ValueError(f"rafiki_tpu_torch loads synthetic:// and .npz datasets; "
                         f"not {uri!r}")


dataset_utils = DatasetUtils()
