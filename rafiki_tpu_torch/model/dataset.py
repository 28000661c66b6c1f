"""Dataset utilities: URI-addressed datasets and fixed-shape batching.

The port's own copy of ``rafiki_tpu/model/dataset.py`` (numpy only):
``Dataset`` with ``batches`` and ``split``; the synthetic generators
``synthetic_images``, ``synthetic_corpus`` (token-tag sequences with a
mask) and ``synthetic_text`` (fixed-length sequences, one label each);
the reference's on-disk formats, a zip of image files with
``images.csv`` (Pillow, imported only when such a zip is read), a zip of
a TSV corpus (``corpus_token_id`` hashes its tokens) and ``.npz`` files
of either kind; and the ``dataset_utils`` front door with its
process-wide LRU cache and ``save_npz``. The same URI gives the same
arrays, byte for byte, as the JAX package's loader.

URI schemes:
  synthetic://images?classes=10&w=28&h=28&c=1&n=2048&seed=0
  synthetic://corpus?vocab=200&tags=10&n=512&len=24&seed=0
  synthetic://text?vocab=80&classes=5&n=256&len=16&seed=0
  /path/to/dataset.zip        (zip of images + images.csv, or of a .tsv corpus)
  /path/to/dataset.npz        (npz with arrays x, y[, mask])
  file:///path/to/dataset.zip
"""

from __future__ import annotations

import csv
import io
import json
import os
import threading
import urllib.parse
import zipfile
from dataclasses import dataclass, field
from typing import Iterator, List, Optional, Tuple

import numpy as np


@dataclass
class Dataset:
    """An in-memory dataset of (x, y) numpy arrays.

    For images: x is (N, H, W, C) float32 in [0, 1], y is (N,) int32.
    For corpora: x is (N, L) int32 token ids, y is (N, L) int32 tag ids
    with -1 padding, plus ``mask`` (N, L) bool. For text: x is (N, L)
    int32 token ids, y is (N,) int32, no mask.
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


def synthetic_corpus(vocab=200, tags=10, n=512, length=24, seed=0, noise=0.05,
                     dist=0) -> Dataset:
    """Token sequences with a fixed random token->tag mapping (+ noise).

    A model that learns the per-token mapping reaches about
    ``1 - noise``. ``dist`` seeds the mapping, ``seed`` the draws. Each
    row has its own length (at least ``max(2, length // 2)``); past it
    tokens are 0, tags -1 and ``mask`` False.
    """
    tok2tag = (np.random.default_rng(dist)
               .integers(0, tags, size=vocab).astype(np.int32))
    rng = np.random.default_rng(seed + 1_000_003)
    x = rng.integers(1, vocab, size=(n, length)).astype(np.int32)  # 0 = pad
    y = tok2tag[x]
    flip = rng.uniform(size=y.shape) < noise
    y = np.where(flip, rng.integers(0, tags, size=y.shape), y).astype(np.int32)
    lens = rng.integers(max(2, length // 2), length + 1, size=n)
    mask = np.arange(length)[None, :] < lens[:, None]
    x = np.where(mask, x, 0).astype(np.int32)
    y = np.where(mask, y, -1).astype(np.int32)
    return Dataset(x, y, tags, mask=mask, meta={"kind": "corpus", "synthetic": True, "vocab": vocab})


def synthetic_text(vocab=80, classes=5, n=256, length=16, seed=0, noise=0.1,
                   dist=0) -> Dataset:
    """Fixed-length token sequences with one label per sequence.

    Token t (1-based) signals class ``(t - 1) % classes``; each sequence
    draws ``1 - noise`` of its positions from its own class's tokens and
    the rest uniformly. There is no mask, so the dataset rides the
    device-resident path. ``dist`` is accepted for URI symmetry and, as
    in the reference, seeds nothing.
    """
    rng = np.random.default_rng(seed + 1_000_003)
    y = rng.integers(0, classes, size=n).astype(np.int32)
    m = max(1, (vocab - 1) // classes)  # class tokens per class
    sig_tok = 1 + y[:, None] + classes * rng.integers(0, m, size=(n, length))
    noise_tok = rng.integers(1, vocab, size=(n, length))
    sig = rng.uniform(size=(n, length)) >= noise
    x = np.where(sig, sig_tok, noise_tok).astype(np.int32)
    return Dataset(x, y, classes,
                   meta={"kind": "text", "synthetic": True, "vocab": vocab})


def load_dataset_of_image_files(uri: str) -> Dataset:
    """The reference's image-zip format: image files plus ``images.csv``
    with header ``path,class``, each image scaled to [0, 1] (a
    grayscale image gets a channel axis). Pillow is imported here, so
    only a caller that reads such a zip needs it."""
    path = _resolve_path(uri)
    if path.endswith(".npz"):
        return _load_npz(path, kind="images")
    from PIL import Image

    xs: List[np.ndarray] = []
    ys: List[int] = []
    with zipfile.ZipFile(path) as zf:
        with zf.open("images.csv") as f:
            rows = list(csv.DictReader(io.TextIOWrapper(f, "utf-8")))
        for row in rows:
            with zf.open(row["path"]) as imf:
                arr = np.asarray(Image.open(imf), dtype=np.float32) / 255.0
            if arr.ndim == 2:
                arr = arr[:, :, None]
            xs.append(arr)
            ys.append(int(row["class"]))
    x = np.stack(xs)
    y = np.asarray(ys, dtype=np.int32)
    return Dataset(x, y, classes=int(y.max()) + 1, meta={"kind": "images", "uri": uri})


# Canonical corpus encoding: ids are functions of the text, not of one
# zip's order, so a train zip and a val zip loaded apart agree. Tokens
# are feature-hashed into a fixed table (unseen tokens get a consistent
# bucket), tags are numbered in sorted order, and every sentence is cut
# or padded to one length (one program for every zip).
CORPUS_HASH_VOCAB = 8192
CORPUS_MAX_LEN = 64


def corpus_token_id(token: str) -> int:
    """Stable token id in [1, CORPUS_HASH_VOCAB): a blake2b feature hash
    (0 is the padding id). The corpus loader applies the same mapping,
    so predict() queries built from raw tokens with it match."""
    import hashlib

    h = int.from_bytes(hashlib.blake2b(token.encode("utf-8"), digest_size=8).digest(), "big")
    return 1 + h % (CORPUS_HASH_VOCAB - 1)


def load_dataset_of_corpus(uri: str, tag_col: str = "tag") -> Dataset:
    """The reference's corpus-zip format: a ``.tsv`` of token/tag rows
    with blank lines between sentences, encoded canonically (above)."""
    path = _resolve_path(uri)
    if path.endswith(".npz"):
        return _load_npz(path, kind="corpus")
    sents: List[List[Tuple[str, str]]] = []
    with zipfile.ZipFile(path) as zf:
        name = next(n for n in zf.namelist() if n.endswith(".tsv"))
        with zf.open(name) as f:
            cur: List[Tuple[str, str]] = []
            for line in io.TextIOWrapper(f, "utf-8"):
                line = line.rstrip("\n")
                if not line:
                    if cur:
                        sents.append(cur)
                        cur = []
                    continue
                tok, tag = line.split("\t")[:2]
                cur.append((tok, tag))
            if cur:
                sents.append(cur)
    tagset = {t: i for i, t in enumerate(sorted({tag for s in sents for _, tag in s}))}
    length = CORPUS_MAX_LEN
    n = len(sents)
    x = np.zeros((n, length), dtype=np.int32)
    y = np.full((n, length), -1, dtype=np.int32)
    mask = np.zeros((n, length), dtype=bool)
    for i, s in enumerate(sents):
        for j, (tok, tag) in enumerate(s[:length]):
            x[i, j] = corpus_token_id(tok)
            y[i, j] = tagset[tag]
            mask[i, j] = True
    return Dataset(x, y, classes=len(tagset), mask=mask,
                   meta={"kind": "corpus", "uri": uri,
                         "vocab": CORPUS_HASH_VOCAB, "tag_map": tagset})


def _load_npz(path: str, kind: str) -> Dataset:
    with np.load(path, allow_pickle=False) as z:
        x = z["x"]
        y = z["y"].astype(np.int32)
        mask = z["mask"] if "mask" in z else None
        saved_meta = (json.loads(str(z["meta_json"]))
                      if "meta_json" in z else {})
    classes = int(y.max()) + 1 if kind == "images" else int(y[y >= 0].max()) + 1
    if saved_meta.get("classes"):
        classes = int(saved_meta.pop("classes"))
    if kind == "images" and x.dtype == np.uint8:
        x = x.astype(np.float32) / 255.0
    meta = {"kind": kind, "uri": path}
    if kind == "corpus":
        # Derived only when the npz carries no meta: a hashed corpus
        # saved by save_npz keeps its fixed table size.
        meta["vocab"] = int(x.max()) + 1
    meta.update(saved_meta)
    return Dataset(x, y, classes=classes, mask=mask, meta=meta)


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
            if parsed.netloc in ("corpus", "text"):
                kw = dict(q)
                if "len" in kw:
                    kw["length"] = kw.pop("len")
                if parsed.netloc == "corpus":
                    return synthetic_corpus(**{k: kw[k] for k in kw if k in
                                               ("vocab", "tags", "n", "length", "seed", "noise",
                                                "dist")})
                return synthetic_text(**{k: kw[k] for k in kw if k in
                                         ("vocab", "classes", "n", "length", "seed", "noise",
                                          "dist")})
            raise ValueError(f"Unknown synthetic dataset: {parsed.netloc!r}")
        path = _resolve_path(uri)
        if path.endswith(".npz"):
            with np.load(path, allow_pickle=False) as z:
                kind = "corpus" if ("mask" in z or z["x"].ndim == 2) else "images"
            return _load_npz(path, kind)
        # A zip: a .tsv inside makes it a corpus, else image files.
        with zipfile.ZipFile(path) as zf:
            names = zf.namelist()
        if any(n.endswith(".tsv") for n in names):
            return load_dataset_of_corpus(uri)
        return load_dataset_of_image_files(uri)

    load_dataset_of_image_files = staticmethod(load_dataset_of_image_files)
    load_dataset_of_corpus = staticmethod(load_dataset_of_corpus)

    @staticmethod
    def save_npz(dataset: Dataset, path: str) -> str:
        """Write ``dataset`` as an ``.npz`` the loaders read back: x, y,
        the mask if any, and the JSON-able meta (vocab size, tag map,
        class count) under ``meta_json``."""
        arrays = {"x": dataset.x, "y": dataset.y}
        if dataset.mask is not None:
            arrays["mask"] = dataset.mask
        portable = {k: v for k, v in dataset.meta.items()
                    if isinstance(v, (str, int, float, bool))}
        if isinstance(dataset.meta.get("tag_map"), dict):
            portable["tag_map"] = dataset.meta["tag_map"]
        portable["classes"] = dataset.classes
        arrays["meta_json"] = np.asarray(json.dumps(portable))
        np.savez_compressed(path, **arrays)
        return path


dataset_utils = DatasetUtils()
