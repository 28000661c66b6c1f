"""Stacked serving adapter: k same-architecture trials behind one
``predict()``.

Counterpart of ``rafiki_tpu/parallel/serving.py``. When an inference
job's top-k trials share an architecture they are served as ONE
InferenceWorker wrapping this adapter: a single vmapped forward per
query batch instead of k workers each doing its own device round-trip.
Heterogeneous top-k falls back to one worker per trial.

On the card the adapter's forward is a captured CUDA graph, the
counterpart of the JAX package's jitted forward: the eager vmapped
forward launches a kernel per operator and member from Python, so the
host, not the card, set its time, and threads serving beside it (HTTP
handlers, the gateway) slowed it further. The first chunk captures the
forward at the serving shape (``batch_size`` rows: every chunk is
padded to it), under the card's lock (``ops/graphs.py``); each chunk
after it copies into the graph's input and replays. The graph lives as
long as the adapter.

With ``devices=`` the ensemble splits into member groups
(``parallel/ensemble.py``), as the JAX package's adapter shards its
forward over a "model" mesh axis (``rafiki_tpu/parallel/serving.py:27-42``).
On the card each group's forward is its own graph, captured and replayed
on its own card's serving thread; the groups of one chunk are submitted
together, so groups on different cards run side by side, and two groups
on one card run one after the other on its thread. The services manager
passes no devices, as the JAX package's does.

Every capture and replay on a card runs on the card's one serving
thread and one stream. A captured cuBLAS call keeps the workspace of
the (handle, stream) pair that captured it, and cuBLAS keeps one such
workspace for each pair for the process's life: captures on the
callers' threads (a job's worker, an HTTP handler) would each add one,
and graphs captured on one thread's handle would share one when they
replay at once. One thread makes one workspace, and replays one graph
at a time.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from rafiki_tpu_torch import telemetry
from rafiki_tpu_torch.ops.graphs import GRAPH_WARMUP_STEPS, device_lock
from rafiki_tpu_torch.parallel.ensemble import StackedEnsemble, ensemble_mean

_card_threads: Dict[int, ThreadPoolExecutor] = {}
_card_threads_guard = threading.Lock()
_card_streams: Dict[int, "torch.cuda.Stream"] = {}


def _card_thread(device: torch.device) -> ThreadPoolExecutor:
    """The card's serving thread (module doc)."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    with _card_threads_guard:
        if index not in _card_threads:
            _card_threads[index] = ThreadPoolExecutor(1, thread_name_prefix=f"serving-cuda{index}")
        return _card_threads[index]


class StackedTrialModel:
    """Implements the slice of the model contract InferenceWorker uses
    (``predict``/``destroy``), fusing k loaded same-arch TorchModels.
    ``devices`` splits the stacked forward into member groups on them
    (module doc)."""

    def __init__(self, models: List[Any], devices: Optional[Sequence] = None,
                 batch_size: int = 64):
        if not models:
            raise ValueError("Need at least one model to stack")
        first = models[0]
        if any(m._arch != first._arch for m in models):
            raise ValueError("Models disagree on architecture; cannot stack")
        if any(m.device != first.device for m in models):
            raise ValueError("Models live on different devices; cannot stack")
        self.batch_size = int(batch_size)
        self.device = first.device
        self._first = first
        self._ens = StackedEnsemble([m._module for m in models], devices=devices)
        # Each group's captured forward and its static tensors.
        n = len(self._ens.groups)
        self._graphs: List[Any] = [None] * n
        self._static_x: List[Any] = [None] * n
        self._static_out: List[Any] = [None] * n
        # The stacked copy is the serving copy: drop the per-model
        # modules (all but the first, which predict() still uses for
        # preprocess and the architecture).
        for m in models[1:]:
            m.destroy()

    def predict(self, queries: List[Any]) -> List[List[float]]:
        x = self._first.preprocess(
            np.asarray(queries, dtype=self._first._input_dtype()))
        return self.predict_proba(x).tolist()

    def predict_proba(self, x: np.ndarray) -> np.ndarray:
        """Fixed-size chunks, the last one padded with ZEROS (as the JAX
        package's adapter does), so the device sees one shape."""
        bs = self.batch_size
        on_card = self._ens.groups[0][0].type == "cuda"
        out = []
        for start in range(0, len(x), bs):
            chunk = x[start:start + bs]
            valid = len(chunk)
            if valid < bs:
                pad = np.zeros((bs - valid,) + chunk.shape[1:], chunk.dtype)
                chunk = np.concatenate([chunk, pad])
            if not on_card:
                xt = torch.from_numpy(np.ascontiguousarray(chunk)).to(self.device)
                out.append(self._ens.ensemble_proba(xt)[:valid])
                continue
            futures = [_card_thread(device).submit(self._replay, g, chunk)
                       for g, (device, _) in enumerate(self._ens.groups)]
            probs = np.concatenate([f.result() for f in futures])
            telemetry.inc("serving.graph_replays", len(futures))
            out.append(ensemble_mean(probs)[:valid])
        return np.concatenate(out) if out else np.zeros((0, 0))

    def _replay(self, g: int, chunk: np.ndarray) -> np.ndarray:
        """On the group's card's serving thread: one chunk through group
        ``g``'s captured forward, captured first if it is not yet
        (module doc)."""
        device = self._ens.groups[g][0]
        with torch.inference_mode():
            xt = torch.from_numpy(np.ascontiguousarray(chunk)).to(device)
            if self._graphs[g] is None:
                self._capture(g, xt)
            self._static_x[g].copy_(xt)
            self._graphs[g].replay()
            return self._static_out[g].cpu().numpy()

    def _capture(self, g: int, x: torch.Tensor) -> None:
        """Capture group ``g``'s forward at ``x``'s shape, on its card's
        serving thread (module doc)."""
        t0 = time.monotonic()
        device = self._ens.groups[g][0]
        index = device.index if device.index is not None else torch.cuda.current_device()
        with device_lock(device):
            if index not in _card_streams:
                _card_streams[index] = torch.cuda.Stream(device=index)
            stream = _card_streams[index]
            current = torch.cuda.current_stream(device)
            stream.wait_stream(current)
            static_x = x.clone()
            try:
                with torch.cuda.stream(stream):
                    for _ in range(GRAPH_WARMUP_STEPS):
                        self._ens.group_forward(g, static_x)
                    graph = torch.cuda.CUDAGraph()
                    graph.capture_begin(capture_error_mode="thread_local")
                    try:
                        static_out = self._ens.group_forward(g, static_x)
                    except BaseException:
                        try:
                            graph.capture_end()
                        except RuntimeError:
                            pass  # the forward's error is the one to report
                        raise
                    graph.capture_end()
            finally:
                current.wait_stream(stream)
        self._graphs[g], self._static_x[g], self._static_out[g] = graph, static_x, static_out
        telemetry.inc("serving.graph_captures")
        telemetry.observe("serving.graph_capture_s", time.monotonic() - t0)

    def warmup(self) -> float:
        """Pay the first-call costs (cuDNN's algorithm choice, the CUDA
        context, allocator growth and, on the card, each group's forward
        capture) at SERVICE CREATION, not on the first live request: one
        forward over a zero batch of the serving shape. Returns the
        warmup wall seconds."""
        t0 = time.monotonic()
        input_shape = tuple(self._first._arch[1])
        x = self._first.preprocess(
            np.zeros((self.batch_size,) + input_shape,
                     self._first._input_dtype()))
        self.predict_proba(x)
        return time.monotonic() - t0

    def destroy(self) -> None:
        self._first.destroy()
        self._ens = None
        self._graphs = self._static_x = self._static_out = []


def _param_shape_tree(model) -> Dict[str, Tuple[tuple, str]]:
    return {k: (tuple(v.shape), str(v.dtype))
            for k, v in model._module.state_dict().items()}


def build_stacked(trials: List[dict], models: List[Any],
                  devices: Optional[Sequence] = None,
                  batch_size: int = 64,
                  ) -> Tuple[Optional[StackedTrialModel], str]:
    """Return ``(stacked adapter, reason)``: the adapter when every
    trial is stackable (reason ``"stacked"``), else ``(None, why)``.
    ``devices`` splits its forward into member groups (module doc).

    Stackable = same model template, a TorchModel-style loaded instance
    (a live ``_module``), and IDENTICAL parameter shapes and dtypes.
    Dropout-rate differences vanish at serve time, so serving through
    the first model's architecture is exact for all k.
    """
    if len(models) < 2:
        return None, "single-trial"
    if len({t.get("model_name") for t in trials}) != 1:
        return None, "mixed-templates"
    if not all(getattr(m, "_module", None) is not None for m in models):
        return None, "not-torch-loaded"
    try:
        shapes0 = _param_shape_tree(models[0])
        if any(_param_shape_tree(m) != shapes0 for m in models[1:]):
            return None, "param-shape-mismatch"
        return (StackedTrialModel(models, devices=devices, batch_size=batch_size),
                "stacked")
    except Exception as e:  # any mismatch → caller falls back to per-trial
        return None, f"build-error: {type(e).__name__}"


def try_build_stacked(trials: List[dict], models: List[Any],
                      devices: Optional[Sequence] = None,
                      batch_size: int = 64) -> Optional[StackedTrialModel]:
    """Back-compat wrapper over :func:`build_stacked` (adapter only)."""
    return build_stacked(trials, models, devices=devices, batch_size=batch_size)[0]
