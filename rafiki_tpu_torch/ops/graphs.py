"""Captured CUDA graphs of a step: the port's counterpart of ``jax.jit``.

The JAX package compiles a trial's step, and the ``lax.scan`` of an
epoch over it, into one XLA program (``rafiki_tpu/ops/train.py``
``Program``). Eager PyTorch launches each of the step's ~1,000 kernels
from Python instead, so the host sets the step's speed. A CUDA graph
records those launches once and replays them with one host call.

:class:`StepRunner` runs a step body over the steps of an epoch:

  * on the CPU, every step eagerly: the plain version;
  * on the card, on a side stream of the calling thread, the first
    ``GRAPH_WARMUP_STEPS`` steps eagerly (they are the trial's own
    steps, and they make the lazy state a capture cannot: Adam's
    moments, cuBLAS's and cuDNN's workspaces for the stream, the
    autograd engine's thread), then one capture of the body, then one
    replay for each remaining step. An epoch of at most
    ``GRAPH_WARMUP_STEPS`` steps runs them all eagerly;
  * with ``eager=True`` (a dp epoch, whose step holds an NCCL
    all-reduce: ``ops/train.py``), every step eagerly on that same
    side stream, with no capture.

The body reads only device tensors that stay where they are for the
whole epoch: the params and moments (updated in place), the dataset,
and static "slots" that ``prepare(t)`` fills before step ``t`` (the
step's row of per-step scalars, its batch or batch indices). Its
outputs are copied out by ``collect(t, outputs)`` before the next step
overwrites them. The same body serves eager and captured steps, so both
run the same ops on the same operands and give the same bits.

Dropout generators are registered with the graph
(``CUDAGraph.register_generator_state``): each replay advances a
generator's offset as the eager step does, so its state after an epoch
is the eager state, which checkpoints carry.

The graph, its private memory pool and its output tensors live until
:meth:`StepRunner.run` returns, at the end of the epoch: nothing of a capture
outlives the epoch that made it, so a restored checkpoint, an evicted
or admitted pack member or a trial at another batch size never meets a
graph that reads other tensors. Capture runs in thread-local error mode
(predictor threads may launch forwards meanwhile) and never on the
legacy default stream. A failed capture or replay raises; nothing falls
back to eager steps on the card.

Several threads may train on one card (the mesh sweep's chips share a
device: ``scheduler/mesh.py``). Thread-local capture mode does not stop
another thread's device-wide synchronize or allocator release from
reaching a capture in progress, so an epoch on the card holds the
card's process-wide :func:`device_lock` from its first step to its
last, and so does every other device-wide synchronize of the training
path (``model/base.py _to_host``): the epochs of two threads on one
card run one after the other, each with its own capture and replays.
A template's own hooks may synchronize the card too, so the worker and
the mesh's sharded lane call ``evaluate``, ``dump_parameters`` and
``destroy`` under :func:`card_lock`.

Telemetry: ``train.graph_captures`` and ``train.graph_replays``
(counters), ``train.graph_capture_s`` (histogram: the host seconds of a
capture, instantiation included) and ``train.graph_pool_bytes``
(histogram: device memory the capture reserved).
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Any, Callable, ContextManager, Dict, Optional, Sequence

import torch

from rafiki_tpu_torch import telemetry

#: Eager steps before the capture, on the capture's stream.
GRAPH_WARMUP_STEPS = 2

_local = threading.local()

_device_locks: Dict[int, "threading.RLock"] = {}
_device_locks_guard = threading.Lock()


def device_lock(device: torch.device) -> "threading.RLock":
    """The process-wide (re-entrant) lock of one card (module doc)."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    with _device_locks_guard:
        return _device_locks.setdefault(index, threading.RLock())


def card_lock(model: Any) -> ContextManager[Any]:
    """:func:`device_lock` of the card ``model`` lives on (its
    ``device``), or no lock for a model off the card (module doc)."""
    device = getattr(model, "device", None)
    if isinstance(device, torch.device) and device.type == "cuda":
        return device_lock(device)
    return contextlib.nullcontext()


def _side_stream(device: torch.device) -> "torch.cuda.Stream":
    """The calling thread's capture stream on ``device``. One per thread
    and device for the process's life: cuBLAS keeps a workspace for each
    (thread's handle, stream) pair, so a new stream per trial would leave
    a workspace behind for each."""
    streams = _local.__dict__.setdefault("streams", {})
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in streams:
        streams[index] = torch.cuda.Stream(device=index)
    return streams[index]


Outputs = Dict[str, torch.Tensor]


class StepRunner:
    """One epoch's steps of ``body`` (module doc).

    ``prepare(t)`` fills the body's slots for step ``t``; ``body()`` runs
    one step and returns its outputs; ``collect(t, outputs)`` copies them
    out. ``generators`` are the CUDA generators the body draws from.
    After :meth:`run`, ``calls`` is how many times the Python body ran
    (eager steps plus the capture), so the caller can move host-side
    step counts on by the steps it did not run in Python, and
    ``replays`` how many steps replayed the captured graph. ``eager``
    runs every step eagerly on the card too (module doc)."""

    def __init__(self, device: torch.device, n_steps: int, body: Callable[[], Outputs],
                 prepare: Callable[[int], None], collect: Callable[[int, Outputs], None],
                 generators: Sequence[torch.Generator] = (), eager: bool = False):
        self.device = device
        self.eager = eager
        self.n_steps = n_steps
        self.body, self.prepare, self.collect = body, prepare, collect
        self.generators = [g for g in generators if g is not None]
        self.calls = 0
        self.replays = 0
        self._graph = None
        self._outputs: Optional[Outputs] = None

    def run(self) -> None:
        """Run the epoch's steps."""
        if self.device.type != "cuda":
            for t in range(self.n_steps):
                self.prepare(t)
                self.collect(t, self.body())
                self.calls += 1
            return
        with device_lock(self.device):
            self._run_on_card()

    def _run_on_card(self) -> None:
        stream = _side_stream(self.device)
        current = torch.cuda.current_stream(self.device)
        stream.wait_stream(current)
        replays = 0
        try:
            with torch.cuda.stream(stream):
                for t in range(self.n_steps):
                    self.prepare(t)
                    if self.eager or t < GRAPH_WARMUP_STEPS:
                        self.collect(t, self.body())
                        self.calls += 1
                        continue
                    if self._graph is None:
                        self._capture()
                    self._graph.replay()
                    replays += 1
                    self.collect(t, self._outputs)
        finally:
            current.wait_stream(stream)
            self._graph = self._outputs = None
            self.replays = replays
            if replays:
                telemetry.inc("train.graph_replays", replays)

    def _capture(self) -> None:
        t0 = time.monotonic()
        reserved = torch.cuda.memory_reserved(self.device)
        graph = torch.cuda.CUDAGraph()
        for g in self.generators:
            graph.register_generator_state(g)
        graph.capture_begin(capture_error_mode="thread_local")
        try:
            outputs = self.body()
        except BaseException:
            try:
                graph.capture_end()
            except RuntimeError:
                pass  # the body's error is the one to report
            raise
        graph.capture_end()
        self.calls += 1
        self._graph, self._outputs = graph, outputs
        telemetry.inc("train.graph_captures")
        telemetry.observe("train.graph_capture_s", time.monotonic() - t0)
        telemetry.observe("train.graph_pool_bytes",
                          float(torch.cuda.memory_reserved(self.device) - reserved))
