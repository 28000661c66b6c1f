"""Training and forward programs of a trial: eager on the CPU, captured
CUDA graphs on the card.

Counterpart of ``rafiki_tpu/ops/train.py``:

  * ``cross_entropy_loss`` (``:60``), the traced-rate ``dropout``
    (``:82``) and ``effective_lr`` (``:150``);
  * the step closures of ``_make_step_fns`` (``:158``): the loss and its
    gradients, the chaos poison multiply, Adam's lr-free core
    (``ops/optim.py``), ``-effective_lr``, the update, and the health
    sentinel bundle, in that order;
  * ``Program`` (``:221``) with ``train_epoch`` (``:256``) and
    ``eval_epoch`` (``:278``), ``get_device_dataset`` (``:448``) and
    ``TrainLoop`` (``:467``): an epoch over a dataset resident on the
    device (batches gathered there with ``index_select``, in the same
    ``np.random.default_rng(epoch_seed)`` order), or batch by batch
    from the host with one batch of prefetch;
  * the process-wide program cache (``:329-417``): ``get_program``,
    ``program_cache_stats`` (also the telemetry collector
    ``program_cache``), ``clear_program_cache``, ``mesh_cache_key`` and
    ``packed_program_key`` (``:871``);
  * the serving half: ``predict`` (the float32 softmax, ``:210``),
    ``eval_step`` (the masked argmax-correct count, ``:199``) and
    ``predict_proba`` (``:763``), which pads the last chunk to a full
    batch by REPEATING ITS LAST ROW so the device sees one shape;
  * the standalone factories ``make_train_step``, ``make_eval_step``
    and ``make_predict_fn`` (``:1247-1274``).

Where the JAX package compiles a step with ``jit`` and an epoch as a
``lax.scan``, the port runs an epoch through ``ops/graphs.py
StepRunner``: on the card a few eager steps, then one captured CUDA
graph of the step replayed for the rest of the epoch; on the CPU every
step eagerly, the plain version. One step body serves all three. It
reads only device tensors: the hyper values the forward takes (the
dropout rate) are on the device, and the per-step scalars (``-lr``
after warmup, Adam's bias corrections) are computed on the host in
float32, as the JAX package's traced values are, one row per step of
the epoch, uploaded once per epoch; the step reads its row from a slot
filled before it runs. So trials differing only in ``DYNAMIC_KNOBS``
share one cached ``Program``, and a graph bakes no trial's value in.

Trial packing (``PackedProgram`` ``:800``, ``PackedTrainLoop`` ``:879``,
``PackedSliceLoop`` ``:1190``): k trials of one program train as one
stacked program. Their params, Adam moments, step counts, dropout
generators and hyper values are stacked along a leading trial axis; the
forward is ``torch.func.vmap`` over ``functional_call``, and the
gradients are plain autograd of the sum of the k losses with respect to
the stacked leaves (member i's loss reads only slice i, so slice i's
gradient is member i's own). Convolutions, dense layers and, where
autograd records, GroupNorm run once per member (``ops/layers.py``);
Adam's bias-corrected quotient, the learning rate and the sentinel
norms run once per member with the serial ops and scalars; each
member's dropout mask comes from its own generator
(:class:`PackedGenerators`); and on the card training selects cuDNN's
deterministic algorithms. So member i computes bit for bit what a
serial ``TrainLoop(seed_i, hyper_i)`` computes, on the CPU and on the
card, eager or captured. The packed step is captured as the serial one
is, at the pack's current width.

A cached ``Program`` holds the step closures of the trial that built
it, as the JAX package's does, but not its init draw: each loop draws
its own params from its own ``init_fn``. Graphs are not cached: each
epoch captures its own (``ops/graphs.py`` says why).

Each epoch's wall feeds the goodput ledger (a loop's first epoch as
``compile_s``, the others as ``step_s``, host feed as ``feed_s``), the
perf profiler (``note_epoch`` with the epoch's step count) and an SLO
tick, as the JAX package's do. A loop's first epoch asks the profiler
for a FLOP count of its program (``obs/perf/profiler.py
capture_cost``): the count wraps the first eager step of the epoch, so
it adds no step and never runs under a capture.

Chaos sites (``rafiki_tpu_torch/chaos``), as in the JAX package:
``train.epoch`` inside each epoch's timed region, keyed by the
program key, and ``train.nan``, keyed by the program key (a pack's
member i by ``f"{key}@m{i}"``), which poisons step ``n_steps // 2`` of
the epoch: the gradients of that step are multiplied by NaN before
Adam, through a poison column in the epoch's step table. The JAX
package keeps an all-ones column in every epoch, because XLA fuses a
runtime multiply into the reductions around it and a trace without it
would round otherwise. That does not hold for the port's steps, whose
graph is captured once an epoch and whose host knows the column before
the capture: the multiply runs only in an epoch whose column holds a
value other than 1, and a clean epoch keeps its kernels and time
(multiplying by 1 is exact, so the two are the same bits).

Each epoch hands the health monitor its batch indices, its poison
column and, when replay capsules are on, a copy of the pre-epoch state
taken on the device before the timer (``obs/health/capsule.py``).

Within-trial data parallelism (``_ShardingPlan`` ``:99``, ``TrainLoop(
mesh=...)``): a width-W trial is W processes of one ``torch.distributed``
group (``parallel/mesh.py``), each holding the whole replicated state on
its own device, or W replicas in one process (an in-process mesh, below).
As in the JAX package, an epoch under a mesh leaves the
device-resident path: each global batch is formed on the host from the
epoch's permutation, and each rank takes its rows ``[r*B/W, (r+1)*B/W)``
(``parallel/multihost.py global_put``). Each rank runs the step on its
slice; its gradients, loss and float metrics are summed over the group
with one ``all_reduce`` of a flat buffer and divided by W, before the
poison multiply, Adam and the sentinels, so every rank applies the same
update and the sentinels read the global gradient. Dropout draws the
whole global batch's mask from the trial's generator and keeps the
rank's rows (:class:`DpGenerator`), so a width-W trial uses the masks of
the width-1 trial. Eval is replicated: every rank scores the whole set.
A dp epoch runs its steps EAGERLY, on the card too: no NCCL collective
is captured in a CUDA graph (``StepRunner(eager=True)``). A failed
collective raises :class:`CollectiveError`, which no trial containment
swallows: the group fails and its scheduler respawns it. Each dp epoch
passes the ``collective.step`` chaos site, keyed ``p<rank>:<worker id>``.

An in-process mesh (``parallel/mesh.py LocalDataParallelMesh``, the JAX
package's one program over the k devices of one process) runs its k
replicas in lockstep on the trial's thread, which is the counterpart of
XLA's one program and needs no barrier: replica 0 is the trial's own
module and optimizer state on ``devices[0]``, replicas 1..k-1 copies of
them on their devices (made before the trial's first step, and again
whenever the trial's state was replaced, as by a restored checkpoint).
Each step,
replica r runs the forward and backward pass on its rows of the global
batch, with its rows of the global dropout noise, drawn once a step from
the trial's generator; the flat float32 gradients, loss and float
metrics are summed on ``devices[0]`` in replica order, divided by k and
copied back to every replica (the body splits there); then every
replica runs the poison multiply, Adam and the sentinels on the same
values, so the replicas stay equal bit for bit. The epoch runs eagerly,
passes ``collective.step`` once, keyed ``p0:<worker id>``, and holds the
``ops/graphs.py device_lock`` of each distinct card, in index order.
Eval, predictions, parameter dumps and checkpoints read replica 0.

``torch.inference_mode`` is thread-local, so :func:`predict_proba`
enters it itself, on whatever thread serves the query.
"""

from __future__ import annotations

import contextlib
import copy
import functools
import os
import threading
import time
from dataclasses import dataclass
from typing import (Any, Callable, ContextManager, Dict, Hashable, Iterator, List, Optional,
                    Sequence, Tuple)

import numpy as np
import torch
import torch._C._functorch as _functorch
from torch import nn
from torch._functorch.pyfunctorch import temporarily_pop_interpreter_stack
from torch.func import functional_call, vmap
from torch.profiler import record_function

from rafiki_tpu_torch import chaos as _chaos
from rafiki_tpu_torch import telemetry
from rafiki_tpu_torch.obs.health import DivergenceError, HealthMonitor
from rafiki_tpu_torch.obs.health import sentinel as _sentinel
from rafiki_tpu_torch.obs.ledger import ledger
from rafiki_tpu_torch.obs.perf import profiler, slo
from rafiki_tpu_torch.ops.graphs import StepRunner, device_lock
from rafiki_tpu_torch.ops.optim import (ScaleByAdamState, adam, map_members, member_opt_state,
                                        scale_by_adam)
from rafiki_tpu_torch.utils.backend import DeviceLike, resolve_device

Batch = Dict[str, torch.Tensor]
Hyper = Dict[str, torch.Tensor]
# (module, optimizer state, step count, dropout generator, hyper)
State = Tuple[nn.Module, Any, int, Optional[torch.Generator], Hyper]

# Knob names that reach the step only through the per-trial hyper dict
# (lr and warmup through the update scale, dropout through the forward)
# or not at all (epochs = the epoch count, seed = the init draw). Two
# trials that differ only in these run the same program, so they pack.
DYNAMIC_KNOBS = frozenset({"learning_rate", "warmup_steps", "dropout", "epochs", "seed"})


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       valid: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked softmax cross entropy and accuracy, in float32.

    logits: (..., C); labels: (...) integer, -1 = ignore; valid: optional
    (...) bool combined with the label mask. Returns (mean loss, mean
    accuracy) over the unmasked elements.
    """
    mask = labels >= 0
    if valid is not None:
        mask = mask & valid
    labels_safe = torch.where(mask, labels, 0).long()
    logits = logits.float()
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels_safe[..., None])[..., 0]
    denom = mask.sum().clamp_min(1)
    loss = torch.where(mask, nll, 0.0).sum() / denom
    correct = (logits.argmax(dim=-1) == labels_safe) & mask
    return loss, correct.sum() / denom


class PackedGenerators(tuple):
    """The dropout generators of a pack's k members, in slot order: what
    a pack's step passes where a serial step passes its one generator."""


@dataclass
class DpGenerator:
    """A dp replica's dropout stream: the trial's ``generator``, from
    which the noise of the whole global batch (``world_size`` times the
    replica's own rows along dim 0) is drawn, and rows ``[rank*b,
    (rank+1)*b)`` of it kept, so each replica's mask is its rows of the
    width-1 mask and the generator advances as the width-1 trial's does.

    A process rank (``draws`` None) draws the global noise itself from
    its own copy of the stream. The replicas of an in-process mesh share
    one generator and one step's ``draws``: replica 0 draws each global
    noise once and appends it, and replica r reads them back in the same
    order (its forward runs the same dropout calls after replica 0's)."""

    generator: torch.Generator
    rank: int
    world_size: int
    draws: Optional[List[torch.Tensor]] = None
    _read: int = 0

    def noise(self, x: torch.Tensor) -> torch.Tensor:
        """Uniform noise of ``x``'s shape: this replica's rows of the
        global draw, on ``x``'s device."""
        b = x.shape[0]
        if self.draws is not None and self.rank > 0:
            full = self.draws[self._read]
            self._read += 1
        else:
            full = torch.rand((b * self.world_size,) + tuple(x.shape[1:]),
                              generator=self.generator, device=x.device)
            if self.draws is not None:
                self.draws.append(full)
        return full[self.rank * b:(self.rank + 1) * b].to(x.device)


def _per_member_rand(x: torch.Tensor, generators: PackedGenerators) -> torch.Tensor:
    """Uniform noise for a pack's dropout: member i's draw comes from
    member i's generator, at member i's shape, as a serial step draws
    it. ``torch.rand`` inside vmap is refused (and ``randomness=
    "different"`` would draw other values), so the draws run with the
    vmap level popped and the stacked noise is wrapped back at it."""
    if not _functorch.is_batchedtensor(x):
        raise ValueError("a pack's dropout input must be batched over its members")
    level = _functorch.maybe_get_level(x)
    shape, device = tuple(x.shape), x.device
    with temporarily_pop_interpreter_stack():
        noise = torch.stack([torch.rand(shape, generator=g, device=device)
                             for g in generators])
    return _functorch._add_batch_dim(noise, 0, level)


def dropout(x: torch.Tensor, rate, generator: Optional[torch.Generator],
            deterministic: bool) -> torch.Tensor:
    """Inverted dropout whose rate is a tensor (or a number), so a sweep
    over the rate needs no other code path. Rate 1 gives zeros; the
    kept elements are scaled by ``1 / max(1 - rate, 1e-6)``. The random
    stream is ``generator``'s (on ``x``'s device); the JAX package's
    threefry stream cannot be matched, so parity is checked at rate 0.
    In a pack, ``generator`` is the members' :class:`PackedGenerators`;
    on a dp replica, a :class:`DpGenerator`. The train step passes the rate
    as a tensor on ``x``'s device, so a captured step reads it, not a
    value baked in at capture."""
    if deterministic or generator is None:
        return x
    rate = torch.as_tensor(rate, dtype=torch.float32)
    if isinstance(generator, PackedGenerators):
        noise = _per_member_rand(x, generator)
    elif isinstance(generator, DpGenerator):
        noise = generator.noise(x)
    else:
        noise = torch.rand(x.shape, generator=generator, device=x.device)
    keep = noise < (1.0 - rate)
    scale = torch.where(rate < 1.0, 1.0 / torch.clamp_min(1.0 - rate, 1e-6),
                        torch.zeros_like(rate))
    return torch.where(keep, x * scale.to(x.dtype), torch.zeros_like(x))


def effective_lr(hyper: Hyper, step_i) -> torch.Tensor:
    """Linear warmup to ``hyper["lr"]`` over ``hyper["warmup"]`` steps,
    in float32: ``lr * min((step + 1) / max(warmup, 1), 1)``. ``step_i``
    may be a tensor of steps (elementwise, the same arithmetic)."""
    warmup = torch.clamp_min(torch.as_tensor(hyper.get("warmup", 1.0), dtype=torch.float32), 1.0)
    step = torch.as_tensor(step_i).to(torch.float32)
    frac = torch.clamp_max((step + 1.0) / warmup, 1.0)
    return torch.as_tensor(hyper["lr"], dtype=torch.float32) * frac


def _neg_lr(hyper: Hyper, step_i: int, n: int) -> np.ndarray:
    """``-effective_lr`` of the ``n`` steps from ``step_i``, float32."""
    return (-effective_lr(hyper, torch.arange(step_i, step_i + n))).numpy()


def _count_correct(logits: torch.Tensor, y: torch.Tensor,
                   valid: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    mask = y >= 0
    if valid is not None:
        mask = mask & valid.reshape(valid.shape + (1,) * (mask.dim() - valid.dim())).bool()
    labels_safe = torch.where(mask, y, torch.zeros_like(y))
    correct = (logits.argmax(dim=-1) == labels_safe) & mask
    return correct.sum(), mask.sum()


def _deterministic_convs(device: torch.device) -> None:
    """Train on the card with cuDNN's deterministic algorithms. Without
    them a pack member's conv backward, on the serial step's shapes and
    inputs, need not give the serial step's bits, and a member must be
    its serial trial bit for bit (a killed pack's members resume
    serially from their checkpoints). Process-wide and never undone, so
    every trial of the process runs the same algorithms."""
    if device.type == "cuda":
        torch.backends.cudnn.deterministic = True


def _on(tensors: Dict[str, torch.Tensor], device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: v.to(device) for k, v in tensors.items()}


def _compute_dtype(module: nn.Module) -> torch.dtype:
    """The dtype a template's module computes in (its ``dtype``, as the
    zoo's modules carry it), else its parameters'."""
    dtype = getattr(module, "dtype", None)
    if isinstance(dtype, torch.dtype):
        return dtype
    return next(module.parameters()).dtype


def _module_device(module: nn.Module) -> torch.device:
    return next(module.parameters()).device


class CollectiveError(RuntimeError):
    """A collective of a dp step failed (a peer died, the group timed
    out). It fails the group, not a trial: the worker lets it through
    its trial containment and exits, and the scheduler respawns the
    whole group."""


@dataclass
class _ShardingPlan:
    """How a trial's steps see its dp mesh (module doc): ``mesh`` None is
    the single-device trial, whose plan does nothing. Under an in-process
    mesh the plan holds replicas 1..k-1 (``replicas``: a module and an
    optimizer state each, on its device); replica 0 is the trial's own
    state."""

    mesh: Optional[Any] = None
    replicas: Optional[List[Tuple[nn.Module, Any]]] = None
    _mirrors: Optional[Tuple[nn.Module, int]] = None

    @property
    def in_process(self) -> bool:
        return bool(getattr(self.mesh, "in_process", False))

    def put_batch(self, batch: Dict[str, np.ndarray], device: torch.device):
        """A host batch on ``device``: the whole of it, or under a mesh
        this rank's rows of it (an in-process mesh: each replica's rows
        on its device, in replica order)."""
        if self.mesh is None:
            return _put_batch(batch, device)
        from rafiki_tpu_torch.parallel import multihost

        if self.in_process:
            return multihost.replica_put(batch, self.mesh)
        return multihost.global_put(batch, self.mesh)

    def generator(self, generator: Optional[torch.Generator]):
        """The dropout stream a process rank's loss draws from."""
        if self.mesh is None or generator is None:
            return generator
        return DpGenerator(generator, self.mesh.rank, self.mesh.world_size)

    def reduce(self, tensors: List[torch.Tensor]) -> List[torch.Tensor]:
        """Each tensor replaced, in place, by its mean over the mesh's
        ranks: one ``all_reduce`` (sum) of their float32 concatenation,
        divided by the world size and copied back. Over one rank the sum
        and the division by 1 change no bit, and the tensors keep their
        own storage, so what reads them next runs as without a mesh."""
        if self.mesh is None:
            return tensors
        import torch.distributed as dist

        flat = torch.cat([t.reshape(-1).float() for t in tensors])
        try:
            dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=self.mesh.group)
        except Exception as e:
            raise CollectiveError(f"dp all_reduce over {self.mesh.world_size} ranks failed "
                                  f"on rank {self.mesh.rank}: {e}") from e
        flat.div_(self.mesh.world_size)
        _unflatten(flat, tensors)
        return tensors

    def reduce_replicas(self, per_replica: List[List[torch.Tensor]]) -> None:
        """The in-process all-reduce: each replica's tensors replaced, in
        place, by their mean over the replicas. The float32
        concatenations are summed on ``devices[0]`` in replica order,
        divided by k and copied back to every replica, so every replica
        reads the same bits (two ranks of a gloo group sum the same two
        buffers, and a sum of two is the same in either order)."""
        devices = self.mesh.devices
        flats = [torch.cat([t.reshape(-1).float() for t in ts]) for ts in per_replica]
        total = flats[0]
        for f in flats[1:]:
            total.add_(f.to(devices[0]))
        total.div_(len(flats))
        for ts, device in zip(per_replica, devices):
            _unflatten(total.to(device), ts)

    def sync(self, module: nn.Module, opt_state, step: int) -> None:
        """Make replicas 1..k-1 copies of replica 0's module and optimizer
        state, unless they already mirror it: the replicas stay equal
        bit for bit from step to step, and the copy makes a state the
        trial was given (a restored checkpoint) every replica's."""
        if self._mirrors is not None and self._mirrors[0] is module and \
                self._mirrors[1] == step:
            return
        self.replicas = [
            (copy.deepcopy(module).to(device),
             map_members(opt_state, lambda t, d=device: t.to(d, copy=True), lambda c: c))
            for device in self.mesh.devices[1:]]
        self._mirrors = (module, step)

    def mirrored(self, module: nn.Module, step: int) -> None:
        """The replicas stepped in lockstep with replica 0 to ``step``."""
        self._mirrors = (module, step)

    def card_locks(self) -> ContextManager[Any]:
        """Under an in-process mesh, the ``ops/graphs.py device_lock`` of
        each distinct card of its devices, taken in index order (the
        epoch's StepRunner re-enters replica 0's): two workers whose sets
        share cards cannot each hold one the other waits for."""
        stack = contextlib.ExitStack()
        if self.in_process:
            cards = sorted({d.index for d in self.mesh.devices if d.type == "cuda"})
            for index in cards:
                stack.enter_context(device_lock(torch.device("cuda", index)))
        return stack

    def lockstep(self, grads_of, apply_update, module: nn.Module, opt_state, generator,
                 hyper: Hyper, scalars: torch.Tensor, batches: List[Batch],
                 poisoned: bool) -> Tuple[Any, Dict[str, torch.Tensor]]:
        """One step of an in-process mesh, the replicas in lockstep on this
        thread: each replica's forward and backward on its rows and its
        device, with its rows of the step's global dropout noise; the
        reduce; then each replica's update from the same mean gradients,
        as each device of the JAX package's mesh updates its replicated
        state. Returns replica 0's optimizer state and outputs."""
        devices = self.mesh.devices
        modules = [module] + [m for m, _ in self.replicas]
        opts = [opt_state] + [o for _, o in self.replicas]
        draws: List[torch.Tensor] = []
        parts = []
        for r, (m, device) in enumerate(zip(modules, devices)):
            gen = None if generator is None else DpGenerator(generator, r, len(devices), draws)
            parts.append(grads_of(m, gen, _on(hyper, device), batches[r]))
        with torch.no_grad(), record_function("train.all_reduce"):
            self.reduce_replicas([[loss] + _float_metrics(metrics) + grads
                                  for loss, metrics, grads in parts])
        outs = []
        for r, (m, device) in enumerate(zip(modules, devices)):
            opts[r], out = apply_update(m, opts[r], _on(hyper, device), scalars.to(device),
                                        *parts[r], poisoned)
            outs.append(out)
        self.replicas = list(zip(modules[1:], opts[1:]))
        return opts[0], outs[0]


def _unflatten(flat: torch.Tensor, tensors: List[torch.Tensor]) -> None:
    """Copy consecutive pieces of ``flat`` back into ``tensors``."""
    at = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[at:at + n].reshape(t.shape))
        at += n


def _float_metrics(metrics: Dict[str, torch.Tensor]) -> List[torch.Tensor]:
    return [v for v in metrics.values() if v.is_floating_point()]


#: The plan of a trial with no mesh.
_NO_MESH = _ShardingPlan()


def _make_step_fns(apply_fn, loss_fn, optimizer, dynamic_lr: bool = True):
    """The single-trial step closures: (train_body, eval_step).

    ``apply_fn(module, batch) -> logits`` (eval mode);
    ``loss_fn(module, batch, generator, hyper) -> (loss, metrics)``.
    ``train_body(module, opt_state, generator, hyper, scalars, batch,
    poisoned, plan)`` runs one step in place and returns ``(opt_state,
    metrics)``. It splits at the reduce: the loss and its gradients
    (``grads_of``), then the update (``apply_update``). Under a process
    mesh the loss, float metrics and gradients are averaged over the
    group (:meth:`_ShardingPlan.reduce`) between the two; under an
    in-process mesh ``batch`` is the replicas' batches, and the plan runs
    both halves for each replica around its reduce
    (:meth:`_ShardingPlan.lockstep`). ``scalars`` is the step's row of
    :func:`_step_table` on the device: ``-effective_lr`` first when the step scales by it
    (``dynamic_lr`` and an ``lr`` in ``hyper``; else the optimizer is
    complete, from ``make_optimizer``, and its updates apply as they
    are), then the optimizer's own per-step scalars, then, when
    ``poisoned``, the step's chaos poison multiplier, by which the
    gradients are multiplied before Adam (and before the sentinels
    read them).
    """

    def grads_of(module: nn.Module, generator, hyper: Hyper, batch: Batch):
        with torch.enable_grad():
            with record_function("train.forward"):
                loss, metrics = loss_fn(module, batch, generator, hyper)
            grads = list(torch.autograd.grad(loss, list(module.parameters())))
        return loss, metrics, grads

    def apply_update(module: nn.Module, opt_state, hyper: Hyper, scalars: torch.Tensor,
                     loss: torch.Tensor, metrics: Dict[str, torch.Tensor],
                     grads: List[torch.Tensor], poisoned: bool
                     ) -> Tuple[Any, Dict[str, torch.Tensor]]:
        params = list(module.parameters())
        scale = dynamic_lr and "lr" in hyper
        opt_scalars = scalars[1:] if scale else scalars
        if poisoned:
            opt_scalars = opt_scalars[:-1]
        with torch.no_grad():
            if poisoned:
                torch._foreach_mul_(grads, scalars[-1])
            with record_function("train.adam"):
                updates, opt_state = optimizer.update(grads, opt_state, opt_scalars)
                if scale:
                    torch._foreach_mul_(updates, scalars[0])
                torch._foreach_add_(params, updates)
            # The sentinels read the step's tensors; they never touch the
            # dropout stream or the update arithmetic.
            with record_function("train.sentinel"):
                loss = loss.detach()
                health = _sentinel.bundle(loss, grads, updates, params)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return opt_state, dict(metrics, loss=loss, **health)

    def train_body(module: nn.Module, opt_state, generator, hyper: Hyper,
                   scalars: torch.Tensor, batch, poisoned: bool = False,
                   plan: _ShardingPlan = _NO_MESH) -> Tuple[Any, Dict[str, torch.Tensor]]:
        if plan.in_process:
            return plan.lockstep(grads_of, apply_update, module, opt_state, generator, hyper,
                                 scalars, batch, poisoned)
        loss, metrics, grads = grads_of(module, plan.generator(generator), hyper, batch)
        if plan.mesh is not None:
            with torch.no_grad(), record_function("train.all_reduce"):
                plan.reduce([loss] + _float_metrics(metrics) + grads)
        return apply_update(module, opt_state, hyper, scalars, loss, metrics, grads, poisoned)

    def eval_step(module: nn.Module, batch: Batch) -> Tuple[torch.Tensor, torch.Tensor]:
        return _count_correct(apply_fn(module, batch), batch["y"], batch.get("valid"))

    return train_body, eval_step


def _step_table(optimizer, opt_state, hyper: Hyper, step_i: int, n: int,
                scale: bool, poison: Optional[np.ndarray] = None) -> np.ndarray:
    """``(n, m)`` float32: each of the ``n`` steps from ``step_i``, its
    ``-effective_lr`` (when ``scale``), the optimizer's scalars and, with
    ``poison`` (the epoch's ``(n,)`` chaos column), its poison multiplier."""
    table = optimizer.step_scalars(opt_state, n)
    if scale:
        table = np.concatenate([_neg_lr(hyper, step_i, n)[:, None], table], axis=1)
    if poison is not None:
        table = np.concatenate([table, np.asarray(poison, np.float32).reshape(n, 1)], axis=1)
    return np.ascontiguousarray(table, np.float32)


def _reduce_series(series: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """An epoch's result from its per-step series: the last step's
    metrics, the reduced health series (``sentinel.reduce_epoch``) and
    ``health_bad_loss`` (``sentinel.at_bad_step`` of the loss series)."""
    rest, health = _sentinel.split(series)
    out = {k: v[-1] for k, v in rest.items()}
    out.update(_sentinel.reduce_epoch(health))
    out["health_bad_loss"] = _sentinel.at_bad_step(rest["loss"], out["health_bad_step"])
    return out


class _SeriesSink:
    """Copies each step's outputs into the epoch's per-step series (on
    the device), so a captured step's outputs are kept before the next
    replay overwrites them."""

    def __init__(self, n_steps: int):
        self.n = n_steps
        self.series: Dict[str, torch.Tensor] = {}

    def __call__(self, t: int, out: Dict[str, torch.Tensor]) -> None:
        if not self.series:
            self.series = {k: torch.empty((self.n,) + tuple(v.shape), dtype=v.dtype,
                                          device=v.device) for k, v in out.items()}
        keys = list(self.series)
        torch._foreach_copy_([self.series[k][t] for k in keys], [out[k] for k in keys])


# ---------------------------------------------------------------------------
# Feeds: where a step's batch comes from
# ---------------------------------------------------------------------------


class ResidentFeed:
    """Each step's batch gathered on the device from a resident ``X``/
    ``Y`` by its row of ``idx``: ``(n_steps, batch)``, or ``(n_steps, k,
    batch)`` for a pack (member i's batch is ``idx[t, i]``). The row is
    copied into a static slot before the step, so the gather is part of
    a captured step."""

    def __init__(self, X: torch.Tensor, Y: torch.Tensor, idx: torch.Tensor):
        self.X, self.Y, self.idx = X, Y, idx
        self.n_steps = idx.shape[0]
        self.rows = torch.empty_like(idx[0])
        self.feed_s = 0.0

    def prepare(self, t: int) -> None:
        self.rows.copy_(self.idx[t])

    def batch(self) -> Batch:
        lead = tuple(self.rows.shape)
        flat = self.rows.reshape(-1)
        return {"x": self.X.index_select(0, flat).reshape(lead + tuple(self.X.shape[1:])),
                "y": self.Y.index_select(0, flat).reshape(lead + tuple(self.Y.shape[1:]))}

    def after(self, t: int) -> None:
        pass


class HostFeed:
    """Each step's batch from the host: ``n_steps`` numpy batches, each
    copied to the device (from pinned memory, non-blocking) right after
    the previous step is dispatched, then into static slots before its
    own step. ``feed_s`` sums the host seconds of the copies. ``plan``
    puts each batch (under a dp mesh, this rank's rows of it; under an
    in-process mesh, each replica's rows, whose eager steps read them as
    they are, with no slots). Drawing and putting a batch runs under the
    ``train.feed`` range."""

    def __init__(self, batches: Iterator[Dict[str, np.ndarray]], n_steps: int,
                 device: torch.device, plan: _ShardingPlan = _NO_MESH):
        self._batches, self.n_steps, self.device = batches, n_steps, device
        self._plan = plan
        self.feed_s = 0.0
        self._next = self._put_next()
        self.slots = None if plan.in_process else {
            k: torch.empty_like(v) for k, v in self._next.items()}

    def _put_next(self) -> Optional[Batch]:
        with record_function("train.feed"):
            batch = next(self._batches, None)
            if batch is None:
                return None
            batch.pop("valid", None)
            t0 = time.monotonic()
            dev = self._plan.put_batch(batch, self.device)
            self.feed_s += time.monotonic() - t0
        return dev

    def prepare(self, t: int) -> None:
        for k, slot in (self.slots or {}).items():
            slot.copy_(self._next[k])

    def batch(self):
        return self._next if self.slots is None else dict(self.slots)

    def after(self, t: int) -> None:
        # One batch of prefetch: batch t+1's copy starts right after
        # step t is dispatched, so its host work overlaps that step.
        self._next = self._put_next() if t + 1 < self.n_steps else None


class Program:
    """The trial-independent half of a training loop: the step closures
    and the epoch loops over a feed. Safe to share across trials (and
    threads) whose computation is identical: per-trial state (params,
    optimizer state, step, generator, hyper) lives in :class:`TrainLoop`.

    Two lr modes, as the JAX package's: with ``dynamic_lr`` (the
    template path) the optimizer is lr-free and the step scales its
    updates by ``-effective_lr(hyper, step)`` where ``hyper`` has an
    ``lr``, so trials differing in lr and warmup share the Program;
    without, the optimizer carries its own lr (``make_optimizer``).

    ``train_step`` is one eager step (the plain version, for callers
    that step by hand); ``train_steps``/``train_epoch`` and
    ``eval_epoch`` run an epoch, captured on the card
    (``ops/graphs.py``). The dp plan is the caller's, passed per call
    (``plan``), so a cached Program holds no process group; under a
    mesh the epoch's steps run eagerly.
    """

    def __init__(self, apply_fn, loss_fn, optimizer, dynamic_lr: bool = True):
        self.apply_fn = apply_fn
        self.optimizer = optimizer
        self.dynamic_lr = dynamic_lr
        self._body, self.eval_step = _make_step_fns(apply_fn, loss_fn, optimizer, dynamic_lr)

    def _scales(self, hyper: Hyper) -> bool:
        return self.dynamic_lr and "lr" in hyper

    def predict(self, module: nn.Module, batch: Batch) -> torch.Tensor:
        """Class probabilities: the float32 softmax of the logits."""
        return torch.softmax(self.apply_fn(module, batch).float(), dim=-1)

    def train_step(self, state: State, batch: Batch, plan: _ShardingPlan = _NO_MESH
                   ) -> Tuple[State, Dict[str, torch.Tensor]]:
        """One step, eagerly: the same body a captured epoch replays, its
        row of per-step scalars computed and uploaded here. Under a dp
        ``plan``, ``batch`` is this rank's slice (an in-process mesh's:
        the replicas' slices, ``plan.put_batch``)."""
        module, opt_state, step_i, generator, hyper = state
        device = _module_device(module)
        if opt_state is None:
            opt_state = self.optimizer.init(list(module.parameters()))
        if plan.in_process:
            plan.sync(module, opt_state, step_i)
        scalars = torch.from_numpy(_step_table(self.optimizer, opt_state, hyper, step_i, 1,
                                               self._scales(hyper))[0]).to(device)
        opt_state, metrics = self._body(module, opt_state, generator, _on(hyper, device),
                                        scalars, batch, plan=plan)
        if plan.in_process:
            plan.mirrored(module, step_i + 1)
        return (module, opt_state, step_i + 1, generator, hyper), metrics

    def train_steps(self, state: State, feed, on_step=None, cost=None,
                    poison: Optional[np.ndarray] = None,
                    plan: _ShardingPlan = _NO_MESH
                    ) -> Tuple[State, Dict[str, torch.Tensor]]:
        """``feed.n_steps`` steps through a :class:`~rafiki_tpu_torch.ops.
        graphs.StepRunner`. Returns the new state and the per-step
        metric series, ``(n_steps,)`` each, on the device.
        ``on_step(t, metrics)`` runs after step ``t`` is dispatched;
        ``cost`` (a profiler ``CostCapture``) counts the first step;
        ``poison`` (an ``(n_steps,)`` float32 column) multiplies each
        step's gradients by its entry; without it the steps multiply by
        nothing. Under a dp ``plan`` every step runs eagerly."""
        module, opt_state, step_i, generator, hyper = state
        n = feed.n_steps
        device = _module_device(module)
        if opt_state is None:
            opt_state = self.optimizer.init(list(module.parameters()))
        if plan.in_process:
            plan.sync(module, opt_state, step_i)
        poisoned = poison is not None
        table = torch.from_numpy(_step_table(self.optimizer, opt_state, hyper, step_i, n,
                                             self._scales(hyper), poison)).to(device)
        scalars = torch.empty_like(table[0])
        hyper_dev = _on(hyper, device)
        cell = [opt_state]
        sink = _SeriesSink(n)

        def prepare(t: int) -> None:
            scalars.copy_(table[t])
            feed.prepare(t)

        def body() -> Dict[str, torch.Tensor]:
            cell[0], metrics = self._body(module, cell[0], generator, hyper_dev, scalars,
                                          feed.batch(), poisoned, plan)
            return metrics

        def collect(t: int, metrics: Dict[str, torch.Tensor]) -> None:
            sink(t, metrics)
            feed.after(t)
            if on_step is not None:
                on_step(t, metrics)

        if cost is not None:
            body = cost.wrap(body)
        runner = StepRunner(device, n, body, prepare, collect, generators=[generator],
                            eager=plan.mesh is not None)
        with plan.card_locks():
            runner.run()
        if plan.in_process:
            plan.mirrored(module, step_i + n)
        # The body ran (and counted) once per eager step and once for the
        # capture; the replays moved the device state, not the counts.
        opt_state = self.optimizer.advance(cell[0], n - runner.calls)
        return (module, opt_state, step_i + n, generator, hyper), sink.series

    def train_epoch(self, state: State, X: torch.Tensor, Y: torch.Tensor,
                    idx: torch.Tensor, poison: Optional[np.ndarray] = None
                    ) -> Tuple[State, Dict[str, torch.Tensor]]:
        """One step per row of ``idx`` (an ``(n_steps, batch)`` index
        tensor on the device), each batch gathered from the resident
        ``X``/``Y``, its gradients multiplied by its entry of ``poison``
        where one is given. Returns the last step's metrics plus the
        epoch's reduced health series, all still on the device."""
        state, series = self.train_steps(state, ResidentFeed(X, Y, idx), poison=poison)
        return state, _reduce_series(series)

    def eval_epoch(self, module: nn.Module, X: torch.Tensor, Y: torch.Tensor,
                   idx: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Summed (correct, counted) over the rows of ``idx``."""
        return _eval_steps(lambda batch: self.eval_step(module, batch), X, Y, idx, ())


def _eval_steps(step, X: torch.Tensor, Y: torch.Tensor, idx: torch.Tensor,
                shape: Tuple[int, ...]) -> Tuple[torch.Tensor, torch.Tensor]:
    """(correct, counted) summed over the rows of ``idx``, each a
    ``step(batch)``, through a StepRunner: int64 of ``shape``."""
    feed = ResidentFeed(X, Y, idx)
    c = torch.zeros(shape, dtype=torch.int64, device=X.device)
    n = torch.zeros(shape, dtype=torch.int64, device=X.device)

    def body() -> Dict[str, torch.Tensor]:
        dc, dn = step(feed.batch())
        return {"c": dc, "n": dn}

    def collect(t: int, out: Dict[str, torch.Tensor]) -> None:
        c.add_(out["c"])
        n.add_(out["n"])

    StepRunner(X.device, feed.n_steps, body, feed.prepare, collect).run()
    return c, n


# ---------------------------------------------------------------------------
# Process-wide program cache
# ---------------------------------------------------------------------------
#
# A worker runs many trials back to back; trials of one program key
# share one Program, as the JAX package's share one compiled program.
# The per-key lock builds a Program once even under concurrent callers.
# The cache is capped (LRU); live loops keep their Program through
# their own reference, so eviction is always safe.

_PROGRAM_CACHE_CAP = 64

_programs: Dict[Hashable, Any] = {}  # insertion-ordered: LRU by re-insertion
_build_locks: Dict[Hashable, threading.Lock] = {}
# last_miss_ts (epoch seconds, comparable to the meta store's trial
# timestamps) tells which trials ran after the last build.
_stats = {"hits": 0, "misses": 0, "evictions": 0, "last_miss_ts": 0.0}
_guard = threading.Lock()


def mesh_cache_key(mesh) -> Hashable:
    """The mesh part of a program key: None without a mesh; for a
    process rank, the mesh's axis names, width and this rank's device;
    for an in-process mesh, its axis names and its devices, as the JAX
    package keys its meshes (``rafiki_tpu/ops/train.py:340-343``)."""
    if mesh is None:
        return None
    if getattr(mesh, "in_process", False):
        return (tuple(mesh.axis_names), tuple(str(d) for d in mesh.devices))
    return (tuple(mesh.axis_names), int(mesh.world_size), str(mesh.device))


def get_program(key: Hashable, builder: Callable[[], Any]) -> Any:
    """Return the cached program for ``key``, building it (once, even
    under concurrent callers) if absent.

    Contract: ``key`` must fully determine the builder's inputs (the
    apply/loss closures, the optimizer): on a hit the caller's builder
    is IGNORED in favor of the cached program. ``TorchModel`` keys every
    knob that reaches the step; direct callers must do the same.
    """
    with _guard:
        prog = _programs.get(key)
        if prog is not None:
            _programs[key] = _programs.pop(key)  # refresh LRU position
            _stats["hits"] += 1
            telemetry.inc("program_cache.hits")
            return prog
        lock = _build_locks.setdefault(key, threading.Lock())
    with lock:
        with _guard:
            prog = _programs.get(key)
            if prog is not None:
                _stats["hits"] += 1
                telemetry.inc("program_cache.hits")
                return prog
        try:
            with telemetry.span("program.build"):
                prog = builder()
        except BaseException:
            # A builder that raises leaves no lock entry behind:
            # _build_locks must not outgrow the capped _programs.
            with _guard:
                _build_locks.pop(key, None)
            raise
        with _guard:
            # Publish and retire the build lock atomically: popping the
            # lock first would let a concurrent caller install a fresh
            # lock and build a duplicate.
            _programs[key] = prog
            _stats["misses"] += 1
            _stats["last_miss_ts"] = time.time()
            _build_locks.pop(key, None)
            evicted = 0
            while len(_programs) > _PROGRAM_CACHE_CAP:
                _programs.pop(next(iter(_programs)))
                _stats["evictions"] += 1
                evicted += 1
        telemetry.inc("program_cache.misses")
        if evicted:
            telemetry.inc("program_cache.evictions", evicted)
    return prog


def program_cache_stats() -> Dict[str, Any]:
    with _guard:
        return dict(_stats, size=len(_programs))


# The cache's lifetime stats also surface through the telemetry
# registry, as the collector ``program_cache``.
telemetry.register_collector("program_cache", program_cache_stats)


def clear_program_cache() -> None:
    with _guard:
        _programs.clear()
        _build_locks.clear()
        _stats.update(hits=0, misses=0, evictions=0, last_miss_ts=0.0)


# ---------------------------------------------------------------------------
# Device-resident datasets
# ---------------------------------------------------------------------------
#
# The device copy of a dataset is cached ON the (host-side, LRU-cached)
# Dataset object, so it lives as long as the cache entry: trials of one
# job reuse one upload.

_DEVICE_DATASET_MAX_MB_ENV = "RAFIKI_DEVICE_DATASET_MAX_MB"
_DEVICE_DATASET_MAX_MB_DEFAULT = 2048


def device_dataset_cap_bytes() -> int:
    return int(float(os.environ.get(_DEVICE_DATASET_MAX_MB_ENV,
                                    _DEVICE_DATASET_MAX_MB_DEFAULT)) * 1e6)


def get_device_dataset(dataset, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dataset's (x, y) on ``device``: one upload per dataset and
    device, cached on the dataset."""
    cache = dataset.__dict__.setdefault("_device_arrays", {})
    key = str(device)
    if key not in cache:
        cache[key] = (torch.from_numpy(np.ascontiguousarray(dataset.x)).to(device),
                      torch.from_numpy(np.ascontiguousarray(dataset.y)).to(device))
    return cache[key]


def _put_batch(batch: Dict[str, np.ndarray], device: torch.device) -> Batch:
    """Host batch -> device tensors. To a card the copy goes from pinned
    memory with ``non_blocking``, so it overlaps the step in flight."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t
    return out


# ---------------------------------------------------------------------------
# TrainLoop: per-trial state driving a (possibly shared) Program
# ---------------------------------------------------------------------------


class TrainLoop:
    """Drives epochs of train steps over a Dataset for one trial.

    Parameters
    ----------
    init_fn: ``generator -> nn.Module`` with float32 params, drawn from
        the CPU ``generator`` seeded with ``seed``.
    apply_fn: ``(module, batch) -> logits`` (eval mode).
    loss_fn: ``(module, batch, generator, hyper) -> (loss, metrics)``.
    optimizer: with ``lr`` in ``hyper``, an lr-free update core (default
        ``scale_by_adam()``) whose output the step scales by
        ``-effective_lr(hyper, step)``; without, a complete optimizer
        (default ``adam(1e-3)``) whose updates apply as they are.
    seed: seeds the init draw and the dropout stream.
    hyper: per-trial float32 scalars: ``lr``, ``warmup``, and
        ``dropout`` where the module takes a rate. The state keeps them
        on the host; the step reads device copies.
    program_key: optional hashable. When given, the Program comes from
        the process-wide cache under ``(program_key, mesh_cache_key(mesh),
        dynamic_lr)``; the init draw is always this loop's own.
    initial_state: optional ``(module, opt_state, step, generator,
        hyper)`` tuple to adopt instead of running ``init_fn``;
        ``opt_state`` None means no moments yet (a fresh optimizer).
    device: where the trial runs (default the CUDA card; the CPU only
        when asked for).
    mesh: optional dp mesh (``parallel/mesh.py data_parallel_mesh``) on
        ``device``: the loop is one rank of a width-W trial, or, under an
        in-process mesh, the whole trial, whose replica 0 is ``device``
        (module doc).
    """

    def __init__(self, init_fn: Optional[Callable[[torch.Generator], nn.Module]],
                 apply_fn, loss_fn, optimizer=None, seed: int = 0,
                 hyper: Optional[Dict[str, float]] = None,
                 program_key: Optional[Hashable] = None, initial_state=None,
                 device: DeviceLike = None, mesh=None):
        self.device = resolve_device(device)
        if mesh is not None:
            # The mesh holds its card by index (data_parallel_mesh); plain
            # "cuda" is the current card.
            own = self.device
            if own.type == "cuda" and own.index is None:
                own = torch.device("cuda", torch.cuda.current_device())
            if mesh.device != own:
                raise ValueError(f"the dp mesh's device {mesh.device} is not the trial's "
                                 f"{self.device}")
        self.plan = _ShardingPlan(mesh)
        _deterministic_convs(self.device)
        if optimizer is None:
            optimizer = scale_by_adam() if "lr" in (hyper or {}) else adam(1e-3)
        if initial_state is None:
            module = init_fn(torch.Generator().manual_seed(seed))
            generator = torch.Generator(device=self.device).manual_seed(seed)
            initial_state = (module, None, 0, generator, hyper or {})
        module, opt_state, step, generator, hyper = initial_state
        hyper = {k: torch.as_tensor(v, dtype=torch.float32).cpu() for k, v in hyper.items()}
        dynamic_lr = "lr" in hyper

        def build() -> Program:
            return Program(apply_fn, loss_fn, optimizer, dynamic_lr=dynamic_lr)

        if program_key is not None:
            self._perf_key = (program_key, mesh_cache_key(mesh), dynamic_lr)
            self.program = get_program(self._perf_key, build)
        else:
            self._perf_key = ("serial", "anon", id(self))
            self.program = build()
        self.health = HealthMonitor(f"serial:{id(self)}")
        self._warm = False
        self.state: State = (module.to(self.device), opt_state, int(step), generator, hyper)

    @property
    def params(self) -> nn.Module:
        return self.state[0]

    @property
    def hyper(self) -> Hyper:
        """The trial's float32 hyper scalars (``lr``, ``warmup``, ...)."""
        return self.state[4]

    def _fits_device_fast_path(self, dataset) -> bool:
        """x/y datasets small enough to live on the device run as one
        device-side gather per step over a resident copy."""
        return (getattr(dataset, "mask", None) is None
                and dataset.x.nbytes + dataset.y.nbytes <= device_dataset_cap_bytes())

    def run_epoch(self, dataset, batch_size: int, epoch_seed: int,
                  on_metrics: Optional[Callable[[int, Dict[str, float]], None]] = None
                  ) -> Dict[str, float]:
        if dataset.size < batch_size:
            raise ValueError(
                f"Dataset has {dataset.size} examples < batch_size={batch_size}; "
                f"the epoch would run zero steps")
        mesh = self.plan.mesh
        if mesh is not None:
            # A kill keyed to one rank lands while its peers are in (or
            # headed into) the epoch's all-reduces. The worker id carries
            # the -rN restart suffix, so `unless=-r` scopes a kill to the
            # first incarnation. An in-process mesh passes once, as rank 0,
            # as the JAX package's does (jax.process_index() 0).
            _chaos.hook("collective.step",
                        key=f"p{mesh.rank}:{os.environ.get('RAFIKI_WORKER_ID', '')}")
        # Under a mesh each global batch is formed on the host (module doc).
        fast = on_metrics is None and mesh is None and self._fits_device_fast_path(dataset)
        # The replay capsule's pre-epoch state, copied on the device before
        # the timer (None unless capsules are on). The host-fed path has
        # no index matrix to replay, so it banks none.
        snap = self.health.snapshot_state(self.state) if fast else None
        t_epoch = time.monotonic()
        # Inside the timed region: an injected delay lengthens the epoch
        # the perf sentinel measures.
        _chaos.hook("train.epoch", key=str(self._perf_key))
        n_steps = dataset.size // batch_size
        poison = self._chaos_poison(n_steps)
        idx = None
        if fast:
            X, Y = get_device_dataset(dataset, self.device)
            perm = np.random.default_rng(epoch_seed).permutation(dataset.size)
            idx = perm[: n_steps * batch_size].reshape(n_steps, batch_size)
            feed = ResidentFeed(X, Y, torch.from_numpy(idx).to(self.device))
            on_step = None
        else:
            feed = HostFeed(dataset.batches(batch_size, shuffle=True, seed=epoch_seed,
                                            drop_remainder=True), n_steps, self.device,
                            self.plan)

            def on_step(t: int, metrics: Dict[str, torch.Tensor]) -> None:
                if on_metrics is not None and t % 50 == 0:
                    on_metrics(t, {k: float(v) for k, v in metrics.items()
                                   if not k.startswith(_sentinel.PREFIX)})

        cost = None if self._warm else profiler.capture_cost(
            self._perf_key, "serial", 1, self.device, _compute_dtype(self.state[0]))
        try:
            self.state, series = self.program.train_steps(self.state, feed, on_step, cost,
                                                          poison, self.plan)
        finally:
            if cost is not None:
                cost.close()
        # The health series reaches the host once, at the epoch boundary.
        out = {k: float(v) for k, v in _reduce_series(series).items()}
        self._record_epoch(t_epoch, feed.feed_s, n_steps)
        self._health_check(out, t_epoch, epoch_seed, idx, poison, snap)
        return out

    def _chaos_poison(self, n_steps: int) -> Optional[np.ndarray]:
        """Chaos site ``train.nan``: when an active plane fires it for this
        loop's key, the ``(n_steps,)`` poison column, ones but a NaN at
        step ``n_steps // 2``; else None, and the epoch multiplies by
        nothing (module doc)."""
        if _chaos.active() is None or _chaos.hook("train.nan", key=str(self._perf_key)) is None:
            return None
        poison = np.ones(n_steps, np.float32)
        poison[n_steps // 2] = np.nan
        return poison

    def _health_check(self, out: Dict[str, float], t0: float, epoch_seed: int,
                      idx: Optional[np.ndarray], poison: Optional[np.ndarray],
                      snapshot) -> None:
        """Epoch-boundary health gate: strip the sentinel keys from the
        caller-visible metric dict and fail the trial fast on a
        divergence verdict. The epoch's indices, poison column and
        pre-epoch snapshot go to the monitor for its replay capsule."""
        health = {k: out.pop(k) for k in list(out) if k.startswith(_sentinel.PREFIX)}
        verdict = self.health.observe(health, t0=t0, epoch_seed=epoch_seed, idx=idx,
                                      poison=poison, snapshot=snapshot)
        if verdict is not None:
            raise DivergenceError(verdict)

    def _record_epoch(self, t0: float, feed_s: float, steps: int) -> None:
        """The ``train.*`` telemetry: the first epoch of a loop pays the
        first-call costs (cuDNN's algorithm choice, allocator growth,
        the first capture), so its wall lands in ``train.cold_epoch_s``,
        the others in ``train.epoch_s``. The same split feeds the goodput
        ledger (cold as ``compile_s``, warm as ``step_s``), the profiler
        and an SLO tick."""
        dt = time.monotonic() - t0
        cold = not self._warm
        self._warm = True
        telemetry.observe("train.cold_epoch_s" if cold else "train.epoch_s", dt)
        if feed_s > 0.0:
            telemetry.inc("train.host_feed_s", feed_s)
            ledger.add("feed_s", feed_s)
        telemetry.inc("train.step_s", max(dt - feed_s, 0.0))
        ledger.add("compile_s" if cold else "step_s", max(dt - feed_s, 0.0))
        profiler.note_epoch(self._perf_key, dt, feed_s=feed_s, cold=cold, steps=steps)
        slo.maybe_tick()

    def evaluate(self, dataset, batch_size: int) -> float:
        module = self.state[0]
        total_correct = total = torch.zeros((), dtype=torch.int64, device=self.device)
        start = 0
        with torch.inference_mode():
            if self._fits_device_fast_path(dataset) and dataset.size >= batch_size:
                # Full batches gathered on the device; the remainder falls
                # through to the padded host batches below.
                X, Y = get_device_dataset(dataset, self.device)
                n_steps = dataset.size // batch_size
                idx = torch.arange(n_steps * batch_size, device=self.device).reshape(
                    n_steps, batch_size)
                c, n = self.program.eval_epoch(module, X, Y, idx)
                total_correct, total = total_correct + c, total + n
                start = n_steps * batch_size
            # (correct, counted) accumulate on the device; the host reads
            # them once at the end. The remainder is one batch of its own
            # shape: it runs eagerly.
            for batch in dataset.batches(batch_size, shuffle=False, drop_remainder=False,
                                         start=start):
                c, n = self.program.eval_step(module, _put_batch(batch, self.device))
                total_correct, total = total_correct + c, total + n
        return int(total_correct) / max(int(total), 1)

    def predict_proba(self, x: np.ndarray, batch_size: int) -> np.ndarray:
        """Forward a query array; pads to full batches, returns (N, ..., C) probs."""
        return predict_proba(self.state[0], x, batch_size, self.device)


# ---------------------------------------------------------------------------
# Trial packing: k same-program trials as one stacked program
# ---------------------------------------------------------------------------


class _Bound:
    """A module's forward with one member's params swapped in: callable
    as the module is, so a template's ``loss`` runs unchanged."""

    def __init__(self, base: nn.Module, params: Dict[str, torch.Tensor],
                 buffers: Dict[str, torch.Tensor]):
        self.base, self.params, self.buffers = base, params, buffers

    def __call__(self, *args, **kwargs):
        return functional_call(self.base, (self.params, self.buffers), args, kwargs)


@dataclass
class PackedState:
    """A pack's state, every entry with the members in slot order:
    ``params``/``buffers`` are stacked ``(k, ...)`` leaves, ``opt`` holds
    the stacked Adam moments and a tuple of k counts, ``steps`` the k
    step counts, ``generators`` the k dropout generators and ``hyper``
    the ``(k,)`` float32 hyper vectors on the host (``hyper_dev``: the
    same on the device, for the forward). ``base`` is the members'
    architecture (on the meta device): what their leaves' names map to."""

    params: Dict[str, torch.Tensor]
    buffers: Dict[str, torch.Tensor]
    opt: Any  # ScaleByAdamState, or a make_optimizer template's AdamState
    steps: List[int]
    generators: List[torch.Generator]
    hyper: Dict[str, torch.Tensor]
    hyper_dev: Dict[str, torch.Tensor]
    base: Optional[nn.Module] = None

    @property
    def k(self) -> int:
        return len(self.steps)

    def member_hyper(self, i: int) -> Hyper:
        return {name: v[i] for name, v in self.hyper.items()}


def _set_tensor(module: nn.Module, name: str, value: torch.Tensor) -> None:
    owner_name, _, leaf = name.rpartition(".")
    owner = module.get_submodule(owner_name) if owner_name else module
    if leaf in owner._parameters:
        owner._parameters[leaf] = nn.Parameter(value, requires_grad=False)
    else:
        owner._buffers[leaf] = value


class PackedProgram:
    """The trial-independent half of a k-trial pack: the per-member step
    closures of :func:`_make_step_fns`, vmapped over the trial axis.

    The train step feeds each member its own batch (``x``/``y`` of shape
    ``(k, batch, ...)``) so each keeps its serial shuffle order; eval
    shares one batch across the members (``in_dims=(0, 0, None)``).
    ``module`` gives the architecture only (it is copied to the meta
    device). The closures do not depend on the width k, but the program
    cache keys a packed program on it (``packed_program_key``), as the
    JAX package's compiles one per width. ``functional_call`` swaps a
    member's params into the module it is given, so each thread calls a
    copy of its own (``_thread_base``): packs of one key on two workers'
    threads share the cached program.
    """

    def __init__(self, module: nn.Module, apply_fn, loss_fn, optimizer,
                 dynamic_lr: bool = True):
        self.base = copy.deepcopy(module).to("meta")
        self.optimizer = optimizer
        self.dynamic_lr = dynamic_lr
        self._local = threading.local()
        _, eval_step = _make_step_fns(apply_fn, loss_fn, optimizer)

        def member_loss(params, buffers, x, y, hyper, generators):
            return loss_fn(_Bound(self._thread_base(), params, buffers), {"x": x, "y": y},
                           generators, hyper)

        def member_eval(params, buffers, batch):
            return eval_step(_Bound(self._thread_base(), params, buffers), batch)

        self._member_loss = member_loss
        self._v_eval = vmap(member_eval, in_dims=(0, 0, None))

    def _thread_base(self) -> nn.Module:
        base = getattr(self._local, "base", None)
        if base is None:
            base = self._local.base = copy.deepcopy(self.base)
        return base

    def _step_table(self, state: PackedState, n: int,
                    poison: Optional[np.ndarray] = None) -> np.ndarray:
        """``(n, k, 3)`` float32: each member's ``-effective_lr`` from its
        own step count and its Adam scalars from its own count (without
        ``dynamic_lr``, a complete optimizer's scalars alone); with
        ``poison`` (the epoch's ``(n, k)`` chaos columns), each member's
        poison multiplier last."""
        parts = [self.optimizer.step_scalars(state.opt, n)]
        if self.dynamic_lr:
            neg_lr = np.stack([_neg_lr(state.member_hyper(i), s, n)
                               for i, s in enumerate(state.steps)], axis=1)
            parts.insert(0, neg_lr[..., None])
        if poison is not None:
            parts.append(np.asarray(poison, np.float32).reshape(n, state.k, 1))
        return np.ascontiguousarray(np.concatenate(parts, axis=2), np.float32)

    def _body(self, state: PackedState, scalars: torch.Tensor, batch: Batch,
              poisoned: bool = False) -> Dict[str, torch.Tensor]:
        """One step of every member, in place, reading member i's scalars
        from ``scalars[i]`` (its poison multiplier last when
        ``poisoned``). Returns ``(k,)`` metrics."""
        k = state.k
        leaves = list(state.params.values())
        v_loss = vmap(functools.partial(self._member_loss,
                                        generators=PackedGenerators(state.generators)))
        with torch.enable_grad():
            with record_function("train.forward"):
                losses, metrics = v_loss(state.params, state.buffers, batch["x"], batch["y"],
                                         state.hyper_dev)
            # Member i's loss reads only slice i of each leaf, so the
            # gradient of the sum, slice by slice, is each member's own.
            grads = torch.autograd.grad(losses.sum(), leaves)
        with torch.no_grad():
            if poisoned:
                # Each member's gradients by its own multiplier: a NaN
                # stays in the poisoned member's slices.
                for i in range(k):
                    torch._foreach_mul_([g[i] for g in grads], scalars[i, -1])
            with record_function("train.adam"):
                # k lists of updates; each member's -effective_lr (or its
                # complete optimizer's schedule), applied to its slices as
                # a serial step applies its own.
                first = 1 if self.dynamic_lr else 0
                updates, state.opt = self.optimizer.update(
                    grads, state.opt, scalars[:, first:-1] if poisoned else scalars[:, first:])
                for i in range(k):
                    if self.dynamic_lr:
                        torch._foreach_mul_(updates[i], scalars[i, 0])
                    torch._foreach_add_([p[i] for p in leaves], updates[i])
            with record_function("train.sentinel"):
                losses = losses.detach()
                health = _sentinel.bundle_packed(losses, grads, updates, leaves)
        state.steps = [s + 1 for s in state.steps]
        metrics = {key: v.detach() for key, v in metrics.items()}
        return dict(metrics, loss=losses, **health)

    def train_step(self, state: PackedState, batch: Batch) -> Dict[str, torch.Tensor]:
        """One step of every member, eagerly (``state`` is updated in
        place): the body a captured epoch replays. Returns ``(k,)``
        metrics: the loss, the template's metrics and the per-member
        health bundle."""
        device = next(iter(state.params.values())).device
        scalars = torch.from_numpy(self._step_table(state, 1)[0]).to(device)
        return self._body(state, scalars, batch)

    def eval_step(self, state: PackedState, batch: Batch) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(k,)`` (correct, counted) of every member over one shared batch."""
        return self._v_eval(state.params, state.buffers, batch)

    def train_steps(self, state: PackedState, feed, on_step=None, cost=None,
                    poison: Optional[np.ndarray] = None) -> Dict[str, torch.Tensor]:
        """``feed.n_steps`` steps of every member through a StepRunner
        (``state`` is updated in place). Returns the per-step metric
        series, ``(n_steps, k)`` each, on the device. ``cost`` (a
        profiler ``CostCapture``) counts the first step; ``poison`` (an
        ``(n_steps, k)`` float32 matrix) multiplies member i's gradients
        at step t by its entry ``[t, i]``."""
        n = feed.n_steps
        device = next(iter(state.params.values())).device
        poisoned = poison is not None
        table = torch.from_numpy(self._step_table(state, n, poison)).to(device)
        scalars = torch.empty_like(table[0])
        steps = list(state.steps)
        sink = _SeriesSink(n)

        def prepare(t: int) -> None:
            scalars.copy_(table[t])
            feed.prepare(t)

        def collect(t: int, metrics: Dict[str, torch.Tensor]) -> None:
            sink(t, metrics)
            feed.after(t)
            if on_step is not None:
                on_step(t, metrics)

        def body() -> Dict[str, torch.Tensor]:
            return self._body(state, scalars, feed.batch(), poisoned)

        if cost is not None:
            body = cost.wrap(body)
        runner = StepRunner(device, n, body, prepare, collect, generators=state.generators)
        runner.run()
        # The body counted its eager steps and the capture; the replays
        # moved the device state only.
        state.opt = self.optimizer.advance(state.opt, n - runner.calls)
        state.steps = [s + n for s in steps]
        return sink.series

    def train_epoch(self, state: PackedState, X: torch.Tensor, Y: torch.Tensor,
                    idx: torch.Tensor, poison: Optional[np.ndarray] = None
                    ) -> Dict[str, torch.Tensor]:
        """One step per row of ``idx`` (``(n_steps, k, batch)`` on the
        device): member i's batch is gathered from the resident ``X``/
        ``Y`` by ``idx[t, i]``, its gradients multiplied by ``poison[t,
        i]`` where a poison matrix is given. Returns the last step's
        ``(k,)`` metrics and the epoch's health series reduced per member,
        on the device."""
        return _reduce_series(self.train_steps(state, ResidentFeed(X, Y, idx), poison=poison))

    def eval_epoch(self, state: PackedState, X: torch.Tensor, Y: torch.Tensor,
                   idx: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Per-member summed (correct, counted) over the rows of ``idx``
        (``(n_steps, batch)``: one batch stream shared by the members)."""
        return _eval_steps(lambda batch: self.eval_step(state, batch), X, Y, idx, (state.k,))


def packed_program_key(program_key: Hashable, k: int, dynamic_lr: bool) -> Hashable:
    """Cache key of a PackedProgram. The leading tag keeps packed and
    serial keys (``(program_key, mesh_key, dynamic_lr)``) apart in the
    process-wide cache, even for one base key."""
    return ("packed", int(k), program_key, bool(dynamic_lr))


class PackedTrainLoop:
    """Drives epochs of a k-trial pack over one Dataset.

    Parameters mirror :class:`TrainLoop`, pluralized: ``seeds`` are the
    k per-trial seeds (each seeds its member's init draw and dropout
    generator, as ``TrainLoop(seed=...)`` does), ``hypers`` the k
    per-trial hyper dicts, all with one key set. Member i computes what
    ``TrainLoop(init_fn, ..., seed=seeds[i], hyper=hypers[i])`` computes;
    only the launches are shared. ``init_fn`` may return the same module
    object on every call (``TorchModel._loop_fns`` does): each member's
    params are copied out before the next draw. With ``program_key`` the
    PackedProgram of the current width comes from the process-wide cache
    (``packed_program_key``); evict and admit fetch the new width's.

    A pack never raises on divergence: each epoch leaves one
    ``Optional[verdict]`` per live member on ``last_verdicts``, and the
    pack driver (``TorchModel.train_packed``) evicts the sick members.
    """

    def __init__(self, init_fn: Callable[[torch.Generator], nn.Module], apply_fn, loss_fn,
                 optimizer=None, seeds: Optional[Sequence[int]] = None,
                 hypers: Optional[Sequence[Dict[str, float]]] = None,
                 program_key: Optional[Hashable] = None,
                 packing_key: Optional[str] = None, device: DeviceLike = None):
        if not seeds:
            raise ValueError("PackedTrainLoop needs at least one seed")
        hypers = list(hypers) if hypers is not None else [{} for _ in seeds]
        if len(hypers) != len(seeds):
            raise ValueError(f"{len(hypers)} hyper dicts for {len(seeds)} seeds")
        keysets = {tuple(sorted(h)) for h in hypers}
        if len(keysets) != 1:
            raise ValueError(f"pack members carry different hyper keys {sorted(keysets)}")
        # As a serial loop: with an lr in the hyper dicts each member's
        # updates are scaled by its own; without, the optimizer is
        # complete (a template's make_optimizer) and the members differ
        # only in their seeds.
        self._dynamic_lr = "lr" in hypers[0]
        if optimizer is None:
            optimizer = scale_by_adam() if self._dynamic_lr else adam(1e-3)
        self.device = resolve_device(device)
        _deterministic_convs(self.device)
        self.packing_key = packing_key
        self._init_fn = init_fn
        draws = [self._draw(s) for s in seeds]
        # The build inputs outlive __init__: evict and admit change the
        # width, and a width change fetches that width's program.
        self._fns = (copy.deepcopy(draws[0][2]).to("meta"), apply_fn, loss_fn, optimizer)
        self._program_key = program_key
        names, buffer_names = list(draws[0][0]), list(draws[0][1])
        hyper = {name: torch.tensor([float(h[name]) for h in hypers], dtype=torch.float32)
                 for name in hypers[0]}
        self.state = PackedState(
            params={n: torch.stack([d[0][n] for d in draws]).to(self.device).requires_grad_()
                    for n in names},
            buffers={n: torch.stack([d[1][n] for d in draws]).to(self.device)
                     for n in buffer_names},
            opt=optimizer.init_packed(len(seeds)),
            steps=[0] * len(seeds),
            generators=[torch.Generator(device=self.device).manual_seed(int(s)) for s in seeds],
            hyper=hyper,
            hyper_dev={name: v.to(self.device) for name, v in hyper.items()},
            base=self._fns[0])
        self._set_program()
        self.health = HealthMonitor(f"packed:{id(self)}", k=self.k)
        self.last_verdicts: List[Optional[Dict[str, Any]]] = [None] * self.k
        self._warm = False

    @property
    def k(self) -> int:
        return self.state.k

    def _set_program(self) -> None:
        """(Re)fetch the PackedProgram of the current width: the packed
        key holds k, so a width change after evict or admit builds (once,
        then cached) the new width's program, as the JAX package's
        compiles it. A member's computation does not depend on k."""
        module, apply_fn, loss_fn, optimizer = self._fns

        def build() -> PackedProgram:
            return PackedProgram(module, apply_fn, loss_fn, optimizer, self._dynamic_lr)

        if self._program_key is not None:
            self._perf_key = packed_program_key(self._program_key, self.k, self._dynamic_lr)
            self.program = get_program(self._perf_key, build)
        else:
            self._perf_key = ("packed", "anon", id(self), self.k)
            self.program = build()

    def _draw(self, seed: int):
        """One member's initial (params, buffers), drawn as
        ``TrainLoop(seed=seed)`` draws them and copied off the module,
        and the module (the architecture a program is built from)."""
        module = self._init_fn(torch.Generator().manual_seed(int(seed)))
        return ({n: p.detach().clone() for n, p in module.named_parameters()},
                {n: b.detach().clone() for n, b in module.named_buffers()}, module)

    # -- elastic membership --------------------------------------------------

    def _member_module(self, i: int) -> nn.Module:
        """A trainable module holding a copy of member ``i``'s params."""
        module = copy.deepcopy(self.program.base).to_empty(device=self.device)
        with torch.no_grad():
            for n, p in module.named_parameters():
                p.copy_(self.state.params[n][i])
            for n, b in module.named_buffers():
                b.copy_(self.state.buffers[n][i])
        return module.eval()

    def trial_state(self, i: int) -> State:
        """Member ``i``'s ``(module, opt_state, step, generator, hyper)``,
        shaped as a serial ``TrainLoop``'s state (copies; the generator
        is the member's own)."""
        if not (0 <= i < self.k):
            raise IndexError(f"member {i} out of pack of {self.k}")
        st = self.state
        opt = member_opt_state(st.opt, i, torch.clone)
        if isinstance(opt, ScaleByAdamState) and opt.mu is None:
            opt = None  # no update yet: a fresh optimizer
        hyper = {name: v[i].clone() for name, v in st.hyper.items()}
        return (self._member_module(i), opt, st.steps[i], st.generators[i], hyper)

    def trial_params(self, i: int) -> Dict[str, torch.Tensor]:
        """Member ``i``'s params: views of the stacked leaves."""
        return {n: p[i].detach() for n, p in self.state.params.items()}

    def slice(self, i: int) -> "PackedSliceLoop":
        return PackedSliceLoop(self, i)

    def evict(self, i: int) -> State:
        """Take member ``i`` out of the pack and narrow it to k-1. Returns
        the member's serial-shaped state, which ``TrainLoop(initial_state=
        ...)`` adopts to carry on exactly as a serial run of the trial."""
        if not (0 <= i < self.k):
            raise IndexError(f"evict {i} out of pack of {self.k}")
        if self.k == 1:
            raise ValueError("cannot evict the last pack member")
        evicted = self.trial_state(i)
        st = self.state

        def drop(a: torch.Tensor) -> torch.Tensor:
            return torch.cat([a[:i], a[i + 1:]]).detach()

        st.params = {n: drop(p).requires_grad_() for n, p in st.params.items()}
        st.buffers = {n: drop(b) for n, b in st.buffers.items()}
        st.opt = map_members(st.opt, drop, lambda c: c[:i] + c[i + 1:])
        st.steps = st.steps[:i] + st.steps[i + 1:]
        st.generators = st.generators[:i] + st.generators[i + 1:]
        st.hyper = {n: drop(v) for n, v in st.hyper.items()}
        st.hyper_dev = {n: drop(v) for n, v in st.hyper_dev.items()}
        self.health.evict_member(i)
        if i < len(self.last_verdicts):
            self.last_verdicts.pop(i)
        self._set_program()
        telemetry.inc("trial_pack.evictions")
        return evicted

    def admit(self, seed: int, hyper: Dict[str, float]) -> int:
        """Backfill one slot with a fresh member, initialised exactly as
        ``TrainLoop(seed=seed, hyper=hyper)`` would be, and widen the pack
        to k+1. Returns the new member's slot."""
        st = self.state
        have, want = tuple(sorted(st.hyper)), tuple(sorted(hyper))
        if have != want:
            raise ValueError(f"backfill hyper keys {want} != pack hyper keys {have}")
        params, buffers, _ = self._draw(seed)

        def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
            return torch.cat([a.detach(), b.to(a.device, a.dtype)[None]])

        st.params = {n: add(p, params[n]).requires_grad_() for n, p in st.params.items()}
        st.buffers = {n: add(b, buffers[n]) for n, b in st.buffers.items()}
        # Zero moments: the first update from them is the serial first
        # update (whose moments start as zeros).
        st.opt = map_members(st.opt, lambda m: add(m, torch.zeros_like(m[0])),
                             lambda c: c + (0,))
        st.steps = st.steps + [0]
        st.generators = st.generators + [torch.Generator(device=self.device).manual_seed(int(seed))]
        value = {n: torch.tensor([float(hyper[n])], dtype=torch.float32) for n in hyper}
        st.hyper = {n: torch.cat([v, value[n]]) for n, v in st.hyper.items()}
        st.hyper_dev = {n: torch.cat([v, value[n].to(v.device)]) for n, v in st.hyper_dev.items()}
        self.health.admit_member()
        self.last_verdicts.append(None)
        self._set_program()
        telemetry.inc("trial_pack.backfills")
        return self.k - 1

    # -- epochs ----------------------------------------------------------------

    def _fits_device_fast_path(self, dataset) -> bool:
        return (getattr(dataset, "mask", None) is None
                and dataset.x.nbytes + dataset.y.nbytes <= device_dataset_cap_bytes())

    def run_epoch(self, dataset, batch_size: int, epoch_seeds: Sequence[int]
                  ) -> List[Dict[str, float]]:
        """One epoch of every member; ``epoch_seeds`` are the k shuffle
        seeds (serial parity: ``seed_i + epoch_i``). Returns the k
        members' final-step metrics; their health verdicts are left on
        ``last_verdicts``."""
        if len(epoch_seeds) != self.k:
            raise ValueError(f"{len(epoch_seeds)} epoch seeds for pack of {self.k}")
        if dataset.size < batch_size:
            raise ValueError(
                f"Dataset has {dataset.size} examples < batch_size={batch_size}; "
                f"the epoch would run zero steps")
        # The stacked pre-epoch state for replay capsules, copied on the
        # device before the timer; sliced per sick member only at a trip.
        snap = self.health.snapshot_state(self.state)
        t_epoch = time.monotonic()
        _chaos.hook("train.epoch", key=str(self._perf_key))
        n_steps = dataset.size // batch_size
        # (n_steps, k, batch): each member keeps its own serial permutation.
        idx = np.stack([np.random.default_rng(int(s)).permutation(dataset.size)
                        [: n_steps * batch_size].reshape(n_steps, batch_size)
                        for s in epoch_seeds], axis=1)
        poison = self._chaos_poison(n_steps)
        if self._fits_device_fast_path(dataset):
            X, Y = get_device_dataset(dataset, self.device)
            feed = ResidentFeed(X, Y, torch.from_numpy(idx).to(self.device))
        else:
            feed = HostFeed(({"x": dataset.x[ib], "y": dataset.y[ib]} for ib in idx), n_steps,
                            self.device)
        cost = None if self._warm else profiler.capture_cost(
            self._perf_key, "packed", self.k, self.device, _compute_dtype(self._fns[0]))
        try:
            series = self.program.train_steps(self.state, feed, cost=cost, poison=poison)
        finally:
            if cost is not None:
                cost.close()
        metrics = _reduce_series(series)
        host = {key: v.cpu().numpy() for key, v in metrics.items()}
        rows = [{key: float(v[i]) for key, v in host.items()} for i in range(self.k)]
        self._record_epoch(t_epoch, feed.feed_s, n_steps)
        return self._health_check(rows, t_epoch, epoch_seeds, idx, poison, snap)

    def _chaos_poison(self, n_steps: int) -> Optional[np.ndarray]:
        """Chaos site ``train.nan``, one hook key per live member
        (``f"{perf_key}@m{i}"``; ``@`` because the spec grammar reserves
        ``:``), so ``match=@m2`` picks which member diverges: the
        ``(n_steps, k)`` poison matrix, ones but a NaN at step
        ``n_steps // 2`` of each hit member; None when no member was hit."""
        if _chaos.active() is None:
            return None
        hit = [i for i in range(self.k)
               if _chaos.hook("train.nan", key=f"{self._perf_key}@m{i}") is not None]
        if not hit:
            return None
        poison = np.ones((n_steps, self.k), np.float32)
        poison[n_steps // 2, hit] = np.nan
        return poison

    def _health_check(self, rows: List[Dict[str, float]], t0: float,
                      epoch_seeds: Sequence[int], idx: np.ndarray,
                      poison: Optional[np.ndarray], snapshot) -> List[Dict[str, float]]:
        """Strip the sentinel keys from the members' rows and leave one
        Optional[verdict] per live member on ``last_verdicts``. A pack
        never raises: its survivors train on, and ``TorchModel.train_packed``
        evicts the sick members."""
        health_rows = [{k: v for k, v in r.items() if k.startswith(_sentinel.PREFIX)}
                       for r in rows]
        self.last_verdicts = self.health.observe_pack(
            health_rows, t0=t0, epoch_seeds=list(epoch_seeds), idx=idx, poison=poison,
            snapshot=snapshot)
        return [{k: v for k, v in r.items() if not k.startswith(_sentinel.PREFIX)}
                for r in rows]

    def _record_epoch(self, t0: float, feed_s: float, steps: int) -> None:
        """``train.packed_cold_epoch_s`` for the pack's first epoch (it
        pays the first-call costs), ``train.packed_epoch_s`` after; the
        ledger, the profiler (``kind="packed"``, the width and the
        packing key) and an SLO tick as in :meth:`TrainLoop._record_epoch`."""
        dt = time.monotonic() - t0
        cold = not self._warm
        self._warm = True
        telemetry.observe("train.packed_cold_epoch_s" if cold else "train.packed_epoch_s", dt)
        if feed_s > 0.0:
            telemetry.inc("train.host_feed_s", feed_s)
            ledger.add("feed_s", feed_s)
        telemetry.inc("train.step_s", max(dt - feed_s, 0.0))
        ledger.add("compile_s" if cold else "step_s", max(dt - feed_s, 0.0))
        profiler.note_epoch(self._perf_key, dt, feed_s=feed_s, cold=cold, kind="packed",
                            k=self.k, packing_key=self.packing_key, steps=steps)
        slo.maybe_tick()

    def evaluate(self, dataset, batch_size: int) -> np.ndarray:
        """``(k,)`` accuracies from one eval pass shared by the members."""
        total_correct = total = torch.zeros((self.k,), dtype=torch.int64, device=self.device)
        start = 0
        with torch.inference_mode():
            if self._fits_device_fast_path(dataset) and dataset.size >= batch_size:
                X, Y = get_device_dataset(dataset, self.device)
                n_steps = dataset.size // batch_size
                idx = torch.arange(n_steps * batch_size, device=self.device).reshape(
                    n_steps, batch_size)
                c, n = self.program.eval_epoch(self.state, X, Y, idx)
                total_correct, total = total_correct + c, total + n
                start = n_steps * batch_size
            for batch in dataset.batches(batch_size, shuffle=False, drop_remainder=False,
                                         start=start):
                c, n = self.program.eval_step(self.state, _put_batch(batch, self.device))
                total_correct, total = total_correct + c, total + n
        c = total_correct.cpu().numpy().astype(np.float64)
        n = total.cpu().numpy().astype(np.float64)
        return c / np.maximum(n, 1.0)


class PackedSliceLoop:
    """Member ``index`` of a pack, shaped as what ``TorchModel`` reads
    from a ``TrainLoop``: ``params`` is an ``nn.Module`` whose params are
    views of the member's slices, so ``dump_parameters`` and
    ``predict_proba`` of a packed trial run the serial code. ``evaluate``
    scores the member in the pack's shared pass. It has no
    ``run_epoch``: a member trains only through its pack."""

    def __init__(self, packed: PackedTrainLoop, index: int):
        if not (0 <= index < packed.k):
            raise IndexError(f"slice {index} out of pack of {packed.k}")
        self.packed = packed
        self.index = index
        self.device = packed.device
        self._module: Optional[nn.Module] = None

    @property
    def params(self) -> nn.Module:
        if self._module is None:
            module = copy.deepcopy(self.packed.program.base)
            st = self.packed.state
            for n, p in st.params.items():
                _set_tensor(module, n, p[self.index].detach())
            for n, b in st.buffers.items():
                _set_tensor(module, n, b[self.index])
            self._module = module.eval()
        return self._module

    @property
    def state(self) -> State:
        return self.packed.trial_state(self.index)

    def evaluate(self, dataset, batch_size: int) -> float:
        return float(self.packed.evaluate(dataset, batch_size)[self.index])

    def predict_proba(self, x: np.ndarray, batch_size: int) -> np.ndarray:
        return predict_proba(self.params, x, batch_size, self.device)



# ---------------------------------------------------------------------------
# Serving half
# ---------------------------------------------------------------------------


def predict(module: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """Class probabilities: the float32 softmax of the module's logits."""
    return torch.softmax(module(x).float(), dim=-1)


def eval_step(module: nn.Module, x: torch.Tensor, y: torch.Tensor,
              valid: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(correct, counted)`` over labels >= 0, optionally masked by a
    per-example ``valid`` flag broadcast over trailing label axes."""
    return _count_correct(module(x), y, valid)


def predict_proba(module: nn.Module, x: np.ndarray, batch_size: int,
                  device: torch.device) -> np.ndarray:
    """Forward a query array in fixed-size chunks; returns ``(N, ..., C)``
    float32 probabilities on the host. The last chunk is padded to
    ``batch_size`` by repeating its last row, as the JAX package does."""
    n = x.shape[0]
    outs = []
    with torch.inference_mode():
        for start in range(0, n, batch_size):
            chunk = x[start : start + batch_size]
            pad = batch_size - chunk.shape[0]
            if pad:
                chunk = np.concatenate([chunk, np.repeat(chunk[-1:], pad, axis=0)])
            xt = torch.from_numpy(np.ascontiguousarray(chunk)).to(device)
            probs = predict(module, xt).cpu().numpy()
            outs.append(probs[: batch_size - pad] if pad else probs)
    return np.concatenate(outs) if outs else np.zeros((0,))


# ---------------------------------------------------------------------------
# Standalone builders (the legacy surface; Program is the primary API)
# ---------------------------------------------------------------------------


def _no_loss(module, batch, generator, hyper):
    return torch.zeros(()), {}


def make_train_step(loss_fn, optimizer, plan: _ShardingPlan = _NO_MESH,
                    dynamic_lr: bool = False):
    """A train step ``(state, batch) -> (state, metrics)`` over the
    5-tuple state ``(module, opt_state, step, generator, hyper)``; with
    ``dynamic_lr`` the updates are scaled by ``-effective_lr(hyper,
    step)``; under a dp ``plan`` the batch is the rank's slice and the
    gradients are averaged over its mesh. It runs eagerly, one call per
    step: a captured step needs the static slots of an epoch
    (``Program.train_steps``)."""
    return functools.partial(Program(lambda module, batch: None, loss_fn, optimizer,
                                     dynamic_lr=dynamic_lr).train_step, plan=plan)


def make_eval_step(apply_fn, plan: _ShardingPlan = _NO_MESH):
    """An eval step ``(module, batch) -> (#correct, #valid)`` on the
    device. Eval is replicated under a mesh, so ``plan`` changes nothing."""
    return Program(apply_fn, _no_loss, None, dynamic_lr=False).eval_step


def make_predict_fn(apply_fn, plan: _ShardingPlan = _NO_MESH):
    """A forward ``(module, batch) -> probabilities`` (float32 softmax),
    replicated under a mesh as eval is."""
    return Program(apply_fn, _no_loss, None, dynamic_lr=False).predict
