"""Training and forward programs of a trial, in eager PyTorch.

Counterpart of ``rafiki_tpu/ops/train.py``:

  * ``cross_entropy_loss`` (``:60``), the traced-rate ``dropout``
    (``:82``) and ``effective_lr`` (``:150``);
  * the step closures of ``_make_step_fns`` (``:158``): the loss and its
    gradients, Adam's lr-free core (``ops/optim.py``), ``-effective_lr``,
    the update, and the health sentinel bundle, in that order;
  * ``Program`` (``:221``), ``get_device_dataset`` (``:448``) and
    ``TrainLoop`` (``:467``): an epoch over a dataset resident on the
    device (batches gathered there with ``index_select``, in the same
    ``np.random.default_rng(epoch_seed)`` order), or batch by batch
    from the host with one batch of prefetch;
  * the serving half: ``predict`` (the float32 softmax, ``:210``),
    ``eval_step`` (the masked argmax-correct count, ``:199``) and
    ``predict_proba`` (``:763``), which pads the last chunk to a full
    batch by REPEATING ITS LAST ROW so the device sees one shape.

Hyperparameters that change per trial (learning rate, warmup, dropout
rate) are float32 scalars on the host, as the JAX package's are traced
scalars: the step count lives on the host too, so the learning rate is
computed there and no step reads back from the device.

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
norms run once per member with the serial ops; each member's dropout
mask comes from its own generator (:class:`PackedGenerators`); and on
the card training selects cuDNN's deterministic algorithms. So member i
computes bit for bit what a serial ``TrainLoop(seed_i, hyper_i)``
computes, on the CPU and on the card. The JAX package caches
compiled packed programs under ``packed_program_key``; the port has no
program cache (see :class:`Program`), so it has no such key either.

Not ported with this slice: the dp mesh (``_ShardingPlan``), the chaos
plane's ``train.nan`` poison column and ``collective.step``/``train.epoch``
sites, the goodput ledger, the perf profiler and SLO ticks.

``torch.inference_mode`` is thread-local, so :func:`predict_proba`
enters it itself, on whatever thread serves the query.
"""

from __future__ import annotations

import copy
import functools
import os
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch._C._functorch as _functorch
from torch import nn
from torch._functorch.pyfunctorch import temporarily_pop_interpreter_stack
from torch.func import functional_call, vmap
from torch.profiler import record_function

from rafiki_tpu_torch import telemetry
from rafiki_tpu_torch.obs.health import DivergenceError, HealthMonitor
from rafiki_tpu_torch.obs.health import sentinel as _sentinel
from rafiki_tpu_torch.ops.optim import ScaleByAdamState, adam, scale_by_adam
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
    In a pack, ``generator`` is the members' :class:`PackedGenerators`."""
    if deterministic or generator is None:
        return x
    rate = torch.as_tensor(rate, dtype=torch.float32)
    if isinstance(generator, PackedGenerators):
        noise = _per_member_rand(x, generator)
    else:
        noise = torch.rand(x.shape, generator=generator, device=x.device)
    keep = noise < (1.0 - rate)
    scale = torch.where(rate < 1.0, 1.0 / torch.clamp_min(1.0 - rate, 1e-6),
                        torch.zeros_like(rate))
    return torch.where(keep, x * scale.to(x.dtype), torch.zeros_like(x))


def effective_lr(hyper: Hyper, step_i) -> torch.Tensor:
    """Linear warmup to ``hyper["lr"]`` over ``hyper["warmup"]`` steps,
    in float32: ``lr * min((step + 1) / max(warmup, 1), 1)``."""
    warmup = torch.clamp_min(torch.as_tensor(hyper.get("warmup", 1.0), dtype=torch.float32), 1.0)
    step = torch.as_tensor(step_i).to(torch.float32)
    frac = torch.clamp_max((step + 1.0) / warmup, 1.0)
    return torch.as_tensor(hyper["lr"], dtype=torch.float32) * frac


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


def _make_step_fns(apply_fn, loss_fn, optimizer):
    """The single-trial step closures: (train_step, eval_step).

    ``apply_fn(module, batch) -> logits`` (eval mode);
    ``loss_fn(module, batch, generator, hyper) -> (loss, metrics)``.
    """

    def train_step(state: State, batch: Batch) -> Tuple[State, Dict[str, torch.Tensor]]:
        module, opt_state, step_i, generator, hyper = state
        params = list(module.parameters())
        with torch.enable_grad():
            with record_function("train.forward"):
                loss, metrics = loss_fn(module, batch, generator, hyper)
            grads = torch.autograd.grad(loss, params)
        with torch.no_grad():
            with record_function("train.adam"):
                if opt_state is None:
                    opt_state = optimizer.init(params)
                updates, opt_state = optimizer.update(grads, opt_state)
                if "lr" in hyper:  # else the optimizer is complete (make_optimizer)
                    torch._foreach_mul_(updates, -float(effective_lr(hyper, step_i)))
                torch._foreach_add_(params, updates)
            # The sentinels read the step's tensors; they never touch the
            # dropout stream or the update arithmetic.
            with record_function("train.sentinel"):
                loss = loss.detach()
                health = _sentinel.bundle(loss, grads, updates, params)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return (module, opt_state, step_i + 1, generator, hyper), dict(metrics, loss=loss, **health)

    def eval_step(module: nn.Module, batch: Batch) -> Tuple[torch.Tensor, torch.Tensor]:
        return _count_correct(apply_fn(module, batch), batch["y"], batch.get("valid"))

    return train_step, eval_step


class Program:
    """The trial-independent half of a training loop: the step closures
    and the epoch loops over a device-resident dataset.

    The JAX package compiles these once per program key and caches the
    result process-wide (an LRU of 64), so back-to-back trials skip the
    XLA compile. Eager PyTorch has nothing to compile: a Program holds
    only closures, each TrainLoop builds its own, and there is no cache.
    """

    def __init__(self, apply_fn, loss_fn, optimizer):
        self.optimizer = optimizer
        self.train_step, self.eval_step = _make_step_fns(apply_fn, loss_fn, optimizer)

    def train_epoch(self, state: State, X: torch.Tensor, Y: torch.Tensor,
                    idx: torch.Tensor) -> Tuple[State, Dict[str, torch.Tensor]]:
        """One step per row of ``idx`` (an ``(n_steps, batch)`` index
        tensor on the device), each batch gathered from the resident
        ``X``/``Y``. Returns the last step's metrics plus the epoch's
        reduced health series, all still on the device."""
        steps = []
        for ib in idx:
            state, metrics = self.train_step(
                state, {"x": X.index_select(0, ib), "y": Y.index_select(0, ib)})
            steps.append(metrics)
        rest, health = _sentinel.split({k: torch.stack([m[k] for m in steps])
                                        for k in steps[0]})
        out = {k: v[-1] for k, v in rest.items()}
        out.update(_sentinel.reduce_epoch(health))
        return state, out

    def eval_epoch(self, module: nn.Module, X: torch.Tensor, Y: torch.Tensor,
                   idx: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Summed (correct, counted) over the rows of ``idx``."""
        c = n = torch.zeros((), dtype=torch.int64, device=X.device)
        for ib in idx:
            dc, dn = self.eval_step(module, {"x": X.index_select(0, ib),
                                             "y": Y.index_select(0, ib)})
            c, n = c + dc, n + dn
        return c, n


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
# TrainLoop: per-trial state driving a Program
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
        ``dropout`` where the module takes a rate.
    initial_state: optional ``(module, opt_state, step, generator,
        hyper)`` tuple to adopt instead of running ``init_fn``;
        ``opt_state`` None means no moments yet (a fresh optimizer).
    device: where the trial runs (default the CUDA card; the CPU only
        when asked for).
    """

    def __init__(self, init_fn: Optional[Callable[[torch.Generator], nn.Module]],
                 apply_fn, loss_fn, optimizer=None, seed: int = 0,
                 hyper: Optional[Dict[str, float]] = None, initial_state=None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        _deterministic_convs(self.device)
        if optimizer is None:
            optimizer = scale_by_adam() if "lr" in (hyper or {}) else adam(1e-3)
        self.program = Program(apply_fn, loss_fn, optimizer)
        self.health = HealthMonitor(f"serial:{id(self)}")
        self._warm = False
        if initial_state is None:
            module = init_fn(torch.Generator().manual_seed(seed))
            generator = torch.Generator(device=self.device).manual_seed(seed)
            initial_state = (module, None, 0, generator, hyper or {})
        module, opt_state, step, generator, hyper = initial_state
        hyper = {k: torch.as_tensor(v, dtype=torch.float32).cpu() for k, v in hyper.items()}
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
        fast = on_metrics is None and self._fits_device_fast_path(dataset)
        t_epoch = time.monotonic()
        n_steps = dataset.size // batch_size
        if fast:
            X, Y = get_device_dataset(dataset, self.device)
            perm = np.random.default_rng(epoch_seed).permutation(dataset.size)
            idx = torch.from_numpy(perm[: n_steps * batch_size].reshape(n_steps, batch_size))
            self.state, metrics = self.program.train_epoch(
                self.state, X, Y, idx.to(self.device))
            out = {k: float(v) for k, v in metrics.items()}
            self._record_epoch(t_epoch, feed_s=0.0)
            self._health_check(out, t_epoch, epoch_seed)
            return out
        count = 0
        metrics = None
        feed_s = 0.0
        health_steps = []
        # One batch of prefetch: batch i+1's copy to the device starts
        # right after step i is dispatched, so it overlaps that step.
        batches = dataset.batches(batch_size, shuffle=True, seed=epoch_seed,
                                  drop_remainder=True)

        def put_next():
            nonlocal feed_s
            batch = next(batches, None)
            if batch is None:
                return None
            batch.pop("valid", None)
            t_feed = time.monotonic()
            dev = _put_batch(batch, self.device)
            feed_s += time.monotonic() - t_feed
            return dev

        dev_batch = put_next()
        while dev_batch is not None:
            self.state, metrics = self.program.train_step(self.state, dev_batch)
            # Device scalars kept as they are: the health series reaches
            # the host once, at the epoch-boundary reduction.
            health_steps.append({k: v for k, v in metrics.items()
                                 if k.startswith(_sentinel.PREFIX)})
            dev_batch = put_next()
            if on_metrics is not None and (count % 50 == 0):
                on_metrics(count, {k: float(v) for k, v in metrics.items()
                                   if not k.startswith(_sentinel.PREFIX)})
            count += 1
        out = {k: float(v) for k, v in metrics.items()
               if not k.startswith(_sentinel.PREFIX)} if count else {}
        self._record_epoch(t_epoch, feed_s)
        if count:
            series = {k: torch.stack([h[k] for h in health_steps])
                      for k in health_steps[0]}
            out.update({k: float(v) for k, v in _sentinel.reduce_epoch(series).items()})
            self._health_check(out, t_epoch, epoch_seed)
        return out

    def _health_check(self, out: Dict[str, float], t0: float, epoch_seed: int) -> None:
        """Epoch-boundary health gate: strip the sentinel keys from the
        caller-visible metric dict and fail the trial fast on a
        divergence verdict."""
        health = {k: out.pop(k) for k in list(out) if k.startswith(_sentinel.PREFIX)}
        verdict = self.health.observe(health, t0=t0, epoch_seed=epoch_seed)
        if verdict is not None:
            raise DivergenceError(verdict)

    def _record_epoch(self, t0: float, feed_s: float) -> None:
        """The ``train.*`` telemetry: the first epoch of a loop pays the
        first-call costs (cuDNN's algorithm choice, allocator growth),
        so its wall lands in ``train.cold_epoch_s``, the others in
        ``train.epoch_s``."""
        dt = time.monotonic() - t0
        cold = not self._warm
        self._warm = True
        telemetry.observe("train.cold_epoch_s" if cold else "train.epoch_s", dt)
        if feed_s > 0.0:
            telemetry.inc("train.host_feed_s", feed_s)
        telemetry.inc("train.step_s", max(dt - feed_s, 0.0))

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
            # them once at the end.
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
    same on the device, for the forward)."""

    params: Dict[str, torch.Tensor]
    buffers: Dict[str, torch.Tensor]
    opt: ScaleByAdamState
    steps: List[int]
    generators: List[torch.Generator]
    hyper: Dict[str, torch.Tensor]
    hyper_dev: Dict[str, torch.Tensor]

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
    device). The width k is not part of the program: evict and admit
    change it freely.
    """

    def __init__(self, module: nn.Module, apply_fn, loss_fn, optimizer):
        self.base = copy.deepcopy(module).to("meta")
        self.optimizer = optimizer
        _, eval_step = _make_step_fns(apply_fn, loss_fn, optimizer)

        def member_loss(params, buffers, x, y, hyper, generators):
            return loss_fn(_Bound(self.base, params, buffers), {"x": x, "y": y},
                           generators, hyper)

        def member_eval(params, buffers, batch):
            return eval_step(_Bound(self.base, params, buffers), batch)

        self._member_loss = member_loss
        self._v_eval = vmap(member_eval, in_dims=(0, 0, None))

    def train_step(self, state: PackedState, batch: Batch) -> Dict[str, torch.Tensor]:
        """One step of every member (``state`` is updated in place).
        Returns ``(k,)`` metrics: the loss, the template's metrics and
        the per-member health bundle."""
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
            with record_function("train.adam"):
                # k lists of updates; each member's -effective_lr from its
                # own step count, applied to its slices as a serial step.
                updates, state.opt = self.optimizer.update(grads, state.opt)
                for i in range(k):
                    torch._foreach_mul_(updates[i], -float(effective_lr(state.member_hyper(i),
                                                                        state.steps[i])))
                    torch._foreach_add_([p[i] for p in leaves], updates[i])
            with record_function("train.sentinel"):
                losses = losses.detach()
                health = _sentinel.bundle_packed(losses, grads, updates, leaves)
        state.steps = [s + 1 for s in state.steps]
        metrics = {key: v.detach() for key, v in metrics.items()}
        return dict(metrics, loss=losses, **health)

    def eval_step(self, state: PackedState, batch: Batch) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(k,)`` (correct, counted) of every member over one shared batch."""
        return self._v_eval(state.params, state.buffers, batch)

    def train_epoch(self, state: PackedState, X: torch.Tensor, Y: torch.Tensor,
                    idx: torch.Tensor) -> Dict[str, torch.Tensor]:
        """One step per row of ``idx`` (``(n_steps, k, batch)`` on the
        device): member i's batch is gathered from the resident ``X``/
        ``Y`` by ``idx[t, i]``. Returns the last step's ``(k,)`` metrics
        and the epoch's health series reduced per member, on the device."""
        k, batch = idx.shape[1], idx.shape[2]
        health_steps = []
        metrics: Dict[str, torch.Tensor] = {}
        for ib in idx:
            flat = ib.reshape(-1)
            metrics = self.train_step(state, {
                "x": X.index_select(0, flat).reshape((k, batch) + tuple(X.shape[1:])),
                "y": Y.index_select(0, flat).reshape((k, batch) + tuple(Y.shape[1:]))})
            health_steps.append(_sentinel.split(metrics)[1])
        out = _sentinel.split(metrics)[0]
        out.update(_sentinel.reduce_epoch({key: torch.stack([h[key] for h in health_steps])
                                           for key in health_steps[0]}))
        return out

    def eval_epoch(self, state: PackedState, X: torch.Tensor, Y: torch.Tensor,
                   idx: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Per-member summed (correct, counted) over the rows of ``idx``
        (``(n_steps, batch)``: one batch stream shared by the members)."""
        c = n = torch.zeros((state.k,), dtype=torch.int64, device=X.device)
        for ib in idx:
            dc, dn = self.eval_step(state, {"x": X.index_select(0, ib),
                                            "y": Y.index_select(0, ib)})
            c, n = c + dc, n + dn
        return c, n


class PackedTrainLoop:
    """Drives epochs of a k-trial pack over one Dataset.

    Parameters mirror :class:`TrainLoop`, pluralized: ``seeds`` are the
    k per-trial seeds (each seeds its member's init draw and dropout
    generator, as ``TrainLoop(seed=...)`` does), ``hypers`` the k
    per-trial hyper dicts, all with one key set. Member i computes what
    ``TrainLoop(init_fn, ..., seed=seeds[i], hyper=hypers[i])`` computes;
    only the launches are shared. ``init_fn`` may return the same module
    object on every call (``TorchModel._loop_fns`` does): each member's
    params are copied out before the next draw.

    A pack never raises on divergence: each epoch leaves one
    ``Optional[verdict]`` per live member on ``last_verdicts``, and the
    pack driver (``TorchModel.train_packed``) evicts the sick members.
    """

    def __init__(self, init_fn: Callable[[torch.Generator], nn.Module], apply_fn, loss_fn,
                 optimizer=None, seeds: Optional[Sequence[int]] = None,
                 hypers: Optional[Sequence[Dict[str, float]]] = None,
                 packing_key: Optional[str] = None, device: DeviceLike = None):
        if not seeds:
            raise ValueError("PackedTrainLoop needs at least one seed")
        hypers = list(hypers) if hypers is not None else [{} for _ in seeds]
        if len(hypers) != len(seeds):
            raise ValueError(f"{len(hypers)} hyper dicts for {len(seeds)} seeds")
        keysets = {tuple(sorted(h)) for h in hypers}
        if len(keysets) != 1:
            raise ValueError(f"pack members carry different hyper keys {sorted(keysets)}")
        if "lr" not in hypers[0]:
            raise ValueError("a pack scales its updates by each member's hyper['lr']; "
                             "none was given")
        self.device = resolve_device(device)
        _deterministic_convs(self.device)
        self.packing_key = packing_key
        self._init_fn = init_fn
        draws = [self._draw(s) for s in seeds]
        self.program = PackedProgram(draws[0][2], apply_fn, loss_fn,
                                     optimizer if optimizer is not None else scale_by_adam())
        names, buffer_names = list(draws[0][0]), list(draws[0][1])
        hyper = {name: torch.tensor([float(h[name]) for h in hypers], dtype=torch.float32)
                 for name in hypers[0]}
        self.state = PackedState(
            params={n: torch.stack([d[0][n] for d in draws]).to(self.device).requires_grad_()
                    for n in names},
            buffers={n: torch.stack([d[1][n] for d in draws]).to(self.device)
                     for n in buffer_names},
            opt=ScaleByAdamState(count=(0,) * len(seeds), mu=None, nu=None),
            steps=[0] * len(seeds),
            generators=[torch.Generator(device=self.device).manual_seed(int(s)) for s in seeds],
            hyper=hyper,
            hyper_dev={name: v.to(self.device) for name, v in hyper.items()})
        self.health = HealthMonitor(f"packed:{id(self)}", k=self.k)
        self.last_verdicts: List[Optional[Dict[str, Any]]] = [None] * self.k
        self._warm = False

    @property
    def k(self) -> int:
        return self.state.k

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
        opt = None
        if st.opt.mu is not None:
            opt = ScaleByAdamState(count=st.opt.count[i], mu=[m[i].clone() for m in st.opt.mu],
                                   nu=[v[i].clone() for v in st.opt.nu])
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
        counts = st.opt.count[:i] + st.opt.count[i + 1:]
        st.opt = ScaleByAdamState(
            count=counts, mu=None if st.opt.mu is None else [drop(m) for m in st.opt.mu],
            nu=None if st.opt.nu is None else [drop(v) for v in st.opt.nu])
        st.steps = st.steps[:i] + st.steps[i + 1:]
        st.generators = st.generators[:i] + st.generators[i + 1:]
        st.hyper = {n: drop(v) for n, v in st.hyper.items()}
        st.hyper_dev = {n: drop(v) for n, v in st.hyper_dev.items()}
        self.health.evict_member(i)
        if i < len(self.last_verdicts):
            self.last_verdicts.pop(i)
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
        if st.opt.mu is not None:
            # Zero moments: the first update from them is the serial
            # first update (whose moments start as zeros).
            st.opt.mu = [add(m, torch.zeros_like(m[0])) for m in st.opt.mu]
            st.opt.nu = [add(v, torch.zeros_like(v[0])) for v in st.opt.nu]
        st.opt = ScaleByAdamState(count=st.opt.count + (0,), mu=st.opt.mu, nu=st.opt.nu)
        st.steps = st.steps + [0]
        st.generators = st.generators + [torch.Generator(device=self.device).manual_seed(int(seed))]
        value = {n: torch.tensor([float(hyper[n])], dtype=torch.float32) for n in hyper}
        st.hyper = {n: torch.cat([v, value[n]]) for n, v in st.hyper.items()}
        st.hyper_dev = {n: torch.cat([v, value[n].to(v.device)]) for n, v in st.hyper_dev.items()}
        self.health.admit_member()
        self.last_verdicts.append(None)
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
        t_epoch = time.monotonic()
        n_steps = dataset.size // batch_size
        # (n_steps, k, batch): each member keeps its own serial permutation.
        idx = np.stack([np.random.default_rng(int(s)).permutation(dataset.size)
                        [: n_steps * batch_size].reshape(n_steps, batch_size)
                        for s in epoch_seeds], axis=1)
        feed_s = 0.0
        if self._fits_device_fast_path(dataset):
            X, Y = get_device_dataset(dataset, self.device)
            metrics = self.program.train_epoch(self.state, X, Y,
                                               torch.from_numpy(idx).to(self.device))
        else:
            health_steps = []
            for ib in idx:
                t_feed = time.monotonic()
                batch = _put_batch({"x": dataset.x[ib], "y": dataset.y[ib]}, self.device)
                feed_s += time.monotonic() - t_feed
                metrics = self.program.train_step(self.state, batch)
                health_steps.append(_sentinel.split(metrics)[1])
            metrics = _sentinel.split(metrics)[0]
            metrics.update(_sentinel.reduce_epoch(
                {key: torch.stack([h[key] for h in health_steps]) for key in health_steps[0]}))
        host = {key: v.cpu().numpy() for key, v in metrics.items()}
        rows = [{key: float(v[i]) for key, v in host.items()} for i in range(self.k)]
        self._record_epoch(t_epoch, feed_s)
        return self._health_check(rows, t_epoch, epoch_seeds)

    def _health_check(self, rows: List[Dict[str, float]], t0: float,
                      epoch_seeds: Sequence[int]) -> List[Dict[str, float]]:
        """Strip the sentinel keys from the members' rows and leave one
        Optional[verdict] per live member on ``last_verdicts``."""
        health_rows = [{k: v for k, v in r.items() if k.startswith(_sentinel.PREFIX)}
                       for r in rows]
        self.last_verdicts = self.health.observe_pack(health_rows, t0=t0,
                                                      epoch_seeds=list(epoch_seeds))
        return [{k: v for k, v in r.items() if not k.startswith(_sentinel.PREFIX)}
                for r in rows]

    def _record_epoch(self, t0: float, feed_s: float) -> None:
        """``train.packed_cold_epoch_s`` for the pack's first epoch (it
        pays the first-call costs), ``train.packed_epoch_s`` after."""
        dt = time.monotonic() - t0
        cold = not self._warm
        self._warm = True
        telemetry.observe("train.packed_cold_epoch_s" if cold else "train.packed_epoch_s", dt)
        if feed_s > 0.0:
            telemetry.inc("train.host_feed_s", feed_s)
        telemetry.inc("train.step_s", max(dt - feed_s, 0.0))

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
