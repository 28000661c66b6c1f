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

Not ported with this slice: the dp mesh (``_ShardingPlan``), the chaos
plane's ``train.nan`` poison column and ``collective.step``/``train.epoch``
sites, the goodput ledger, the perf profiler and SLO ticks, and trial
packing.

``torch.inference_mode`` is thread-local, so :func:`predict_proba`
enters it itself, on whatever thread serves the query.
"""

from __future__ import annotations

import os
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.profiler import record_function

from rafiki_tpu_torch import telemetry
from rafiki_tpu_torch.obs.health import DivergenceError, HealthMonitor
from rafiki_tpu_torch.obs.health import sentinel as _sentinel
from rafiki_tpu_torch.ops.optim import scale_by_adam
from rafiki_tpu_torch.utils.backend import DeviceLike, resolve_device

Batch = Dict[str, torch.Tensor]
Hyper = Dict[str, torch.Tensor]
# (module, optimizer state, step count, dropout generator, hyper)
State = Tuple[nn.Module, Any, int, Optional[torch.Generator], Hyper]


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


def dropout(x: torch.Tensor, rate, generator: Optional[torch.Generator],
            deterministic: bool) -> torch.Tensor:
    """Inverted dropout whose rate is a tensor (or a number), so a sweep
    over the rate needs no other code path. Rate 1 gives zeros; the
    kept elements are scaled by ``1 / max(1 - rate, 1e-6)``. The random
    stream is ``generator``'s (on ``x``'s device); the JAX package's
    threefry stream cannot be matched, so parity is checked at rate 0."""
    if deterministic or generator is None:
        return x
    rate = torch.as_tensor(rate, dtype=torch.float32)
    keep = torch.rand(x.shape, generator=generator, device=x.device) < (1.0 - rate)
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
    optimizer: lr-free update core (default: ``scale_by_adam()``); the
        step scales its output by ``-effective_lr(hyper, step)``.
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
        self.program = Program(apply_fn, loss_fn,
                               optimizer if optimizer is not None else scale_by_adam())
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
