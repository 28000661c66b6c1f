"""ShardedTrainLoop: one trial's state sharded across a chip group.

The port's own copy of ``rafiki_tpu/shard/loop.py`` (``GroupAborted``,
``sharded_program_key``, ``_ShardedProgram``, ``ShardedTrainLoop`` and
``train_sharded``). At rest the trial's state is a
:class:`~rafiki_tpu_torch.shard.checkpoint.ShardedState`: every leaf of
the JAX package's checkpoint tree, in flax's layout, split along its
planned axis over the group's members (``shard/plan.py``), so a model
whose state outgrows one chip trains on the group's memory.

Execution model (and why it is bit-exact), as in the JAX package: each
epoch, every member **gathers** the sharded leaves to whole tensors (each
member's slice copied onto its device and concatenated on the leaf's
axis), runs the port's *identical* serial epoch on them (``ops/train.py
Program.train_steps``: on the card the captured CUDA graph of the serial
step, ``ops/graphs.py StepRunner``, replayed as every epoch is), then
**reslices** its own 1/width of the updated state. Gather and reslice
only move data, and the gathered tensors are written into the member's
own parameter and moment tensors, contiguous as the serial loop's are,
so the step runs the same kernels on the same operands. Compute is
deliberately replicated (ZeRO-3 with a replicated batch): a width-w epoch
is **bit-identical** to width w' and to the serial epoch on the same
device, which is what lets a group that lost a member resume at a
smaller width and still match an unfaulted run exactly.

Where the JAX package runs a group as one ``shard_map`` over a
``("shard",)`` mesh in one process, the port's group is one process too
and uses no ``torch.distributed``: the members run one after another in
the calling thread, each on its own device (several may share one), and
the gather is a device-to-device copy. A member's working state (its
module's parameters and Adam's moments, whole) lives as long as the
loop: it is the step's set of static tensors, as the JAX member's
gathered state is inside its ``shard_map``.

The ``_ShardedProgram`` (the serial ``Program`` of the trial's closures,
the group's per-leaf axes, its gather and its reslice) is cached by
``ops/train.py get_program`` under its ``("sharded", ...)`` key, like any
program. Chaos sites as in the JAX package: ``collective.step`` (keyed
``p0:<worker id>``), ``train.epoch`` and ``train.nan`` (keyed by the
sharded program key: one poison column for every member, so they stay
replicas).
"""

from __future__ import annotations

import copy
import os
import time
from typing import Any, Dict, Hashable, List, Optional, Tuple

import numpy as np
import torch

from rafiki_tpu_torch import chaos as _chaos
from rafiki_tpu_torch import telemetry
from rafiki_tpu_torch.convert import flax_to_state_dict
from rafiki_tpu_torch.model.base import _generator_state, _opt_from_tree, _state_tree, _subtree
from rafiki_tpu_torch.obs.health import sentinel as _sentinel
from rafiki_tpu_torch.ops.train import (Program, ResidentFeed, _compute_dtype,
                                        _deterministic_convs, _reduce_series,
                                        device_dataset_cap_bytes, get_device_dataset,
                                        get_program)
from rafiki_tpu_torch.shard.checkpoint import ShardedState, gather_leaf, split_tree
from rafiki_tpu_torch.shard.plan import ShardPlan, group_mesh


class GroupAborted(RuntimeError):
    """A group member was lost; the epoch loop stopped at the epoch
    boundary AFTER that epoch's checkpoint went durable. ``epoch`` is the
    last completed (and checkpointed) epoch: resume restores it and
    continues at ``epoch + 1``, at whatever width survives."""

    def __init__(self, epoch: int):
        super().__init__(f"sharded trial aborted after epoch {epoch}")
        self.epoch = int(epoch)


def sharded_program_key(program_key: Hashable, width: int, dynamic_lr: bool) -> Hashable:
    """Cache key of a group-sharded program. The leading tag keeps the
    namespace disjoint from serial keys and ``("packed", ...)`` keys."""
    return ("sharded", int(width), program_key, bool(dynamic_lr))


def _adam_count(full: Dict[str, torch.Tensor]) -> int:
    return int(full["1/0/count"] if "1/0/count" in full else full["1/count"])


class _ShardedProgram:
    """The trial-independent half of a sharded loop: the serial
    ``Program`` of the trial's closures, and the group's per-leaf axes
    with the gather and reslice over them."""

    def __init__(self, apply_fn, loss_fn, optimizer, plan: ShardPlan, dynamic_lr: bool,
                 shapes: Dict[str, Tuple[int, ...]]):
        self.program = Program(apply_fn, loss_fn, optimizer, dynamic_lr=dynamic_lr)
        self.optimizer = optimizer
        self.plan = plan
        self.width = int(plan.width)
        self.shapes = dict(shapes)
        self.axes = plan.axes_map(self.shapes)

    def gather(self, state: ShardedState, t: int, device: torch.device) -> Dict[str, torch.Tensor]:
        """Member t's whole tree on ``device`` (sharded leaves copied from
        every member and concatenated; replicated leaves its own)."""
        return {k: gather_leaf(state, k, device, t) for k in state.shapes}

    def reslice(self, full: Dict[str, Any], t: int, device: torch.device) -> Dict[str, torch.Tensor]:
        """Member t's 1/width of a whole tree, as copies that alias none
        of ``full`` (the member's working state is written over next
        epoch)."""
        out = {}
        for k, v in full.items():
            v = v.detach() if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v))
            a = self.axes[k]
            if a is not None:
                blk = v.shape[a] // self.width
                v = v.narrow(a, t * blk, blk)
            out[k] = v.clone(memory_format=torch.contiguous_format)
        return out

    def install(self, member, full: Dict[str, torch.Tensor]):
        """A member's working state holding ``full``: the parameters are
        written into its module's own tensors, the moments into tensors
        laid out as the parameters; before the first update the optimizer
        state is the fresh one, as a new serial trial's."""
        module, _, _, generator, _ = member
        module.load_state_dict(flax_to_state_dict(_subtree(full, "0"), module))
        if _adam_count(full) == 0:
            opt = self.optimizer.init(list(module.parameters()))
        else:
            opt = _opt_from_tree(_subtree(full, "1"), module, self.optimizer)
        hyper = {k: v.float().cpu() for k, v in _subtree(full, "4").items()}
        return (module, opt, int(full["2"]), generator, hyper)


class ShardedTrainLoop:
    """Drives epochs of one group-sharded trial.

    Same constructor contract as ``ops/train.py TrainLoop`` where it
    applies; the differences: ``devices`` (the group's members, one entry
    each; their count is the width) replaces ``device`` and ``mesh``, a
    :class:`ShardPlan` pins the placement, and ``packing_key`` (the repr
    of the scheduler's ``("sharded", family, width)`` bucket key) rides
    the perf records. ``initial_state`` is a ``ShardedState`` to adopt.
    """

    def __init__(self, init_fn, apply_fn, loss_fn, optimizer=None, devices=None,
                 seed: int = 0, hyper: Optional[Dict[str, float]] = None,
                 program_key: Optional[Hashable] = None, plan: Optional[ShardPlan] = None,
                 packing_key: Optional[str] = None, initial_state: Optional[ShardedState] = None):
        from rafiki_tpu_torch.ops.optim import adam, scale_by_adam

        if not devices:
            raise ValueError("ShardedTrainLoop needs the group's devices")
        self.mesh = group_mesh(devices)
        self.devices = list(self.mesh.devices)
        self.width = len(self.devices)
        self.plan = plan if plan is not None else ShardPlan(width=self.width)
        if self.plan.width != self.width:
            raise ValueError(f"plan width {self.plan.width} != group width {self.width}")
        self.packing_key = packing_key
        self.seed = int(seed)
        for dev in self.devices:
            _deterministic_convs(dev)
        hyper = {k: torch.as_tensor(v, dtype=torch.float32).cpu() for k, v in (hyper or {}).items()}
        dynamic_lr = "lr" in hyper
        if optimizer is None:
            optimizer = scale_by_adam() if dynamic_lr else adam(1e-3)
        # The serial loop's init: params drawn on the host from the seed,
        # one dropout generator per member seeded alike.
        module = init_fn(torch.Generator().manual_seed(self.seed))
        self._members = []
        for dev in self.devices:
            m = module if not self._members else copy.deepcopy(module)
            gen = torch.Generator(device=dev).manual_seed(self.seed)
            self._members.append((m.to(dev), None, 0, gen, hyper))
        full = _state_tree(self._members[0], self.seed)
        shapes = {k: tuple(np.shape(v)) for k, v in full.items()}

        def build() -> _ShardedProgram:
            return _ShardedProgram(apply_fn, loss_fn, optimizer, self.plan, dynamic_lr, shapes)

        if program_key is not None:
            self._perf_key = (sharded_program_key(program_key, self.width, dynamic_lr),
                              self.mesh.cache_key())
            self.program = get_program(self._perf_key, build)
        else:
            self._perf_key = ("sharded", "anon", id(self))
            self.program = build()
        self.optimizer = self.program.optimizer
        self._warm = False
        if initial_state is not None:
            self.adopt(initial_state)
        else:
            self.state = split_tree(full, self.devices, self._generator_state())

    def _generator_state(self) -> Dict[str, Any]:
        return _generator_state(self._members[0][3])

    def adopt(self, state: ShardedState) -> None:
        """Adopt a group state of this width (a reshard-restore's
        output): its generator, when it carries one of this device type,
        becomes every member's (``shard/checkpoint.py``)."""
        if state.width != self.width:
            raise ValueError(f"a width-{state.width} state for a width-{self.width} group")
        gen = state.generator
        if gen is not None and gen["device"] == self.devices[0].type:
            for m in self._members:
                m[3].set_state(torch.frombuffer(bytearray(gen["state"]), dtype=torch.uint8))
        state.generator = self._generator_state()
        self.state = state

    def _check_dataset(self, dataset, batch_size: int) -> None:
        if dataset.size < batch_size:
            raise ValueError(
                f"Dataset has {dataset.size} examples < batch_size={batch_size}; "
                f"the epoch would run zero steps")
        if getattr(dataset, "mask", None) is not None:
            raise NotImplementedError(
                "sharded loop runs the device-resident path only; "
                "masked (corpus) datasets are not supported")
        if dataset.x.nbytes + dataset.y.nbytes > device_dataset_cap_bytes():
            raise NotImplementedError(
                "sharded loop requires a device-resident dataset "
                "(RAFIKI_DEVICE_DATASET_MAX_MB)")

    def run_epoch(self, dataset, batch_size: int, epoch_seed: int) -> Dict[str, float]:
        """One epoch over the group: the serial fast path's shuffle,
        poison column and metrics (the bit-parity contract), run by every
        member on its gathered state."""
        self._check_dataset(dataset, batch_size)
        # Collective chaos site, keyed as the dp path's: a kill lands
        # while the group is in (or entering) its gathers.
        _chaos.hook("collective.step", key=f"p0:{os.environ.get('RAFIKI_WORKER_ID', '')}")
        t_epoch = time.monotonic()
        _chaos.hook("train.epoch", key=str(self._perf_key))
        n_steps = dataset.size // batch_size
        poison = self._chaos_poison(n_steps)
        perm = np.random.default_rng(epoch_seed).permutation(dataset.size)
        idx = perm[: n_steps * batch_size].reshape(n_steps, batch_size)
        prog = self.program
        shards, out = [], {}
        for t, dev in enumerate(self.devices):
            member = prog.install(self._members[t], prog.gather(self.state, t, dev))
            X, Y = get_device_dataset(dataset, dev)
            feed = ResidentFeed(X, Y, torch.from_numpy(idx).to(dev))
            cost = None
            if not self._warm and t == 0:
                from rafiki_tpu_torch.obs.perf import profiler

                cost = profiler.capture_cost(self._perf_key, "sharded", 1, dev,
                                             _compute_dtype(member[0]))
            try:
                member, series = prog.program.train_steps(member, feed, None, cost, poison)
            finally:
                if cost is not None:
                    cost.close()
            self._members[t] = member
            shards.append(prog.reslice(_state_tree(member, self.seed), t, dev))
            if t == 0:
                out = {k: float(v) for k, v in _reduce_series(series).items()
                       if not k.startswith(_sentinel.PREFIX)}
        self.state = ShardedState(dict(self.state.shapes), dict(prog.axes), shards,
                                  self._generator_state())
        self._record_epoch(t_epoch, n_steps)
        return out

    def _chaos_poison(self, n_steps: int) -> Optional[np.ndarray]:
        """Chaos site ``train.nan``, once per group epoch: every member
        reads the same column."""
        if _chaos.active() is None or _chaos.hook("train.nan", key=str(self._perf_key)) is None:
            return None
        poison = np.ones(n_steps, np.float32)
        poison[n_steps // 2] = np.nan
        return poison

    def _record_epoch(self, t0: float, steps: int) -> None:
        from rafiki_tpu_torch.obs.ledger import ledger
        from rafiki_tpu_torch.obs.perf import profiler, slo

        dt = time.monotonic() - t0
        cold = not self._warm
        self._warm = True
        telemetry.observe("train.cold_epoch_s" if cold else "train.epoch_s", dt)
        telemetry.inc("train.step_s", dt)
        telemetry.set_gauge("shard.group_width", self.width)
        ledger.add("compile_s" if cold else "step_s", dt)
        profiler.note_epoch(self._perf_key, dt, cold=cold, kind="sharded",
                            packing_key=self.packing_key, steps=steps,
                            group_width=self.width)
        slo.maybe_tick()

    def evaluate(self, dataset, batch_size: int) -> float:
        """Full-batch accuracy on member 0 (the remainder rows are
        dropped: exact scoring goes through the serial loop installed at
        trial completion)."""
        self._check_dataset(dataset, batch_size)
        dev = self.devices[0]
        member = self.program.install(self._members[0], self.program.gather(self.state, 0, dev))
        X, Y = get_device_dataset(dataset, dev)
        n_steps = dataset.size // batch_size
        idx = torch.arange(n_steps * batch_size, device=dev).reshape(n_steps, batch_size)
        with torch.inference_mode():
            c, n = self.program.program.eval_epoch(member[0], X, Y, idx)
        return int(c) / max(int(n), 1)

    def final_state(self):
        """The trial's serial state ``(module, opt, step, generator,
        hyper)`` on member 0's device, out of :func:`gather_state` (the
        completion hand-off)."""
        from rafiki_tpu_torch.shard.checkpoint import gather_state

        return self.program.install(self._members[0], gather_state(self.state))


def train_sharded(model, dataset_uri: str, devices, plan: Optional[ShardPlan] = None,
                  checkpoint_sink=None, abort=None,
                  resume_from=None) -> Tuple[ShardedTrainLoop, List[Dict[str, float]]]:
    """Train one TorchModel template as a group-sharded trial: the
    sharded lane's ``TorchModel.train``.

    * ``checkpoint_sink(epoch, loop)`` fires after every epoch with the
      live loop; the sink decides cadence and calls
      ``shard.checkpoint.save_sharded(store, trial_id, epoch, loop.state)``
      itself.
    * ``abort`` (a ``threading.Event``) is checked at each epoch boundary
      AFTER the sink ran: a set flag raises :class:`GroupAborted` with
      the last durable epoch.
    * ``resume_from=(params_store, trial_id)`` restores the newest
      sharded checkpoint at THIS group's width by reshard-on-restore and
      continues after its epoch.

    On completion the model gets a serial ``TrainLoop`` holding the
    gathered final state, so ``evaluate``/``dump_parameters``/``predict``
    behave exactly as after a serial ``train()``. Returns ``(loop,
    per-epoch metrics history)``.
    """
    from rafiki_tpu_torch.model.log import logger
    from rafiki_tpu_torch.ops.train import TrainLoop
    from rafiki_tpu_torch.shard import checkpoint as shard_ckpt

    ds = model._prepared_dataset(dataset_uri)
    model._dataset_meta = dict(ds.meta)
    num_classes, input_shape = model._dataset_arch(ds)
    model._planned_steps = model.epochs * max(1, ds.size // model.batch_size)
    fns = model._loop_fns(num_classes, input_shape)
    model._arch = (num_classes, tuple(input_shape))
    if plan is None:
        plan = ShardPlan(width=len(devices), family=type(model).__name__)
    pk_repr = repr(("sharded", type(model).__name__, plan.width))
    loop = ShardedTrainLoop(
        fns["init_fn"], fns["apply_eval"], fns["loss_fn"], fns["optimizer"],
        devices=devices, seed=model._seed, hyper=fns["hyper"],
        program_key=fns["program_key"], plan=plan, packing_key=pk_repr)

    start_epoch = 0
    if resume_from is not None:
        store, trial_id = resume_from
        latest = store.latest_checkpoint(trial_id)
        if latest is not None and shard_ckpt.is_manifest(latest[1]):
            loop.adopt(shard_ckpt.restore_sharded(store, latest[1], loop.state, loop.devices,
                                                  plan))
            start_epoch = int(latest[0]) + 1

    history: List[Dict[str, float]] = []
    logger.define_plot("Training", ["loss", "acc"], x_axis="epoch")
    for epoch in range(start_epoch, model.epochs):
        metrics = loop.run_epoch(ds, model.batch_size, epoch_seed=model._seed + epoch)
        logger.log(epoch=epoch, **metrics)
        history.append(dict(metrics, epoch=epoch))
        model._epochs_done = epoch
        if checkpoint_sink is not None:
            checkpoint_sink(epoch, loop)
        if abort is not None and abort.is_set():
            raise GroupAborted(epoch)
    # Completion hand-off: the one full gather, into a serial loop so
    # scoring and serving run unchanged.
    model._loop = TrainLoop(None, fns["apply_eval"], fns["loss_fn"], fns["optimizer"],
                            seed=model._seed, hyper=fns["hyper"],
                            program_key=fns["program_key"], initial_state=loop.final_state(),
                            device=loop.devices[0])
    model._loop.params.eval()
    return loop, history
