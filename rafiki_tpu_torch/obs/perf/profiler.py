"""Continuous profiler: each training program's FLOPs x its measured epochs.

The port's counterpart of ``rafiki_tpu/obs/perf/profiler.py``. Two data
feeds, one store:

* **Cost capture** — the JAX package AOT-compiles a program and reads
  XLA's cost analysis. The port counts the step instead: the first
  eager step of a program's first epoch runs under
  ``torch.utils.flop_counter.FlopCounterMode``. The train loop asks
  :func:`capture_cost` for a :class:`CostCapture` and hands its
  ``wrap`` the step body of ``Program.train_steps`` (or
  ``PackedProgram.train_steps``); the wrapper counts the body's first
  call only. On the card that call is step 0 of ``ops/graphs.py
  StepRunner.run``, one of its ``GRAPH_WARMUP_STEPS`` eager steps, so
  the count adds no step, changes no state and never runs under a
  capture. One count per program key per process, only in a process
  that journals (the counter costs host time: one Python dispatch for
  each op of the step), and ``RAFIKI_PERF_COST_CAPTURE=0`` turns it off.
  Captured costs are journaled (``perf/cost``), so they survive the
  process and the CLI joins them across processes.

  What the count holds: the matmuls, convolutions and their backward
  products that FlopCounterMode knows, at 2 flops a multiply-add, each
  convolution over its full window (as cuDNN computes it). It leaves
  out the elementwise work (norms, activations, pooling, Adam, the
  sentinels) that XLA's count includes; XLA in turn counts only the
  in-bounds taps of a padded convolution (1/9 of a 3x3 window at 1x1).
  So the two counts of one step differ both ways; for a VGG the second
  wins. A pack's step is vmapped over its k members; its count is theirs
  together. ``flops`` is one step's, as the JAX package records it.
  ``bytes_accessed`` stays null (FlopCounterMode has no counterpart),
  and so does ``peak_hbm_bytes``: measuring it would reset the
  process's peak memory statistics, which are other readers'.

* **Step sampling** — every epoch the train loop calls
  :func:`note_epoch` with the measured wall split and the epoch's step
  count. Warm samples feed a per-program
  :class:`~rafiki_tpu_torch.obs.perf.anomaly.EwmaMad` detector; an
  anomalous epoch journals ``perf/anomaly``, bumps the
  ``perf.anomalies`` counter, and charges the excess wall over the
  expected mean to the goodput ledger's ``badput_s`` bucket.

The joined view: achieved FLOP/s is ``flops x steps / step_p50_s`` (a
program's median warm epoch, over that epoch's steps), and MFU is that
over the peak of the card and the program's compute dtype
(:data:`PEAK_FLOPS`; null on the CPU or an unknown card). The JAX
package divides one step's flops by a whole epoch's seconds (its cost
analysis counts a ``lax.scan`` body once), which understates its MFU by
the steps of an epoch; the port carries the step count. The view is
exposed three ways: the ``perf`` telemetry collector, the
``perf/cost`` + ``perf/step`` journal records, and ``python -m
rafiki_tpu_torch.obs profile``. Program identities are long key reprs;
metrics key on a short sha1 prefix (``key_hash``) and the full repr
travels in the journal.

Import-light by design: torch is only touched inside the functions the
train loops call, so the obs CLI reads journals with no torch at all.
"""

from __future__ import annotations

import hashlib
import os
import threading
import time
from collections import OrderedDict, deque
from typing import Any, Callable, Dict, Optional

from rafiki_tpu_torch import telemetry
from rafiki_tpu_torch.obs.journal import journal
from rafiki_tpu_torch.obs.ledger import ledger
from rafiki_tpu_torch.obs.perf.anomaly import EwmaMad

ENV_COST_CAPTURE = "RAFIKI_PERF_COST_CAPTURE"

#: Dense peak FLOP/s by card and compute dtype: NVIDIA H100 Tensor Core
#: GPU datasheet, half of each "with sparsity" Tensor Core figure for
#: bfloat16 and TF32, and the FP32 (CUDA core) figure, which is what
#: float32 matmuls and convolutions get with TF32 off.
PEAK_FLOPS: Dict[str, Dict[str, float]] = {
    "H100 SXM": {"bfloat16": 989.5e12, "tfloat32": 494.5e12, "float32": 67e12},
    "H100 PCIe": {"bfloat16": 756.5e12, "tfloat32": 378e12, "float32": 51e12},
}

#: HBM bandwidth in bytes/s by card, keyed as :data:`PEAK_FLOPS`: the
#: same datasheet's 3.35 TB/s (SXM) and 2.0 TB/s (PCIe).
HBM_BYTES_S: Dict[str, float] = {"H100 SXM": 3.35e12, "H100 PCIe": 2.0e12}

#: Bounded stores: distinct programs per process / warm samples per program.
MAX_PROGRAMS = 64
STEP_RING = 256


def _key_str(key: Any) -> str:
    return key if isinstance(key, str) else repr(key)


def key_hash(key: Any) -> str:
    return hashlib.sha1(_key_str(key).encode()).hexdigest()[:10]


def cost_capture_enabled() -> bool:
    """Counting runs in a process that journals, unless the env turns it
    off: unjournaled processes pay nothing."""
    return (journal.configured
            and os.environ.get(ENV_COST_CAPTURE, "1") not in ("0", "false", "off"))


def card_model(device_name: Optional[str]) -> Optional[str]:
    """The :data:`PEAK_FLOPS` row of a ``torch.cuda.get_device_name``
    string ("NVIDIA H100 80GB HBM3" is the SXM card), or None."""
    if not device_name or "H100" not in device_name or "NVL" in device_name:
        return None
    return "H100 PCIe" if "PCIe" in device_name else "H100 SXM"


def peak_flops(device_name: Optional[str], dtype: Optional[str],
               tf32: bool = False) -> Optional[float]:
    """The MFU denominator for a program of compute ``dtype`` (a torch
    dtype's name: "bfloat16", "float32", ...) on the named card; a
    float32 program whose matmuls or convolutions may use TF32 is held
    to the TF32 peak. None on the CPU or an unknown card."""
    row = PEAK_FLOPS.get(card_model(device_name) or "")
    if row is None or not dtype:
        return None
    if dtype == "float32" and tf32:
        dtype = "tfloat32"
    return row.get(dtype)


def hbm_bandwidth(device_name: Optional[str]) -> Optional[float]:
    """The :data:`HBM_BYTES_S` figure of the named card; None on the CPU
    or an unknown card."""
    return HBM_BYTES_S.get(card_model(device_name) or "")


class _ProgramStats:
    """One program's cost model + observed-epoch reservoir."""

    def __init__(self, key: Any, kind: str, k: int):
        self.key = _key_str(key)
        self.hash = key_hash(key)
        self.kind = kind
        self.k = int(k)
        self.cost: Optional[Dict[str, Any]] = None
        self.warm = deque(maxlen=STEP_RING)  # (compute_s, steps)
        self.warm_count = 0
        self.warm_sum = 0.0
        self.cold_count = 0
        self.cold_sum = 0.0
        self.feed_sum = 0.0
        self.detector = EwmaMad()
        self.cold_detector = EwmaMad(warmup=2)

    def summary(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"kind": self.kind, "k": self.k,
                               "epochs": self.warm_count,
                               "cold_epochs": self.cold_count}
        if self.warm_count:
            out["step_mean_s"] = self.warm_sum / self.warm_count
            ordered = sorted(self.warm)
            out["step_p50_s"], out["steps"] = ordered[len(ordered) // 2]
            out["step_min_s"] = ordered[0][0]
        if self.cold_count:
            out["compile_mean_s"] = self.cold_sum / self.cold_count
        if self.feed_sum:
            out["feed_s"] = self.feed_sum
        if self.cost:
            out.update({k: v for k, v in self.cost.items() if v is not None})
            flops = self.cost.get("flops")
            p50 = out.get("step_p50_s")
            if flops and p50 and out.get("steps"):
                out["achieved_flops_s"] = flops * out["steps"] / p50
                peak = self.cost.get("peak_flops")
                if peak:
                    out["mfu"] = out["achieved_flops_s"] / peak
        return out


_lock = threading.Lock()
_programs: "OrderedDict[str, _ProgramStats]" = OrderedDict()
_hbm_peak = 0.0
_mem_broken = False


def _get(key: Any, kind: str, k: int) -> _ProgramStats:
    ks = _key_str(key)
    stats = _programs.get(ks)
    if stats is None:
        stats = _ProgramStats(key, kind, k)
        _programs[ks] = stats
        while len(_programs) > MAX_PROGRAMS:
            _programs.popitem(last=False)
    return stats


def _sample_device_mem() -> None:
    """Track the process-lifetime peak of the bytes allocated on the
    visible cards, summed. Without CUDA one failed probe disables it."""
    global _hbm_peak, _mem_broken
    if _mem_broken:
        return
    try:
        import torch

        if not torch.cuda.is_available():
            _mem_broken = True
            return
        total = float(sum(torch.cuda.memory_allocated(i)
                          for i in range(torch.cuda.device_count())))
        if total > _hbm_peak:
            _hbm_peak = total
            telemetry.set_gauge("perf.hbm_peak_bytes", total)
    except Exception:
        _mem_broken = True


class CostCapture:
    """Counts the FLOPs of one program's step (module docstring).

    ``wrap(body)`` returns the body to run in its place: its first call
    runs under FlopCounterMode, its second is timed too (the counted
    step's extra wall time is the difference), the rest pass through.
    ``close()``, once the epoch has run, records the count."""

    def __init__(self, key: Any, kind: str, k: int, device: Any, dtype: Any):
        self.key, self.kind, self.k = key, kind, int(k)
        self.device = device
        self.dtype = dtype
        self.flops: Optional[int] = None
        self._walls = []
        self._calls = 0

    def wrap(self, body: Callable[[], Any]) -> Callable[[], Any]:
        def counted():
            n = self._calls
            self._calls += 1
            if n > 1:
                return body()
            t0 = time.monotonic()
            if n == 0:
                from torch.utils.flop_counter import FlopCounterMode

                with FlopCounterMode(display=False) as mode:
                    out = body()
                self.flops = int(mode.get_total_flops())
            else:
                out = body()
            self._walls.append(time.monotonic() - t0)
            return out

        return counted

    def _card(self):
        """(device name, TF32 allowed) of where the step ran."""
        import torch

        device = torch.device(self.device) if self.device is not None else None
        if device is None or device.type != "cuda":
            return "cpu", False
        tf32 = torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32
        return torch.cuda.get_device_name(device), tf32

    def close(self) -> Optional[Dict[str, Any]]:
        """Record the count (``perf/cost``); returns the cost dict, or
        None when the body never ran or counted nothing."""
        cost: Optional[Dict[str, Any]] = None
        if self.flops:
            name, tf32 = self._card()
            dtype = str(self.dtype).replace("torch.", "") if self.dtype is not None else None
            extra = (self._walls[0] - self._walls[1] if len(self._walls) > 1
                     else self._walls[0])
            cost = {"flops": float(self.flops), "bytes_accessed": None,
                    "peak_hbm_bytes": None, "cost_capture_s": max(extra, 0.0),
                    "device": name, "dtype": dtype,
                    "peak_flops": peak_flops(name, dtype, tf32)}
        with _lock:
            _get(self.key, self.kind, self.k).cost = cost
        if cost is not None:
            telemetry.inc("perf.cost_captures")
            journal.record("perf", "cost", key=_key_str(self.key), key_hash=key_hash(self.key),
                           program_kind=self.kind, k=self.k, **cost)
        return cost


def capture_cost(key: Any, kind: str = "serial", k: int = 1, device: Any = None,
                 dtype: Any = None) -> Optional[CostCapture]:
    """A :class:`CostCapture` for the program ``key`` running on
    ``device`` in compute ``dtype``, or None when counting is off or the
    key was counted (or is being counted) already. Idempotent per key."""
    if not cost_capture_enabled():
        return None
    with _lock:
        stats = _get(key, kind, k)
        if stats.cost is not None:
            return None
        stats.cost = {}  # claim under the lock; count outside it
    return CostCapture(key, kind, k, device, dtype)


def note_epoch(key: Any, dt: float, feed_s: float = 0.0, cold: bool = False,
               kind: str = "serial", k: int = 1,
               packing_key: Optional[str] = None,
               steps: Optional[int] = None,
               group_width: Optional[int] = None) -> Optional[Dict[str, float]]:
    """Record one epoch's wall split and step count for ``key``; runs
    the anomaly detector on the compute portion and returns its report
    (already journaled / countered / ledgered) when it fires.
    ``packing_key`` (the repr of the model's packing key, from a packed
    or sharded loop), ``steps`` and ``group_width`` (a sharded loop's
    width; null elsewhere) ride the ``perf/step`` record."""
    compute_s = max(dt - feed_s, 0.0)
    with _lock:
        stats = _get(key, kind, k)
        if cold:
            stats.cold_count += 1
            stats.cold_sum += compute_s
            report = stats.cold_detector.observe(compute_s)
        else:
            stats.warm_count += 1
            stats.warm_sum += compute_s
            stats.warm.append((compute_s, int(steps or 1)))
            report = stats.detector.observe(compute_s)
        stats.feed_sum += feed_s
        h = stats.hash
    _sample_device_mem()
    journal.record("perf", "step", key_hash=h, dt=dt, feed_s=feed_s,
                   cold=bool(cold), program_kind=kind, k=int(k),
                   packing_key=packing_key,
                   group_width=int(group_width) if group_width else None,
                   steps=int(steps) if steps else None)
    if report is not None:
        telemetry.inc("perf.anomalies")
        # The wall this epoch spent over its expected mean bought no
        # extra training — book it as badput so degraded goodput and
        # the anomaly stream agree.
        ledger.add("badput_s", max(report["value"] - report["mean"], 0.0))
        journal.record("perf", "anomaly", key_hash=h, key=_key_str(key),
                       program_kind=kind,
                       phase="compile" if cold else "step", **report)
    return report


def snapshot() -> Dict[str, Any]:
    """The ``perf`` telemetry collector: per-program joined summaries
    keyed by key_hash, plus process-wide aggregates."""
    with _lock:
        programs = {s.hash: s.summary() for s in _programs.values()}
        out: Dict[str, Any] = {"n_programs": len(programs),
                               "programs": programs}
        if _hbm_peak:
            out["hbm_peak_bytes"] = _hbm_peak
    return out


def reset() -> None:
    """Drop all profiler state (tests, and a smoke phase that profiles
    programs an earlier phase ran unjournaled)."""
    global _hbm_peak, _mem_broken
    with _lock:
        _programs.clear()
        _hbm_peak = 0.0
        _mem_broken = False


telemetry.register_collector("perf", snapshot)
