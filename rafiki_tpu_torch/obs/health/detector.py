"""Divergence detection: the host half of the numerics health plane.

The port's own copy of ``rafiki_tpu/obs/health/detector.py``. A
:class:`HealthMonitor` lives on each ``TrainLoop`` and
``PackedTrainLoop`` and reads the epoch-boundary sentinel scalars
(``obs/health/sentinel.py``). Two trip conditions, per trial:

* **nonfinite** - any non-finite gradient/loss element this epoch (or
  a non-finite global grad norm). Trips at once: NaNs never heal.
* **explosion** - the epoch's max grad norm exceeds ``RAFIKI_HEALTH_K``
  times the trial's running median for ``RAFIKI_HEALTH_HYSTERESIS``
  consecutive epochs, after ``RAFIKI_HEALTH_WARMUP`` clean epochs of
  history. Exploded samples are not absorbed into the median.

On a trip the monitor bumps ``health.divergences`` and returns a
verdict. A serial loop raises :class:`DivergenceError` with it; a
packed loop gets one ``Optional[verdict]`` per live member from
:meth:`HealthMonitor.observe_pack`, and the pack driver evicts only the
sick member. ``HealthMonitor(key, k)`` with ``k > 0`` follows the
pack's live width through :meth:`~HealthMonitor.evict_member` and
:meth:`~HealthMonitor.admit_member`.

On a trip the monitor also charges the trial's wall so far to the
goodput ledger's ``badput_s``, journals ``health/divergence`` (the
verdict) and dumps a flight record, as the JAX package's does.

Replay capsules (``obs/health/capsule.py``): when they are on
(``RAFIKI_HEALTH_CAPSULE``, default on, and a journal directory to
write them to), :meth:`HealthMonitor.snapshot_state` copies the
pre-epoch train state on its device into buffers reused from epoch to
epoch; at a trip the monitor takes the sick member's state to the host
and banks a capsule with the epoch's batch indices and poison column
(``health/capsule``; ``health/capsule_error`` when the write fails,
which never fails training). Without them no copy is taken.
"""

from __future__ import annotations

import itertools
import math
import os
import statistics
import time
from collections import deque
from typing import Any, Dict, List, Optional

from rafiki_tpu_torch import telemetry
from rafiki_tpu_torch.obs.journal import journal
from rafiki_tpu_torch.obs.ledger import ledger

#: Kill switch for detection ("0"/"off" disables it; the per-step
#: bundle still runs).
ENV_ENABLE = "RAFIKI_HEALTH"
#: Grad-norm explosion multiplier over the trial's running median.
ENV_K = "RAFIKI_HEALTH_K"
#: Clean epochs of history required before the explosion arm is live.
ENV_WARMUP = "RAFIKI_HEALTH_WARMUP"
#: Consecutive exploding epochs required to trip (nonfinite ignores this).
ENV_HYSTERESIS = "RAFIKI_HEALTH_HYSTERESIS"
#: "0"/"off" skips the pre-epoch state snapshot and capsule writes while
#: keeping detection and containment live.
ENV_CAPSULE = "RAFIKI_HEALTH_CAPSULE"

DEFAULT_K = 50.0
DEFAULT_WARMUP = 3
DEFAULT_HYSTERESIS = 2
_HISTORY = 32

_STATS: Dict[str, float] = {"divergences": 0, "capsules": 0, "evictions": 0,
                            "contained": 0, "badput_charged_s": 0.0}

# Capsule file sequence, process-wide: ``capsule-<pid>-<seq>.rcap`` names
# stay distinct across the monitors of one process (the JAX package
# counts per monitor, so a second loop's first capsule overwrites the
# first loop's).
_CAPSULE_SEQ = itertools.count()


def stats() -> Dict[str, float]:
    """The health plane's process-wide counts."""
    out = dict(_STATS)
    out["badput_charged_s"] = round(float(out["badput_charged_s"]), 6)
    return out


def reset_stats() -> None:
    for k in _STATS:
        _STATS[k] = 0.0 if k == "badput_charged_s" else 0


def note_eviction() -> None:
    """A pack member was evicted for divergence (``model/base.py``)."""
    _STATS["evictions"] += 1
    telemetry.inc("health.evictions")


def note_contained() -> None:
    """A diverged trial was contained by the worker (fail-fast, or a
    packed member skipped while its pack-mates are scored)."""
    _STATS["contained"] += 1
    telemetry.inc("health.contained")


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _on(name: str) -> bool:
    return os.environ.get(name, "1").strip().lower() not in (
        "0", "off", "false", "no")


class DivergenceError(RuntimeError):
    """A serial trial's numerics diverged; carries the verdict dict
    (kind, bad_step, diagnosis, capsule path) for the caller to surface."""

    def __init__(self, verdict: Dict[str, Any]):
        super().__init__(verdict.get("diagnosis", "numerics diverged"))
        self.verdict = verdict


class _MemberState:
    __slots__ = ("history", "streak", "bank", "tripped")

    def __init__(self) -> None:
        self.history: deque = deque(maxlen=_HISTORY)
        self.streak = 0
        self.bank = 0.0  # wall-clock this trial has consumed so far
        self.tripped = False


class HealthMonitor:
    """Per-loop divergence detector. ``k=0`` is a serial loop (one
    member); ``k>0`` follows a pack's live width through
    :meth:`evict_member` and :meth:`admit_member`."""

    def __init__(self, key: str, k: int = 0):
        self.key = str(key)
        self.k = int(k)
        self._members: List[_MemberState] = [_MemberState() for _ in range(max(1, self.k))]
        self._ctx: Optional[Dict[str, Any]] = None
        self._snapshot = None  # the reused device buffers (capsule.DeviceSnapshot)
        self.enabled = _on(ENV_ENABLE)
        self.capsules_enabled = self.enabled and _on(ENV_CAPSULE)
        self.explosion_k = _env_float(ENV_K, DEFAULT_K)
        self.warmup = max(1, _env_int(ENV_WARMUP, DEFAULT_WARMUP))
        self.hysteresis = max(1, _env_int(ENV_HYSTERESIS, DEFAULT_HYSTERESIS))

    def set_context(self, **ctx: Any) -> None:
        """Replay context from the model layer (``model`` identity dict,
        ``train_uri``, ``batch_size``, ``seed``, ``planned_steps``); a
        capsule carries it. A pack passes ``member_info``, a ``slot ->
        {model, seed}`` callable resolved at trip time."""
        self._ctx = dict(self._ctx or {}, **ctx)

    def _member_ctx(self, member: Optional[int]) -> Dict[str, Any]:
        ctx = dict(self._ctx or {})
        info = ctx.pop("member_info", None)
        if member is not None and callable(info):
            try:
                ctx.update(info(member) or {})
            except Exception:
                pass  # a stale slot must not break the trip path
        return ctx

    def evict_member(self, i: int) -> None:
        if self.k > 0 and 0 <= i < len(self._members):
            self._members.pop(i)
            self.k -= 1

    def admit_member(self) -> None:
        self._members.append(_MemberState())
        self.k += 1

    def snapshot_state(self, state: Any) -> Any:
        """The train state as it is BEFORE the epoch runs, which a replay
        capsule needs (the epoch moves params, moments and generators in
        place). A copy on the state's device, into buffers reused from
        epoch to epoch (``capsule.DeviceSnapshot``): a serial loop's
        ``(module, opt_state, step, generator, hyper)`` or a pack's
        stacked ``PackedState``. Returns None, with no copy, when
        capsules are off or there is no journal directory to bank them in."""
        if not self.capsules_enabled:
            return None
        from rafiki_tpu_torch.obs.health import capsule as capsule_mod

        if capsule_mod.capsule_dir() is None:
            return None
        if self._snapshot is None:
            self._snapshot = capsule_mod.DeviceSnapshot()
        self._snapshot.take(state)
        return self._snapshot

    # -- observation ---------------------------------------------------------

    def observe(self, health: Dict[str, float], *, t0: Optional[float] = None,
                epoch_seed: Optional[int] = None, idx: Any = None,
                poison: Any = None, snapshot: Any = None) -> Optional[Dict[str, Any]]:
        """Serial epoch boundary: returns a verdict dict on a trip, else
        None. The caller (``TrainLoop``) raises DivergenceError on it.
        ``idx`` is the epoch's ``(n_steps, batch)`` index matrix,
        ``poison`` its chaos column (None when clean), ``snapshot`` what
        :meth:`snapshot_state` returned before the epoch."""
        return self._observe(0, health, t0=t0, epoch_seed=epoch_seed, idx=idx,
                             poison=poison, snapshot=snapshot, member=None)

    def observe_pack(self, health_rows: List[Dict[str, float]], *,
                     t0: Optional[float] = None, epoch_seeds: Any = None,
                     idx: Any = None, poison: Any = None, snapshot: Any = None
                     ) -> List[Optional[Dict[str, Any]]]:
        """Packed epoch boundary: one Optional[verdict] per live member,
        in slot order. ``idx``/``poison`` are the ``(n_steps, k, ...)``
        epoch arrays; the stacked snapshot is sliced to a member's serial
        shape only when that member's capsule is written."""
        return [self._observe(
            j, health, t0=t0, epoch_seed=None if epoch_seeds is None else epoch_seeds[j],
            idx=None if idx is None else idx[:, j],
            poison=None if poison is None else poison[:, j], snapshot=snapshot, member=j)
            for j, health in enumerate(health_rows)]

    def _median_bar(self, st: _MemberState) -> Optional[float]:
        if len(st.history) < self.warmup:
            return None
        median = statistics.median(st.history)
        return self.explosion_k * median if median > 0.0 else None

    def _classify(self, st: _MemberState, health: Dict[str, float]) -> Optional[str]:
        gn = float(health.get("health_grad_norm", 0.0))
        nf = int(health.get("health_nonfinite", 0))
        if nf > 0 or not math.isfinite(gn):
            return "nonfinite"
        bar = self._median_bar(st)
        if bar is not None and gn > bar and st.streak + 1 >= self.hysteresis:
            return "explosion"
        return None

    def _observe(self, j: int, health: Dict[str, float], *, t0: Optional[float],
                 epoch_seed: Optional[int], idx: Any, poison: Any, snapshot: Any,
                 member: Optional[int]) -> Optional[Dict[str, Any]]:
        if not self.enabled or not health:
            return None
        st = self._members[j]
        if t0 is not None:
            # A pack's epoch wall is shared: each member banks its share.
            st.bank += (time.monotonic() - t0) / max(1, self.k)
        if st.tripped:
            return None
        kind = self._classify(st, health)
        if kind is None:
            bar = self._median_bar(st)
            if bar is not None and float(health.get("health_grad_norm", 0.0)) > bar:
                st.streak += 1  # above the bar but under the hysteresis
            else:
                st.streak = 0
                st.history.append(float(health.get("health_grad_norm", 0.0)))
            return None
        return self._trip(st, kind, health, epoch_seed=epoch_seed, idx=idx, poison=poison,
                          snapshot=snapshot, member=member)

    def _diagnosis(self, kind: str, st: _MemberState, health: Dict[str, float]) -> str:
        gn = float(health.get("health_grad_norm", float("nan")))
        if kind == "nonfinite":
            return (f"non-finite numerics at step "
                    f"{int(health.get('health_bad_step', -1))}: "
                    f"{int(health.get('health_nonfinite', 0))} bad elements, "
                    f"grad_norm={gn:.4g}")
        median = statistics.median(st.history) if st.history else 0.0
        return (f"grad-norm explosion: {gn:.4g} > {self.explosion_k:g}x "
                f"running median {median:.4g} "
                f"({self.hysteresis} consecutive epochs)")

    def _trip(self, st: _MemberState, kind: str, health: Dict[str, float], *,
              epoch_seed: Optional[int], idx: Any, poison: Any, snapshot: Any,
              member: Optional[int]) -> Dict[str, Any]:
        st.tripped = True
        capsule_path = None
        if self.capsules_enabled and snapshot is not None and self._ctx:
            try:
                from rafiki_tpu_torch.obs.health import capsule as capsule_mod

                capsule_path = capsule_mod.write(
                    self, member=member, kind=kind, health=health, epoch_seed=epoch_seed,
                    idx=idx, poison=poison, state=snapshot.member(member),
                    seq=next(_CAPSULE_SEQ))
            except Exception as e:  # a capsule must never kill training
                journal.record("health", "capsule_error", key=self.key,
                               error=f"{type(e).__name__}: {e}")
        if capsule_path is not None:
            _STATS["capsules"] += 1
            telemetry.inc("health.capsules")
        wasted = st.bank
        if wasted > 0.0:
            # The trial's whole wall so far is retroactively badput: the
            # epochs ran but computed garbage.
            ledger.add("badput_s", wasted)
            _STATS["badput_charged_s"] += wasted
        _STATS["divergences"] += 1
        telemetry.inc("health.divergences")
        verdict = {
            "divergence": kind,
            "key": self.key,
            "member": member,
            "bad_step": int(health.get("health_bad_step", -1)),
            "epoch_seed": epoch_seed,
            "grad_norm": float(health.get("health_grad_norm", float("nan"))),
            "update_norm": float(health.get("health_update_norm", float("nan"))),
            "nonfinite": int(health.get("health_nonfinite", 0)),
            "badput_s": round(wasted, 6),
            "capsule": str(capsule_path) if capsule_path else None,
            "diagnosis": self._diagnosis(kind, st, health),
        }
        journal.record("health", "divergence", **verdict)
        from rafiki_tpu_torch.obs import recorder

        recorder.dump("health:divergence", extra={"health": verdict})
        return verdict
