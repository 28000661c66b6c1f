"""SLO-burn-driven autoscale controller.

The port's own copy of ``rafiki_tpu/autoscale/controller.py``.

A tick-driven reconciler in the style of the chaos plane: injectable
clock, explicit seed, byte-deterministic decisions. Each tick reads
one sensor snapshot — SLO burn state (obs/perf/slo.py), gateway queue
depth / inflight / shed rate, and the search plane's
``effective_trials_per_hour`` gauge — and emits a
:class:`ScaleDecision` per lane:

  * ``inference`` — worker count behind the serving gateway (spawn via
    the services-manager surface, drain via the worker drain path with
    the drain→reap→freed ordering contract in :mod:`actuators`).
  * ``sweep`` — chip count of a live mesh sweep (grow/shrink through
    :class:`rafiki_tpu_torch.scheduler.mesh.ElasticHandle`, riding the
    existing elastic re-pack machinery).

Stability machinery, all per lane:

  * **hysteresis band** — scale up at ``pressure >= up_threshold``,
    down at ``pressure <= down_threshold``, hold in between, so a
    signal hovering near one edge cannot oscillate the fleet.
  * **per-direction cooldowns** — a fresh scale-up does not block a
    scale-down (and vice versa); each direction rate-limits itself.
  * **flap damping** — direction flips inside ``flap_window_s`` grow a
    guard interval exponentially (``flap_backoff ** flips``, capped),
    so an adversarial oscillating signal converges to a bounded
    actuation count instead of thrashing (the
    ``autoscale-flap-damping`` chaos scenario proves it). Damping can
    be disabled (``damping=False`` / RAFIKI_AUTOSCALE_DAMPING=0) only
    so tests and the smoke's vacuous-pass polarity can demonstrate the
    flapping it prevents.

Every decision — including holds — journals ``autoscale/decision``
with its full sensor snapshot, so ``obs autoscale`` replays exactly
why each action fired (or didn't). An optional twin pre-gate forecasts
the actuation before real hardware moves: a veto journals but never
actuates. Knobs: ``RAFIKI_AUTOSCALE`` (the admin plane's opt-in),
``RAFIKI_AUTOSCALE_{MIN,MAX,UP_THRESHOLD,DOWN_THRESHOLD,UP_COOLDOWN_S,
DOWN_COOLDOWN_S,STEP}`` (a lane's :meth:`LaneSpec.from_env`),
``RAFIKI_AUTOSCALE_{SEED,TICK_S,DAMPING,FLAP_WINDOW_S,FLAP_FLIPS,
FLAP_BACKOFF,FLAP_GUARD_S,FLAP_GUARD_CAP_S}`` (the controller),
``RAFIKI_AUTOSCALE_TARGET_EPH`` (the sweep lane's target) and
``RAFIKI_AUTOSCALE_PREWARM`` (:mod:`prewarm` at job admission).
"""

from __future__ import annotations

import dataclasses
import os
import random
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from rafiki_tpu_torch import chaos, telemetry
from rafiki_tpu_torch.obs.journal import journal as _journal
from rafiki_tpu_torch.obs.perf import slo as _slo

ENV_PREFIX = "RAFIKI_AUTOSCALE_"


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(ENV_PREFIX + name)
    if raw is None:
        return default
    try:
        return float(raw)
    except ValueError:
        return default


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(ENV_PREFIX + name)
    if raw is None:
        return default
    try:
        return int(raw)
    except ValueError:
        return default


def _env_bool(name: str, default: bool) -> bool:
    raw = os.environ.get(ENV_PREFIX + name)
    if raw is None:
        return default
    return raw.lower() in ("1", "true", "yes", "on")


def enabled() -> bool:
    """Whether the admin plane should run a controller at all
    (RAFIKI_AUTOSCALE=1; default off — elasticity is opt-in)."""
    return os.environ.get("RAFIKI_AUTOSCALE", "").lower() in (
        "1", "true", "yes", "on")


def prewarm_enabled() -> bool:
    """Whether job admission pre-warms compiled packs
    (RAFIKI_AUTOSCALE_PREWARM=1; default off)."""
    return _env_bool("PREWARM", False)


# -- sensors -----------------------------------------------------------------


def read_sensors(gateway: Any = None,
                 slo_engine: Optional[_slo.SloEngine] = None) -> Dict[str, Any]:
    """One JSON-able snapshot of everything the controller reads: SLO
    state from the burn engine, admission context from the gateway,
    and the search plane's throughput gauge. The snapshot is embedded
    verbatim in every ``autoscale/decision`` record."""
    eng = slo_engine if slo_engine is not None else _slo.engine
    col = eng.collector()
    burns = [st.get("burn") for st in col["state"].values()
             if st.get("breaching") and st.get("burn") is not None]
    out: Dict[str, Any] = {
        "slo_breaching": col["breaching"],
        "slo_burn": max(burns) if burns else 0.0,
        "slo": col["state"],
        "effective_trials_per_hour":
            telemetry.get_gauge("search.effective_trials_per_hour"),
    }
    if gateway is not None:
        out.update(gateway.sensors())
    return out


def inference_pressure(sensors: Dict[str, Any]) -> Tuple[Optional[float], str]:
    """Serving-lane pressure: the max of normalized burn, queue
    fraction, and (weighted) shed rate — 1.0 is 'at the line'. All
    three at zero reads as idle capacity, which is the scale-down
    signal the hysteresis band gates."""
    components = {
        "slo_burn": (float(sensors.get("slo_burn") or 0.0)
                     if sensors.get("slo_breaching") else 0.0),
        "queue_frac": float(sensors.get("queue_frac") or 0.0),
        "shed": float(sensors.get("shed_rate") or 0.0) * 10.0,
    }
    reason = max(components, key=lambda k: components[k])
    return components[reason], reason


def sweep_pressure(sensors: Dict[str, Any]) -> Tuple[Optional[float], str]:
    """Sweep-lane pressure: target / actual effective trials per hour.
    No target configured (RAFIKI_AUTOSCALE_TARGET_EPH) or no ledger
    data yet -> None, which the controller treats as hold — scaling a
    sweep on a missing signal is how fleets thrash."""
    target = _env_float("TARGET_EPH", 0.0)
    if target <= 0.0:
        return None, "no-target"
    eph = sensors.get("effective_trials_per_hour")
    if eph is None or eph <= 0.0:
        return None, "no-data"
    return target / float(eph), "eph"


# -- decisions ---------------------------------------------------------------


@dataclasses.dataclass
class LaneSpec:
    """One scaling lane's policy: bounds, hysteresis band, cooldowns,
    and the pressure function mapping a sensor snapshot to a scalar."""

    name: str
    min_size: int = 1
    max_size: int = 8
    up_threshold: float = 1.0
    down_threshold: float = 0.3
    up_cooldown_s: float = 5.0
    down_cooldown_s: float = 30.0
    step: int = 1
    pressure_fn: Callable[[Dict[str, Any]], Tuple[Optional[float], str]] = \
        inference_pressure

    @classmethod
    def from_env(cls, name: str, **overrides: Any) -> "LaneSpec":
        base = dict(
            min_size=_env_int("MIN", 1),
            max_size=_env_int("MAX", 8),
            up_threshold=_env_float("UP_THRESHOLD", 1.0),
            down_threshold=_env_float("DOWN_THRESHOLD", 0.3),
            up_cooldown_s=_env_float("UP_COOLDOWN_S", 5.0),
            down_cooldown_s=_env_float("DOWN_COOLDOWN_S", 30.0),
            step=_env_int("STEP", 1),
        )
        base.update(overrides)
        return cls(name=name, **base)


@dataclasses.dataclass
class ScaleDecision:
    """One lane's verdict for one tick — journaled whole, holds
    included, so the decision stream replays without gaps."""

    lane: str
    direction: str            # "up" | "down" | "hold"
    current: Optional[int]
    target: Optional[int]
    pressure: Optional[float]
    reason: str
    tick_ts: float = 0.0      # the controller CLOCK's now — journal ts
    # stays wall time, but flap replay (`obs autoscale --check`) reads
    # this so fake-clock runs stay byte-deterministic
    cooldown_s: float = 0.0   # effective (damped) cooldown that gated
    damp_factor: float = 1.0
    damped: bool = False      # held (or stretched) by flap damping
    vetoed: bool = False      # twin pre-gate said no
    forecast: Optional[Dict[str, Any]] = None
    actuated: bool = False
    sensors: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


class AutoscaleController:
    """The closed loop. Deterministic given (clock, seed, sensors):
    construct with fake clocks and stub actuators in tests, with the
    real surfaces in the admin plane. ``tick()`` is the whole control
    law; ``start()`` wraps it in a daemon thread for live use."""

    def __init__(self,
                 lanes: Sequence[LaneSpec],
                 sensor_fn: Callable[[], Dict[str, Any]],
                 actuators: Dict[str, Any],
                 clock: Callable[[], float] = time.monotonic,
                 seed: Optional[int] = None,
                 tick_s: Optional[float] = None,
                 damping: Optional[bool] = None,
                 pregate_fn: Optional[Callable[..., Optional[Dict[str, Any]]]] = None,
                 flap_window_s: Optional[float] = None,
                 flap_flips: Optional[int] = None,
                 flap_backoff: Optional[float] = None,
                 flap_guard_s: Optional[float] = None,
                 flap_guard_cap_s: Optional[float] = None,
                 tick_global_slo: bool = True):
        self.lanes = list(lanes)
        self._sensor_fn = sensor_fn
        self._actuators = dict(actuators)
        self._clock = clock
        self.seed = _env_int("SEED", 0) if seed is None else int(seed)
        self._rng = random.Random(self.seed)
        self.tick_s = _env_float("TICK_S", 1.0) if tick_s is None else tick_s
        self.damping = (_env_bool("DAMPING", True) if damping is None
                        else bool(damping))
        self._pregate_fn = pregate_fn
        self.flap_window_s = (_env_float("FLAP_WINDOW_S", 60.0)
                              if flap_window_s is None else flap_window_s)
        self.flap_flips = (_env_int("FLAP_FLIPS", 2)
                           if flap_flips is None else flap_flips)
        self.flap_backoff = (_env_float("FLAP_BACKOFF", 2.0)
                             if flap_backoff is None else flap_backoff)
        self.flap_guard_s = (_env_float("FLAP_GUARD_S", 2.0)
                             if flap_guard_s is None else flap_guard_s)
        self.flap_guard_cap_s = (_env_float("FLAP_GUARD_CAP_S", 64.0)
                                 if flap_guard_cap_s is None
                                 else flap_guard_cap_s)
        self._tick_global_slo = tick_global_slo
        # (lane, direction) -> last actuation ts; lane -> (ts, dir) tail
        self._last_act: Dict[Tuple[str, str], float] = {}
        self._history: Dict[str, deque] = {
            lane.name: deque(maxlen=64) for lane in self.lanes}
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        telemetry.register_collector("autoscale", self.collector)

    # -- introspection -------------------------------------------------------

    def collector(self) -> Dict[str, Any]:
        lanes: Dict[str, Any] = {}
        for lane in self.lanes:
            try:
                size = self._actuators[lane.name].size()
            except Exception:
                size = None
            lanes[lane.name] = {
                "size": size,
                "actuations": len(self._history[lane.name]),
                "flips": self._recent_flips(lane.name, self._clock()),
            }
        return {
            "damping": int(self.damping),
            "decisions": telemetry.get_counter("autoscale.decisions"),
            "lanes": lanes,
        }

    def actuation_count(self, lane_name: str) -> int:
        """Total actuations recorded for a lane (bounded-actuation
        assertions in the flap scenario/smoke)."""
        return len(self._history[lane_name])

    def _recent_flips(self, lane_name: str, now: float) -> int:
        """Direction flips among this lane's actuations inside the
        flap window ending at ``now``."""
        recent = [(ts, d) for ts, d in self._history[lane_name]
                  if now - ts <= self.flap_window_s]
        return sum(1 for (_, a), (_, b) in zip(recent, recent[1:]) if a != b)

    def damp_factor(self, lane_name: str, now: float) -> float:
        """Exponential flap multiplier: 1.0 below the flip threshold
        (or with damping off), else ``backoff ** excess_flips`` capped
        so the guard cannot grow unbounded."""
        if not self.damping:
            return 1.0
        flips = self._recent_flips(lane_name, now)
        if flips < self.flap_flips:
            return 1.0
        cap = max(1.0, self.flap_guard_cap_s / max(self.flap_guard_s, 1e-9))
        return min(cap, self.flap_backoff ** (flips - self.flap_flips + 1))

    # -- the control law -----------------------------------------------------

    def tick(self, now: Optional[float] = None) -> List[ScaleDecision]:
        """One reconcile pass: sense, decide per lane, actuate what
        survived the gates. Returns every decision (holds included)."""
        now = self._clock() if now is None else now
        if self._tick_global_slo:
            # SLO wiring: the control loop itself keeps burn windows
            # fresh even when no request/epoch path is ticking them.
            try:
                _slo.maybe_tick()
            except Exception:
                pass
        try:
            # Chaos site: a sensor-plane fault (error mode) must leave
            # the fleet exactly where it is — never actuate blind.
            chaos.hook("autoscale.sensor")
            sensors = self._sensor_fn()
        except Exception as e:
            telemetry.inc("autoscale.sensor_errors")
            decisions = [ScaleDecision(lane=lane.name, direction="hold",
                                       current=None, target=None,
                                       pressure=None,
                                       reason="sensor-error",
                                       tick_ts=now,
                                       sensors={"error": str(e)})
                         for lane in self.lanes]
            for d in decisions:
                self._record(d)
            return decisions
        decisions = []
        for lane in self.lanes:
            d = self._decide(lane, sensors, now)
            if d.direction != "hold" and not d.vetoed:
                self._actuate(lane, d, now)
            self._record(d)
            decisions.append(d)
        return decisions

    def _decide(self, lane: LaneSpec, sensors: Dict[str, Any],
                now: float) -> ScaleDecision:
        d = ScaleDecision(lane=lane.name, direction="hold", current=None,
                          target=None, pressure=None, reason="",
                          tick_ts=now, sensors=sensors)
        try:
            d.current = int(self._actuators[lane.name].size())
        except Exception as e:
            d.reason = "size-error"
            d.sensors = dict(sensors, size_error=str(e))
            return d
        pressure, preason = lane.pressure_fn(sensors)
        d.pressure = pressure
        if pressure is None:
            d.reason = preason
            return d
        if pressure >= lane.up_threshold:
            want = "up"
        elif pressure <= lane.down_threshold:
            want = "down"
        else:
            d.reason = "in-band"
            return d
        d.reason = preason
        if want == "up" and d.current >= lane.max_size:
            d.reason = "at-max"
            return d
        if want == "down" and d.current <= lane.min_size:
            d.reason = "at-min"
            return d
        # Per-direction cooldown: the same direction rate-limits itself.
        base = lane.up_cooldown_s if want == "up" else lane.down_cooldown_s
        factor = self.damp_factor(lane.name, now)
        d.damp_factor = factor
        d.cooldown_s = base * factor
        last_same = self._last_act.get((lane.name, want))
        if last_same is not None and now - last_same < d.cooldown_s:
            d.reason = "cooldown"
            d.damped = factor > 1.0
            return d
        # Flap guard: a direction FLIP additionally waits out a guard
        # interval from the last actuation in ANY direction; the guard
        # grows exponentially with recent flips. This is the damping
        # that makes an oscillating signal converge.
        history = self._history[lane.name]
        if history:
            last_ts, last_dir = history[-1]
            if last_dir != want:
                guard = (self.flap_guard_s * factor if self.damping else 0.0)
                if now - last_ts < guard:
                    d.reason = "flap-guard"
                    d.damped = True
                    d.cooldown_s = guard
                    return d
        step = max(1, int(lane.step))
        target = d.current + step if want == "up" else d.current - step
        target = max(lane.min_size, min(lane.max_size, target))
        d.direction = want
        d.target = target
        if self._pregate_fn is not None:
            # Twin pre-gate (Maya-style rehearsal): forecast Δp99/Δshed
            # before touching real capacity; a veto journals but never
            # actuates.
            try:
                d.forecast = self._pregate_fn(lane.name, d.current, target,
                                              sensors)
            except Exception as e:
                d.forecast = {"error": str(e)}
            if d.forecast and d.forecast.get("veto"):
                d.vetoed = True
                telemetry.inc("autoscale.vetoed")
        return d

    def _actuate(self, lane: LaneSpec, d: ScaleDecision, now: float) -> None:
        try:
            # Chaos site: an actuator fault is a failed spawn/drain —
            # the decision records the error and cooldown still arms
            # (retrying a broken actuator every tick is its own flap).
            chaos.hook("autoscale.actuate", lane.name)
            with telemetry.span("autoscale.actuate", lane=lane.name,
                                direction=d.direction):
                self._actuators[lane.name].scale_to(d.target)
            d.actuated = True
            telemetry.inc("autoscale.actuations")
        except Exception as e:
            telemetry.inc("autoscale.actuate_errors")
            d.sensors = dict(d.sensors, actuate_error=str(e))
        self._last_act[(lane.name, d.direction)] = now
        self._history[lane.name].append((now, d.direction))
        if d.damp_factor > 1.0:
            telemetry.inc("autoscale.damped_actuations")

    def _record(self, d: ScaleDecision) -> None:
        telemetry.inc("autoscale.decisions")
        if d.damped:
            telemetry.inc("autoscale.damped_holds")
        _journal.record("autoscale", "decision", **d.to_dict())

    # -- live loop -----------------------------------------------------------

    def start(self, interval_s: Optional[float] = None) -> None:
        if self._thread is not None:
            return
        interval = self.tick_s if interval_s is None else interval_s
        self._stop.clear()

        def loop() -> None:
            while not self._stop.wait(interval):
                try:
                    self.tick()
                except Exception:
                    telemetry.inc("autoscale.tick_errors")

        self._thread = threading.Thread(target=loop, name="autoscale",
                                        daemon=True)
        self._thread.start()

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            self._thread = None
