"""Declarative SLOs evaluated as multi-window burn rates.

The port's own copy of ``rafiki_tpu/obs/perf/slo.py``: the same
specs, sources, burn rule and journal records.

An SLO spec names a *source* in the process's telemetry snapshot, a
comparison, and two (or more) trailing windows. A breach requires the
comparison to hold over **every** window — the classic multi-window
burn-rate rule: the short window proves the problem is happening now,
the long window proves it isn't a blip.

Sources (the part before ``:`` picks the resolver and the default
evaluation mode):

    counter:<name>              telemetry counter        -> rate/s
    ratio:<num>/<a>+<b>...      counter delta ratio      -> ratio
    gauge:<name>                telemetry gauge          -> level
    hist_p99:<name>             histogram p99 (reservoir)-> level
    ledger:goodput              fleet goodput roll-up    -> level
    ledger:<bucket>             ledger total bucket secs -> rate/s

``rate`` compares the per-second delta over the window; ``ratio``
compares delta(num)/delta(den); ``level`` requires the comparison to
hold for every sample in the window (sustained, not instantaneous). A
window with no sample old enough is *not evaluable* and cannot breach
— a fresh process never alarms on an empty history.

The engine samples on ``tick()``; hot paths (gateway predict, the
train loops, predictor queries) call ``maybe_tick``
which is one clock read when the tick interval hasn't elapsed.
Breaches bump ``slo.breaches``, journal ``slo/breach`` and trip the
flight recorder, so every breach is reconstructible post-mortem;
recoveries journal ``slo/recover``. Current burn state rides in the
``slo`` telemetry collector and the periodic ``slo/state`` journal
record — ``python -m rafiki_tpu_torch.obs slo`` renders either.

Specs come from ``RAFIKI_SLO``: unset -> :func:`default_specs`;
``off`` -> disabled; inline JSON (``[{...}]``) or a path to a JSON
file -> custom (a list of :class:`SloSpec` fields).
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

from rafiki_tpu_torch import telemetry
from rafiki_tpu_torch.obs.journal import journal

ENV_SPEC = "RAFIKI_SLO"
ENV_TICK = "RAFIKI_SLO_TICK_S"
DEFAULT_TICK_S = 5.0
DEFAULT_WINDOWS = (60.0, 300.0)
RING = 512


@dataclass
class SloSpec:
    name: str
    source: str
    threshold: float
    op: str = ">"
    windows: Tuple[float, ...] = DEFAULT_WINDOWS
    mode: str = ""            # derived from source when empty
    min_wall_s: float = 0.0   # engine age before the spec is live
    description: str = ""

    def __post_init__(self):
        if self.op not in (">", "<"):
            raise ValueError(f"slo {self.name}: op must be '>' or '<'")
        self.windows = tuple(float(w) for w in self.windows)
        if not self.windows:
            raise ValueError(f"slo {self.name}: needs at least one window")
        if not self.mode:
            head = self.source.split(":", 1)[0]
            if head == "counter" or (head == "ledger"
                                     and self.source != "ledger:goodput"):
                self.mode = "rate"
            elif head == "ratio":
                self.mode = "ratio"
            else:
                self.mode = "level"

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "SloSpec":
        known = {"name", "source", "threshold", "op", "windows", "mode",
                 "min_wall_s", "description"}
        return cls(**{k: v for k, v in d.items() if k in known})


def default_specs() -> List[SloSpec]:
    return [
        SloSpec("gateway_p99_latency", "hist_p99:gateway.predict_s", 2.0,
                description="end-to-end gateway predict p99 under 2s"),
        SloSpec("gateway_shed_rate",
                "ratio:gateway.shed/gateway.shed+gateway.admitted", 0.05,
                description="shed fraction of admitted+shed under 5%"),
        SloSpec("trial_goodput_floor", "ledger:goodput", 0.30, op="<",
                windows=(120.0, 600.0), min_wall_s=120.0,
                description="fleet goodput (step_s/wall_s) above 0.30"),
        SloSpec("mesh_downtime_budget", "ledger:downtime_s", 0.10,
                description="downtime under 10% of wall"),
        SloSpec("step_anomaly_rate", "counter:perf.anomalies", 0.05,
                description="step-time anomalies under 3/min sustained"),
        SloSpec("divergence_rate", "counter:health.divergences", 0.02,
                description="numerics divergences under ~1/min sustained "
                            "(docs/health.md)"),
        SloSpec("serving_forward_p99", "hist_p99:serving.hop.forward_s",
                1.0, description="per-hop latency budget "
                                 "(docs/serving_anatomy.md): device "
                                 "forward p99 under 1s"),
    ]


def _resolve(source: str, snap: Dict[str, Any]) -> Optional[Any]:
    """Read one spec's raw (cumulative or instantaneous) value out of a
    telemetry snapshot; None means 'no data this tick'."""
    head, _, rest = source.partition(":")
    if head == "counter":
        return float(snap.get("counters", {}).get(rest, 0.0))
    if head == "gauge":
        return snap.get("gauges", {}).get(rest)
    if head == "hist_p99":
        h = snap.get("histograms", {}).get(rest)
        return None if not h else h.get("p99")
    if head == "ratio":
        num, _, den = rest.partition("/")
        counters = snap.get("counters", {})
        return (float(counters.get(num, 0.0)),
                sum(float(counters.get(d, 0.0)) for d in den.split("+")))
    if head == "ledger":
        led = snap.get("goodput")
        if not isinstance(led, dict):
            return None
        if rest == "goodput":
            return led.get("goodput")
        return float(led.get("total", {}).get(rest, 0.0))
    return None


def _compare(op: str, value: float, threshold: float) -> bool:
    return value > threshold if op == ">" else value < threshold


class SloEngine:
    """Samples spec sources into bounded rings and evaluates the
    multi-window burn rule on every tick (see module docstring)."""

    def __init__(self, specs: Optional[Sequence[SloSpec]] = None,
                 tick_s: Optional[float] = None, clock=time.monotonic):
        self._lock = threading.RLock()
        self._clock = clock
        self.configure(specs=specs, tick_s=tick_s)

    def configure(self, specs: Optional[Sequence[SloSpec]] = None,
                  tick_s: Optional[float] = None) -> None:
        with self._lock:
            self.specs = list(default_specs() if specs is None else specs)
            self.tick_s = (float(os.environ.get(ENV_TICK, DEFAULT_TICK_S))
                           if tick_s is None else float(tick_s))
            self._rings: Dict[str, deque] = {
                s.name: deque(maxlen=RING) for s in self.specs}
            self._breaching: Dict[str, bool] = {
                s.name: False for s in self.specs}
            self._last_eval: Dict[str, Dict[str, Any]] = {}
            self._t0 = self._clock()
            self._last_tick = 0.0

    # -- evaluation ----------------------------------------------------------

    def _window_value(self, spec: SloSpec, ring: deque, now: float,
                      w: float) -> Optional[float]:
        """The spec's value over the trailing window ``w`` ending now,
        or None when the ring doesn't reach back a full window."""
        base = None
        in_window: List[float] = []
        for ts, raw in ring:
            if ts <= now - w:
                base = (ts, raw)  # newest sample at least w old
            else:
                in_window.append(raw)
        if spec.mode == "level":
            if base is None:
                return None  # window not fully covered yet
            samples = [base[1]] + in_window
            samples = [s for s in samples if s is not None]
            if not samples:
                return None
            # The op must hold across the WHOLE window: evaluate the
            # least-breaching sample.
            return min(samples) if spec.op == ">" else max(samples)
        if base is None or not ring:
            return None
        ts0, raw0 = base
        ts1, raw1 = ring[-1]
        span = ts1 - ts0
        if span <= 0.0:
            return None
        if spec.mode == "ratio":
            dnum = raw1[0] - raw0[0]
            dden = raw1[1] - raw0[1]
            if dden <= 0.0:
                return None
            return dnum / dden
        return (raw1 - raw0) / span  # rate/s

    def tick(self, now: Optional[float] = None) -> Dict[str, Dict[str, Any]]:
        """Sample every spec and evaluate; returns the per-spec state
        dict (also kept for the collector)."""
        with self._lock:
            now = self._clock() if now is None else now
            self._last_tick = now
            if not self.specs:
                return {}
            snap = telemetry.snapshot()
            state: Dict[str, Dict[str, Any]] = {}
            for spec in self.specs:
                ring = self._rings[spec.name]
                raw = _resolve(spec.source, snap)
                if raw is not None:
                    ring.append((now, raw))
                windows: List[Dict[str, Any]] = []
                evaluable = raw is not None and (
                    now - self._t0 >= spec.min_wall_s)
                breaching = evaluable and bool(ring)
                for w in spec.windows:
                    wv = (self._window_value(spec, ring, now, w)
                          if evaluable else None)
                    windows.append({"w": w, "value": wv})
                    if wv is None or not _compare(spec.op, wv, spec.threshold):
                        breaching = False
                worst = max((d["value"] for d in windows
                             if d["value"] is not None),
                            default=None)
                state[spec.name] = {
                    "breaching": int(breaching),
                    "threshold": spec.threshold,
                    "value": worst,
                    "burn": (worst / spec.threshold
                             if worst is not None and spec.threshold > 0
                             else None),
                    "windows": windows,
                }
                was = self._breaching[spec.name]
                self._breaching[spec.name] = breaching
                if breaching and not was:
                    self._on_breach(spec, state[spec.name])
                elif was and not breaching:
                    telemetry.inc("slo.recoveries")
                    journal.record("slo", "recover", slo=spec.name)
            self._last_eval = state
            journal.record("slo", "state", state={
                name: {k: v for k, v in st.items() if k != "windows"}
                for name, st in state.items()})
            return state

    def _on_breach(self, spec: SloSpec, st: Dict[str, Any]) -> None:
        telemetry.inc("slo.breaches")
        journal.record("slo", "breach", slo=spec.name, source=spec.source,
                       op=spec.op, threshold=spec.threshold,
                       value=st["value"], windows=st["windows"],
                       description=spec.description)
        # Every breach leaves a full post-mortem bundle behind.
        from rafiki_tpu_torch.obs import recorder

        recorder.dump(f"slo:{spec.name}",
                      extra={"slo": {"name": spec.name, **st}})

    def maybe_tick(self) -> Optional[Dict[str, Dict[str, Any]]]:
        """The hot-path entry: a clock read and a compare unless the
        tick interval has elapsed."""
        if not self.specs:
            return None
        now = self._clock()
        if now - self._last_tick < self.tick_s:
            return None
        return self.tick(now)

    def collector(self) -> Dict[str, Any]:
        """The ``slo`` telemetry collector payload."""
        with self._lock:
            return {
                "specs": len(self.specs),
                "breaching": sum(self._breaching.values()),
                "state": {
                    name: {k: v for k, v in st.items() if k != "windows"}
                    for name, st in self._last_eval.items()},
            }


def _specs_from_env() -> Optional[List[SloSpec]]:
    """None -> defaults; [] -> disabled; else parsed custom specs.
    A malformed spec disables nothing — defaults apply and the error
    is journaled rather than raised (SLOs must not break hosts)."""
    raw = os.environ.get(ENV_SPEC, "").strip()
    if not raw:
        return None
    if raw.lower() in ("off", "0", "false", "none"):
        return []
    try:
        if not raw.lstrip().startswith(("[", "{")):
            with open(raw) as f:
                raw = f.read()
        data = json.loads(raw)
        if isinstance(data, dict):
            data = data.get("specs", [])
        return [SloSpec.from_dict(d) for d in data]
    except Exception as e:
        journal.record("slo", "config_error", error=str(e))
        return None


#: Process-global engine, configured from RAFIKI_SLO at import.
engine = SloEngine(specs=_specs_from_env())


def configure(specs: Optional[Sequence[SloSpec]] = None,
              tick_s: Optional[float] = None) -> SloEngine:
    """(Re)configure the global engine — smoke scripts and tests."""
    engine.configure(specs=specs, tick_s=tick_s)
    return engine


def configure_from_env() -> SloEngine:
    engine.configure(specs=_specs_from_env())
    return engine


def maybe_tick() -> Optional[Dict[str, Dict[str, Any]]]:
    return engine.maybe_tick()


telemetry.register_collector("slo", engine.collector)
