"""Deterministic fault-injection plane.

The port's own copy of ``rafiki_tpu/chaos/plane.py`` (all of it: the
spec grammar, ``Fault``, ``FaultPlane``, ``install``/``uninstall``/
``reset_from_env``/``active``/``decide``/``perform``/``hook``), so the
same ``RAFIKI_CHAOS`` spec and seed fire the same fault schedule in
both packages. It counts into the port's telemetry and journal.

Recovery code that is only ever exercised by real outages is folklore,
not engineering: the supervise loop's restart path, the bus's lease
reaping, checkpoint resume — none of it is trustworthy until a fault
can be REPLAYED. This module is the injection half of the chaos
subsystem: a registry of parsed fault specs (``FaultPlane``) consulted
from call sites threaded through the bus, the stores, the workers, the
train loops and the serving path. The scenario half
(scenarios.py / runner.py) schedules faults against an in-proc cluster
and asserts the recovery invariants.

Design constraints, in priority order:

* **Inert by default.** With ``RAFIKI_CHAOS`` unset, every hook is a
  module-global ``None`` check — no parsing, no locks, no telemetry,
  no timing change on the hot paths (the bus ops and the train loop
  call hooks per message / per epoch).
* **Deterministic.** Every probabilistic decision draws from a
  ``random.Random`` seeded by ``(seed, site, mode, spec-index)`` and
  consumed one draw per *matching hit* of that spec — so a fixed seed
  replays the identical fault schedule regardless of wall clock, and
  (per site) regardless of how other sites interleave. ``schedule()``
  returns the fired record for replay assertions.
* **Process-local, env-propagated.** The plane initializes from the
  environment at import; a subprocess inherits ``RAFIKI_CHAOS``, so a
  worker can deterministically SIGKILL *itself* at epoch N — which is
  how kill-at-epoch faults stay exact instead of racing an external
  killer against the train loop.

Spec grammar (the JAX package's docs/chaos.md)::

    RAFIKI_CHAOS="seed=7;worker.epoch:kill:after=1:unless=-r;bus.add_query:drop:p=0.3"

``<site>:<mode>[:opt]...`` entries separated by ``;``. Options:
``p=<float>`` fire probability (default 1), ``after=<int>`` skip the
first N matching hits, ``times=<int>`` max fires (default unlimited),
``delay=<float>`` sleep seconds for delay modes, ``match=<substr>`` /
``unless=<substr>`` filter on the hook key (e.g. a worker id — a
restarted worker's ``-r<N>`` suffix is how kill faults are scoped to
the first incarnation only).

Modes and who enacts them:

=========  ==============================================================
drop/skip  returned to the call site, which drops the message / skips
           the heartbeat
delay      ``hook()`` itself sleeps ``delay`` seconds (latency spike /
           stuck replica / slow disk)
error      ``hook()`` raises :class:`ChaosError` (an ``OSError`` — a
           failing store write)
kill/term  ``hook()`` signals the CURRENT process (SIGKILL/SIGTERM) —
           in-worker crash-at-epoch faults
preempt    never self-enacted; the mesh sweep's supervisor consumes
           it via :func:`decide` (``scheduler.preempt``, keyed
           ``chip<i>``)
nan        never self-enacted; the train loops' ``train.nan`` site turns
           it into a one-step gradient poison column
=========  ==============================================================
"""

from __future__ import annotations

import os
import random
import signal
import threading
import time
from typing import Dict, List, Optional, Tuple

from rafiki_tpu_torch import telemetry
from rafiki_tpu_torch.obs.journal import journal as _journal

ENV_VAR = "RAFIKI_CHAOS"

# "nan" is caller-enacted (like drop/skip/preempt): the train loops'
# ``train.nan`` site turns a fired hook into a one-step gradient poison
# column (ops/train.py); perform() just reports it.
_MODES = ("drop", "skip", "delay", "error", "kill", "term", "preempt", "nan")


class ChaosError(OSError):
    """The injected failure for ``error``-mode faults. An ``OSError``
    subclass so store-write call sites see the same exception shape a
    genuinely failing disk would produce."""


class ChaosSpecError(ValueError):
    """Raised for an unparseable ``RAFIKI_CHAOS`` spec — loudly, at
    install time: a typo'd fault spec silently injecting nothing would
    make a chaos scenario vacuously green."""


class Fault:
    """One parsed ``site:mode[:opts]`` entry plus its firing state."""

    __slots__ = ("site", "mode", "prob", "after", "times", "delay_s",
                 "match", "unless", "hits", "fired", "rng")

    def __init__(self, site: str, mode: str, prob: float = 1.0,
                 after: int = 0, times: Optional[int] = None,
                 delay_s: float = 0.05, match: Optional[str] = None,
                 unless: Optional[str] = None):
        self.site = site
        self.mode = mode
        self.prob = prob
        self.after = after
        self.times = times
        self.delay_s = delay_s
        self.match = match
        self.unless = unless
        self.hits = 0
        self.fired = 0
        self.rng: Optional[random.Random] = None

    def describe(self) -> str:
        opts = [f"p={self.prob}" if self.prob < 1.0 else "",
                f"after={self.after}" if self.after else "",
                f"times={self.times}" if self.times is not None else "",
                f"match={self.match}" if self.match else "",
                f"unless={self.unless}" if self.unless else ""]
        tail = ":".join(o for o in opts if o)
        return f"{self.site}:{self.mode}" + (f":{tail}" if tail else "")


def _parse_fault(entry: str, index: int) -> Fault:
    parts = entry.split(":")
    if len(parts) < 2:
        raise ChaosSpecError(
            f"chaos spec entry {entry!r} needs at least site:mode")
    site, mode = parts[0].strip(), parts[1].strip()
    if not site:
        raise ChaosSpecError(f"chaos spec entry {entry!r} has an empty site")
    if mode not in _MODES:
        raise ChaosSpecError(
            f"chaos spec entry {entry!r}: unknown mode {mode!r} "
            f"(one of {', '.join(_MODES)})")
    kwargs: Dict[str, object] = {}
    for opt in parts[2:]:
        if "=" not in opt:
            raise ChaosSpecError(
                f"chaos spec entry {entry!r}: option {opt!r} is not k=v")
        k, v = opt.split("=", 1)
        k = k.strip()
        try:
            if k == "p":
                kwargs["prob"] = float(v)
            elif k == "after":
                kwargs["after"] = int(v)
            elif k == "times":
                kwargs["times"] = int(v)
            elif k == "delay":
                kwargs["delay_s"] = float(v)
            elif k == "match":
                kwargs["match"] = v
            elif k == "unless":
                kwargs["unless"] = v
            else:
                raise ChaosSpecError(
                    f"chaos spec entry {entry!r}: unknown option {k!r}")
        except (TypeError, ValueError) as e:
            if isinstance(e, ChaosSpecError):
                raise
            raise ChaosSpecError(
                f"chaos spec entry {entry!r}: bad value for {k!r}: {v!r}")
    return Fault(site, mode, **kwargs)  # type: ignore[arg-type]


class FaultPlane:
    """A parsed fault registry with per-spec deterministic firing state.

    Decisions are made under one lock (hook sites span threads); the
    rng stream per spec is keyed by ``(seed, site, mode, index)`` and
    advanced once per matching hit, so two runs with the same seed and
    the same per-site hit sequences fire identically.
    """

    def __init__(self, faults: List[Fault], seed: int = 0,
                 spec: Optional[str] = None):
        self.seed = int(seed)
        self.spec = spec
        self.faults = list(faults)
        self._lock = threading.Lock()
        self._schedule: List[Tuple[str, str, int, str]] = []
        # Index faults by site: decide() must stay O(faults-on-site),
        # not O(all-faults), since hot paths call it per message.
        self._by_site: Dict[str, List[Fault]] = {}
        for i, f in enumerate(self.faults):
            f.rng = random.Random(f"{self.seed}:{f.site}:{f.mode}:{i}")
            self._by_site.setdefault(f.site, []).append(f)

    @classmethod
    def from_spec(cls, spec: str) -> "FaultPlane":
        """Parse ``seed=N;site:mode:opts;...``. Raises ChaosSpecError."""
        seed = 0
        faults: List[Fault] = []
        entries = [e.strip() for e in spec.split(";") if e.strip()]
        if not entries:
            raise ChaosSpecError(f"empty chaos spec {spec!r}")
        for i, entry in enumerate(entries):
            if entry.startswith("seed="):
                try:
                    seed = int(entry[len("seed="):])
                except ValueError:
                    raise ChaosSpecError(f"bad chaos seed in {entry!r}")
                continue
            faults.append(_parse_fault(entry, len(faults)))
        return cls(faults, seed=seed, spec=spec)

    def decide(self, site: str, key: str = "") -> Optional[Fault]:
        """The pure decision: does a fault fire at this hit of ``site``?

        Counts the hit against every spec registered for the site
        (match/unless-filtered), honors after/times, draws the spec's
        rng for probabilistic faults, records fired entries in the
        schedule and telemetry. Returns the firing Fault or None. The
        caller (or :func:`perform`) enacts the mode.
        """
        specs = self._by_site.get(site)
        if not specs:
            return None
        with self._lock:
            for f in specs:
                if f.match is not None and f.match not in key:
                    continue
                if f.unless is not None and f.unless in key:
                    continue
                f.hits += 1
                if f.hits <= f.after:
                    continue
                if f.times is not None and f.fired >= f.times:
                    continue
                if f.prob < 1.0 and f.rng.random() >= f.prob:
                    continue
                f.fired += 1
                self._schedule.append((site, f.mode, f.hits, key))
                telemetry.inc("chaos.injected")
                # Sites and modes are both closed sets from the spec
                # grammar, refining the literal aggregate above.
                telemetry.inc(f"chaos.injected.{site}.{f.mode}")
                # Journal the injection: a chaos scenario must be
                # reconstructible from the journals alone (which process
                # got hit, at what site, on which hit count).
                _journal.record("chaos", "injected", site=site,
                                mode=f.mode, key=key, hit=f.hits)
                return f
        return None

    def schedule(self) -> List[Tuple[str, str, int, str]]:
        """The fired-fault record: (site, mode, hit_no, key) tuples in
        firing order — the replay-determinism assertion surface."""
        with self._lock:
            return list(self._schedule)


# ---------------------------------------------------------------------------
# Module-level plane: the thing hook call sites consult.
# ---------------------------------------------------------------------------

def _plane_from_env() -> Optional[FaultPlane]:
    spec = os.environ.get(ENV_VAR, "").strip()
    if not spec:
        return None
    return FaultPlane.from_spec(spec)


_PLANE: Optional[FaultPlane] = _plane_from_env()


def active() -> Optional[FaultPlane]:
    """The installed plane, or None when chaos is off."""
    return _PLANE


def install(plane: Optional[FaultPlane]) -> None:
    """Install a plane for this process (the scenario runner's entry;
    normal processes get theirs from the env at import)."""
    global _PLANE
    _PLANE = plane


def uninstall() -> None:
    install(None)


def reset_from_env() -> Optional[FaultPlane]:
    """Re-read ``RAFIKI_CHAOS`` (tests mutate the env after import)."""
    install(_plane_from_env())
    return _PLANE


def decide(site: str, key: str = "") -> Optional[Fault]:
    """Decision without enactment — for call sites that direct the
    fault at something other than the current process (the scheduler
    preempting a worker subprocess)."""
    plane = _PLANE
    if plane is None:
        return None
    return plane.decide(site, key)


def perform(fault: Fault) -> str:
    """Enact a self-directed fault; returns the mode for the caller to
    interpret (drop/skip are pure return values)."""
    if fault.mode == "delay":
        time.sleep(fault.delay_s)
        # An injected stall is downtime by definition: charge it to the
        # goodput ledger so chaos runs show up as degraded goodput.
        from rafiki_tpu_torch.obs.ledger import ledger

        ledger.add("downtime_s", fault.delay_s)
    elif fault.mode == "error":
        raise ChaosError(
            f"chaos: injected {fault.site} failure ({fault.describe()})")
    elif fault.mode == "kill":
        os.kill(os.getpid(), signal.SIGKILL)
    elif fault.mode == "term":
        os.kill(os.getpid(), signal.SIGTERM)
    return fault.mode


def hook(site: str, key: str = "") -> Optional[str]:
    """The one-liner every instrumented call site uses. Inert path:
    one global read and a None check. Active path: decide, enact
    self-directed modes (sleep / raise / signal self), return the mode
    string so drop/skip call sites can act on it."""
    plane = _PLANE
    if plane is None:
        return None
    fault = plane.decide(site, key)
    if fault is None:
        return None
    return perform(fault)
