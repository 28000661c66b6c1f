"""The train twin's discrete-event sweep simulator (docs/twin.md).

The port's own copy of ``rafiki_tpu/obs/twin/train/engine.py``; faults
come from the port's own chaos plane (``chaos/plane.py FaultPlane``).

Simulates the mesh sweep chain the way ``scheduler/mesh.py`` runs it:

* **draft** — the trial list stands in for the one batched
  ``propose_batch(chips*k)`` draft; trials carry a packing key and an
  epoch count (captured, synthesized, or hand-built).
* **pack formation** — trials bucket by packing key in first-appearance
  order, then a GLOBAL round-robin cursor distributes each bucket's
  rows across chips — byte-for-byte the assignment loop in
  ``MeshSweepScheduler._run_sub``, so the predicted placement is the
  one the scheduler would produce.
* **packed epochs** — each chip drains its pack queue FIFO. A pack of
  width w runs ``epochs`` epochs: the first is COLD (first-call-paying;
  cold samples are assigned by descending order statistic per
  (packing_key, w) — the first pack pays the true first call, later
  packs the program-cache hits), the rest WARM (drawn from the calibrated
  per-(packing_key, w) distribution by the seeded service stream).
  Every epoch also pays the calibrated ``epoch_overhead_s`` residual
  (eval/feedback/wiring).
* **eviction** — an optional per-member-epoch early-stop probability
  (the ``evict`` stream): an evicted member counts COMPLETED at that
  boundary (early stop is a verdict, not a loss) and the pack narrows.
* **chaos** — the live sweep's fault grammar at the live sites:
  ``scheduler.preempt`` keyed ``chip<i>`` is consulted at every epoch
  boundary (the live supervisor also lands the abort at an epoch
  boundary); ``host.loss`` keyed ``g0h<h>`` at every supervisor tick
  when ``chips_per_host`` groups chips into hosts. Host 0 carries the
  supervisor: losing it aborts the sweep (the resume path's job, not
  the twin's).
* **re-pack/backfill** — a lost chip's unfinished trials re-assign
  round-robin to survivors and resume SERIALLY from their epoch
  boundary (the checkpoint contract), paying a fresh cold epoch.
* **recorded rounds** (a departure from the JAX package) — a replayed
  pack that carries ``rounds`` (its ``trial_pack/rounds`` record, see
  ``calibration.py``) runs one epoch per recorded round at that round's
  width, its members the drafted and the backfilled trials; the
  ``evict`` stream leaves it alone. Without ``rounds`` every path is
  the JAX package's.

Determinism contract: named seeded streams (``{seed}:service``,
``{seed}:evict``, ``{seed}:propose``) and zero ambient clocks, so one
seed reproduces the event log bit-for-bit;
``event_log_sha1`` fingerprints it.
"""

from __future__ import annotations

import dataclasses
import heapq
import json
import random
from hashlib import sha1
from typing import Any, Dict, List, Optional, Tuple

from rafiki_tpu_torch.obs.twin.train.calibration import TrainCalibration

RESULT_SCHEMA_VERSION = 1

#: Event-log safety cap (record_events=True only).
EVENT_CAP = 200_000

#: Hard ceiling on simulated epochs — a runaway what-if config must
#: fail loudly, not spin.
EPOCH_CAP = 1_000_000


@dataclasses.dataclass
class TrainTwinConfig:
    """Simulated sweep topology. ``k`` is the RAFIKI_TRIAL_PACK slot
    count per chip; ``n_trials`` defaults to ``chips * k`` (the one
    batched draft fills every slot)."""

    chips: int = 2
    k: int = 2
    n_trials: Optional[int] = None
    chips_per_host: int = 0
    supervisor_tick_s: float = 1.0
    evict_prob: float = 0.0

    @classmethod
    def from_calibration(cls, cal: TrainCalibration,
                         **overrides: Any) -> "TrainTwinConfig":
        base: Dict[str, Any] = {
            "chips": int(cal.sweep.get("chips") or 2),
            "k": int(cal.sweep.get("trials_per_chip") or 2),
            "n_trials": cal.sweep.get("n_trials"),
        }
        base.update(overrides)
        cfg = cls(**base)
        cfg.chips = max(1, int(cfg.chips))
        cfg.k = max(1, int(cfg.k))
        return cfg

    def slots(self) -> int:
        return self.chips * self.k


def synthesize_trials(cal: TrainCalibration, n: int, seed: int = 0
                      ) -> List[Dict[str, Any]]:
    """A drafted trial list: packing keys drawn from the calibration's
    observed keys (weighted by captured pack membership when packs were
    captured, uniform otherwise) via the seeded ``propose`` stream."""
    keys = cal.packing_keys()
    if not keys:
        raise ValueError("calibration has no packing keys to draft from")
    weights = {k: 1 for k in keys}
    for p in cal.packs:
        pk = p.get("packing_key")
        if pk in weights:
            weights[pk] += len(p.get("trial_ids") or []) or int(
                p.get("k") or 1)
    rng = random.Random(f"{seed}:propose")
    pool = [k for k in keys for _ in range(weights[k])]
    out = []
    for i in range(int(n)):
        pk = pool[rng.randrange(len(pool))]
        out.append({"id": f"t{i:03d}", "packing_key": pk,
                    "epochs": cal.epochs_for(pk)})
    return out


def packs_from_calibration(cal: TrainCalibration) -> List[Dict[str, Any]]:
    """The CAPTURED placement, one dict per pack, for validate's
    replay: the simulator skips its own assignment and runs exactly the
    packs ``mesh/pack_formed`` recorded."""
    packs = []
    for p in cal.packs:
        members = list(p.get("trial_ids") or [])
        if not members:
            continue
        pk = p.get("packing_key") or "?"
        pack = {"chip": int(p.get("chip") or 0),
                "packing_key": pk,
                "epochs": int(p.get("epochs") or cal.epochs_for(pk)),
                "members": members}
        if p.get("rounds"):
            pack["members"] = members + list(p.get("backfilled") or [])
            pack["epochs"] = len(p["rounds"])
            pack["rounds"] = [int(w) for w in p["rounds"]]
        packs.append(pack)
    return packs


def _assign(trials: List[Dict[str, Any]], chips: int, k: int
            ) -> List[Dict[str, Any]]:
    """Mirror of MeshSweepScheduler._run_sub's bucket + global
    round-robin cursor assignment."""
    buckets: Dict[str, List[Dict[str, Any]]] = {}
    order: List[str] = []
    for t in trials:
        pk = t["packing_key"]
        if pk not in buckets:
            order.append(pk)
            buckets[pk] = []
        buckets[pk].append(t)
    assign: List[List[List[Dict[str, Any]]]] = [
        [[] for _ in order] for _ in range(chips)]
    cursor = 0
    for b, pk in enumerate(order):
        for row in buckets[pk]:
            assign[cursor % chips][b].append(row)
            cursor += 1
    packs = []
    for c in range(chips):
        for b, rows in enumerate(assign[c]):
            if rows:
                packs.append({"chip": c, "packing_key": order[b],
                              "epochs": max(int(t.get("epochs") or 1)
                                            for t in rows),
                              "members": [t["id"] for t in rows]})
    return packs


class _Pack:
    __slots__ = ("chip", "pk", "epochs", "members", "done_epochs", "rounds")

    def __init__(self, chip: int, pk: str, epochs: int,
                 members: List[str], done_epochs: int = 0,
                 rounds: Optional[List[int]] = None):
        self.chip = chip
        self.pk = pk
        self.rounds = list(rounds) if rounds else None
        self.epochs = len(self.rounds) if self.rounds else max(1, int(epochs))
        self.members = list(members)
        self.done_epochs = int(done_epochs)

    def width(self, epoch: int) -> int:
        """Members training in epoch ``epoch``: the recorded round's
        width, else every member still in the pack."""
        if self.rounds:
            return self.rounds[min(epoch, len(self.rounds) - 1)]
        return len(self.members)


class _Chip:
    __slots__ = ("index", "queue", "current", "dead")

    def __init__(self, index: int):
        self.index = index
        self.queue: List[_Pack] = []
        self.current: Optional[_Pack] = None
        self.dead = False


class _Sim:
    def __init__(self, cal: TrainCalibration, cfg: TrainTwinConfig,
                 packs: List[Dict[str, Any]], seed: int,
                 chaos_spec: Optional[str], record_events: bool):
        from rafiki_tpu_torch.chaos.plane import FaultPlane

        self.cal = cal
        self.cfg = cfg
        self.rng = random.Random(f"{seed}:service")
        self.rng_evict = random.Random(f"{seed}:evict")
        self.plane = (FaultPlane.from_spec(chaos_spec)
                      if chaos_spec else None)
        self.record_events = record_events
        self.now = 0.0
        self.horizon = 0.0
        self._heap: List[Tuple[float, int, str, Any]] = []
        self._seq = 0
        self._hash = sha1()
        self.events: List[Tuple[float, str, str]] = []
        self.n_events = 0
        self.n_epochs = 0
        chip_ids = sorted({p["chip"] for p in packs} | set(
            range(cfg.chips)))
        self.chips = {c: _Chip(c) for c in chip_ids}
        for p in packs:
            self.chips[p["chip"]].queue.append(
                _Pack(p["chip"], p["packing_key"], p["epochs"],
                      p["members"], rounds=p.get("rounds")))
        self.n_trials = sum(len(p["members"]) for p in packs)
        # Program cache: cold-sample order statistic per (pk, width).
        self._cold_i: Dict[Tuple[str, int], int] = {}
        self.completed = 0
        self.evicted = 0
        self.repacks = 0
        self.chips_lost: List[int] = []
        self.hosts_lost: List[int] = []
        self.chaos_fired = 0
        self.compile_s = 0.0
        self.step_s = 0.0
        self.status = "ok"
        self._rr = 0  # round-robin cursor for re-packed resumes

    # -- plumbing ------------------------------------------------------------

    def _push(self, t: float, kind: str, payload: Any) -> None:
        self._seq += 1
        heapq.heappush(self._heap, (t, self._seq, kind, payload))

    def _log(self, kind: str, detail: str) -> None:
        self.horizon = max(self.horizon, self.now)
        ev = (round(self.now, 7), kind, detail)
        self._hash.update(repr(ev).encode())
        self.n_events += 1
        if self.record_events and len(self.events) < EVENT_CAP:
            self.events.append(ev)

    def _decide(self, site: str, key: str):
        if self.plane is None:
            return None
        d = self.plane.decide(site, key)
        if d is not None:
            self.chaos_fired += 1
        return d

    def _warm_s(self, pk: str, width: int) -> float:
        xs, scale = self.cal.step_samples(pk, width)
        return xs[self.rng.randrange(len(xs))] * scale

    def _cold_s(self, pk: str, width: int) -> float:
        xs = self.cal.compile_samples(pk, width)
        i = self._cold_i.get((pk, width), 0)
        self._cold_i[(pk, width)] = i + 1
        return xs[min(i, len(xs) - 1)]

    # -- the chain -----------------------------------------------------------

    def _chip_next(self, c: int) -> None:
        chip = self.chips[c]
        if chip.dead or chip.current is not None:
            return
        if not chip.queue:
            self._log("chip_idle", f"chip{c}")
            return
        pack = chip.queue.pop(0)
        chip.current = pack
        width = pack.width(pack.done_epochs)
        cold = pack.done_epochs == 0
        dt = ((self._cold_s(pack.pk, width) if cold
               else self._warm_s(pack.pk, width))
              + self.cal.epoch_overhead_s)
        self._log("pack_start", f"chip{c} w={width} "
                                f"pk={pack.pk[:40]} epochs={pack.epochs}")
        self._book(cold, dt)
        self._push(self.now + dt, "epoch_end", (c, cold))

    def _book(self, cold: bool, dt: float) -> None:
        self.n_epochs += 1
        if self.n_epochs > EPOCH_CAP:
            raise RuntimeError(
                f"train twin exceeded {EPOCH_CAP} simulated epochs; "
                f"check the what-if config")
        if cold:
            self.compile_s += dt
        else:
            self.step_s += dt

    def _epoch_end(self, c: int, was_cold: bool) -> None:
        chip = self.chips[c]
        pack = chip.current
        if chip.dead or pack is None:
            return
        pack.done_epochs += 1
        self._log("epoch_end", f"chip{c} e={pack.done_epochs}"
                               f"/{pack.epochs} "
                               f"w={pack.width(pack.done_epochs - 1)}")
        # Chip preemption probe — the supervisor's site, consulted at
        # the epoch boundary where the live abort would also land.
        d = self._decide("scheduler.preempt", f"chip{c}")
        if d is not None and d.mode in ("kill", "term", "preempt"):
            self._lose_chip(c)
            return
        # Eviction: a member early-stopping at this boundary counts
        # completed (an early verdict) and the pack narrows.
        if self.cfg.evict_prob > 0 and pack.members and not pack.rounds:
            kept = []
            for m in pack.members:
                if (pack.done_epochs < pack.epochs
                        and self.rng_evict.random() < self.cfg.evict_prob):
                    self.evicted += 1
                    self.completed += 1
                    self._log("evict", f"chip{c} {m}")
                else:
                    kept.append(m)
            pack.members = kept
        if pack.done_epochs >= pack.epochs or not pack.members:
            self.completed += len(pack.members)
            self._log("pack_done", f"chip{c} w={len(pack.members)}")
            chip.current = None
            self._chip_next(c)
            return
        width = pack.width(pack.done_epochs)
        dt = self._warm_s(pack.pk, width) + self.cal.epoch_overhead_s
        self._book(False, dt)
        self._push(self.now + dt, "epoch_end", (c, False))

    def _lose_chip(self, c: int) -> None:
        chip = self.chips[c]
        if chip.dead:
            return
        chip.dead = True
        self.chips_lost.append(c)
        self._log("chip_lost", f"chip{c}")
        # Orphans: the in-flight pack's members (resuming from their
        # epoch-boundary checkpoints) plus every queued pack's members.
        orphans: List[Tuple[str, str, int]] = []
        if chip.current is not None:
            p = chip.current
            orphans += [(m, p.pk, p.epochs - p.done_epochs)
                        for m in p.members]
            chip.current = None
        for p in chip.queue:
            orphans += [(m, p.pk, p.epochs) for m in p.members]
        chip.queue = []
        survivors = [ch for ch in self.chips.values() if not ch.dead]
        if not survivors:
            self.status = "all_chips_lost"
            self._log("sweep_aborted", f"{len(orphans)} trial(s) stranded")
            return
        # Serial resume on survivors: width-1 packs, round-robin — the
        # supervisor's re-pack path.
        for (m, pk, remaining) in orphans:
            target = survivors[self._rr % len(survivors)]
            self._rr += 1
            target.queue.append(_Pack(target.index, pk,
                                      max(1, remaining), [m]))
            self.repacks += 1
            self._log("repack", f"{m} -> chip{target.index}")
        for ch in survivors:
            self._chip_next(ch.index)

    def _tick(self) -> None:
        """Supervisor cadence: host.loss probes over the simulated host
        topology. Host 0 carries the supervisor — losing it aborts the
        sweep (crash-recovery's job, not the twin's)."""
        per_host = self.cfg.chips_per_host
        if per_host > 0 and self.plane is not None:
            hosts = sorted({c // per_host for c, ch in self.chips.items()
                            if not ch.dead})
            for h in hosts:
                d = self._decide("host.loss", f"g0h{h}")
                if d is None or d.mode not in ("kill", "term", "preempt"):
                    continue
                self.hosts_lost.append(h)
                self._log("host_lost", f"h{h}")
                if h == 0:
                    self.status = "supervisor_lost"
                    return
                for c in [c for c, ch in self.chips.items()
                          if not ch.dead and c // per_host == h]:
                    self._lose_chip(c)
        if self._active():
            self._push(self.now + self.cfg.supervisor_tick_s, "tick", None)

    def _active(self) -> bool:
        return any(not ch.dead and (ch.current or ch.queue)
                   for ch in self.chips.values())

    def run(self) -> None:
        self._log("sweep_start", f"chips={len(self.chips)} "
                                 f"trials={self.n_trials}")
        for c in sorted(self.chips):
            self._chip_next(c)
        if self.plane is not None and self.cfg.chips_per_host > 0:
            self._push(self.cfg.supervisor_tick_s, "tick", None)
        while self._heap:
            t, _seq, kind, payload = heapq.heappop(self._heap)
            self.now = t
            if self.status != "ok":
                break
            if kind == "epoch_end":
                self._epoch_end(*payload)
            elif kind == "tick":
                self._tick()
            if not self._active() and not any(
                    k == "epoch_end" for _, _, k, _ in self._heap):
                break
        self._log("sweep_done", f"completed={self.completed}")


def simulate(cal: TrainCalibration, cfg: TrainTwinConfig,
             trials: Optional[List[Dict[str, Any]]] = None,
             packs: Optional[List[Dict[str, Any]]] = None,
             seed: int = 0, chaos_spec: Optional[str] = None,
             record_events: bool = False) -> Dict[str, Any]:
    """One deterministic sweep simulation. Give ``packs`` to replay a
    captured placement (validate), ``trials`` to let the engine form
    packs the scheduler's way, or neither to synthesize a draft that
    fills the config's slots."""
    if packs is None:
        if trials is None:
            n = int(cfg.n_trials or cfg.slots())
            trials = synthesize_trials(cal, min(n, cfg.slots()), seed=seed)
        packs = _assign(trials, cfg.chips, cfg.k)
    sim = _Sim(cal, cfg, packs, seed, chaos_spec, record_events)
    sim.run()
    makespan = round(sim.horizon, 7)
    tph = (round(sim.completed / makespan * 3600.0, 4)
           if makespan > 0 and sim.completed else 0.0)
    busy = sim.compile_s + sim.step_s
    util = (round(busy / (makespan * max(1, len(sim.chips))), 4)
            if makespan > 0 else None)
    widths = sorted({max(p.get("rounds") or [len(p["members"])])
                     for p in packs}) or [cfg.k]
    res: Dict[str, Any] = {
        "result_schema_version": RESULT_SCHEMA_VERSION,
        "status": sim.status,
        "trials": sim.n_trials,
        "completed": sim.completed,
        "evicted": sim.evicted,
        "chips": cfg.chips,
        "k": cfg.k,
        "packs": len(packs),
        "makespan_s": makespan,
        "trials_per_hour": tph,
        "compile_s": round(sim.compile_s, 7),
        "step_s": round(sim.step_s, 7),
        "utilization": util,
        "repacks": sim.repacks,
        "chips_lost": sim.chips_lost,
        "hosts_lost": sim.hosts_lost,
        "chaos_fired": sim.chaos_fired,
        "hbm_frac": cal.hbm_frac(k=max(widths)),
        "seed": seed,
        "chaos_spec": chaos_spec,
        "event_log_len": sim.n_events,
        "event_log_sha1": sim._hash.hexdigest(),
        "config": dataclasses.asdict(cfg),
    }
    if record_events:
        res["events"] = sim.events
    return res


def result_fingerprint(result: Dict[str, Any]) -> str:
    """Stable fingerprint of a simulation result (replay identity)."""
    return sha1(json.dumps(result, sort_keys=True).encode()).hexdigest()
