"""Effective-throughput ledger: what did the search loop's wall buy?

The port's own copy of ``rafiki_tpu/obs/search/ledger.py``
(``SearchLedger`` and the process-global ``search_ledger``). The goodput
ledger (:mod:`rafiki_tpu_torch.obs.ledger`) splits a *trial's* wall
into compile/step/feed; this ledger splits the *sweep's* wall by
outcome: time charged to completed-and-scored trials vs time sunk into
proposed-but-doomed ones (errored, diverged, early-killed). The roll-up
(``search.effective_trials_per_hour``, ``search.regret``,
``search.best_score``, the kill, false-kill, speculation and
correction counts) is the ``search`` telemetry collector, so it rides
every ``GET /metrics`` snapshot.

Charging is keyed by the audit plane's knobs-hash: ``note_propose``
opens the meter for a hash, the worker's error and kill paths call
``note_doomed`` *before* sending the advisor its consolation feedback,
and ``note_feedback`` (called from the audit helpers) closes the meter
into the scored or doomed bucket. Scope is per process, like every
telemetry collector.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

from rafiki_tpu_torch import telemetry


class SearchLedger:
    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        with getattr(self, "_lock", threading.Lock()):
            self._t0: Optional[float] = None
            self._last: Optional[float] = None
            self._open: Dict[str, List[float]] = {}  # hash -> propose times
            self._doomed_hashes: set = set()
            self._scores: List[float] = []
            self.n_proposed = 0
            self.n_scored = 0
            self.n_doomed = 0
            self.scored_wall_s = 0.0
            self.doomed_wall_s = 0.0
            self.best_score: Optional[float] = None
            # Curve-advisor outcomes (docs/early_kill.md). Kills are a
            # subset of doomed; false kills are hindsight verdicts a
            # ground-truth checker (a sibling re-run of the knobs)
            # establishes after the fact.
            self.n_killed = 0
            self.n_false_kills = 0
            self.n_speculations = 0
            self.n_corrections = 0

    # -- writes --------------------------------------------------------------

    def note_propose(self, knobs_hash: str) -> None:
        now = time.monotonic()
        with self._lock:
            if self._t0 is None:
                self._t0 = now
            self._last = now
            self._open.setdefault(knobs_hash, []).append(now)
            self.n_proposed += 1

    def note_doomed(self, knobs_hash: str) -> None:
        """Flag a proposal as doomed (errored/diverged/lost) so the
        *next* feedback for this hash — the worker's consolation
        ``feedback(0.0)`` — charges the doomed bucket, not the scored
        one."""
        with self._lock:
            self._doomed_hashes.add(knobs_hash)

    def note_kill(self) -> None:
        """One trial early-killed off a curve prediction. Callers pair
        this with ``note_doomed`` — the kill counter explains *why* the
        doomed bucket grew."""
        with self._lock:
            self.n_killed += 1
            n = self.n_killed
        telemetry.set_gauge("search.kills", float(n))

    def note_false_kill(self) -> None:
        """Hindsight verdict: a killed trial's sibling re-run finished
        above best-so-far."""
        with self._lock:
            self.n_false_kills += 1
            n = self.n_false_kills
        telemetry.set_gauge("search.false_kills", float(n))

    def note_speculation(self) -> None:
        """One in-flight trial fed the advisor a predicted score. The
        propose meter stays open — the trial is still running."""
        with self._lock:
            self.n_speculations += 1
            n = self.n_speculations
        telemetry.set_gauge("search.speculations", float(n))

    def note_correction(self) -> None:
        """One speculative score replaced by the trial's true score."""
        with self._lock:
            self.n_corrections += 1
            n = self.n_corrections
        telemetry.set_gauge("search.corrections", float(n))

    def note_feedback(self, knobs_hash: str, score: float) -> bool:
        """Close the meter for one proposal. Returns True when the
        trial was doomed (callers stamp that onto the journal record)."""
        now = time.monotonic()
        with self._lock:
            self._last = now
            opened = self._open.get(knobs_hash)
            wall = (now - opened.pop(0)) if opened else 0.0
            if opened is not None and not opened:
                self._open.pop(knobs_hash, None)
            doomed = knobs_hash in self._doomed_hashes
            self._doomed_hashes.discard(knobs_hash)
            if doomed:
                self.n_doomed += 1
                self.doomed_wall_s += wall
            else:
                self.n_scored += 1
                self.scored_wall_s += wall
                self._scores.append(float(score))
                if self.best_score is None or score > self.best_score:
                    self.best_score = float(score)
            snap = self._snapshot_locked()
        telemetry.set_gauge("search.effective_trials_per_hour",
                            snap["effective_trials_per_hour"] or 0.0)
        telemetry.set_gauge("search.regret", snap["regret"] or 0.0)
        telemetry.set_gauge("search.best_score", snap["best_score"] or 0.0)
        return doomed

    # -- reads ---------------------------------------------------------------

    def _snapshot_locked(self) -> Dict[str, Any]:
        # Elapsed is frozen at the last write (first→last event, the same
        # window `obs sweep` reports as span_s) rather than read off the
        # live clock: an idle ledger must snapshot byte-identically, or
        # every /metrics scrape (and the prom determinism gate) would
        # disagree with the previous one.
        elapsed = ((self._last - self._t0)
                   if self._t0 is not None and self._last is not None
                   else 0.0)
        eff = (round(self.n_scored / (elapsed / 3600.0), 4)
               if elapsed > 0.0 and self.n_scored else None)
        # Running mean regret vs the best score this process has seen —
        # same definition the journal reconstruction uses, so the live
        # gauge and `obs sweep` agree on a finished sweep.
        regret = None
        if self._scores:
            best_so_far, best = [], None
            for s in self._scores:
                best = s if best is None else max(best, s)
                best_so_far.append(best)
            final = best_so_far[-1]
            regret = round(sum(final - b for b in best_so_far)
                           / len(best_so_far), 6)
        return {
            "n_proposed": self.n_proposed,
            "n_scored": self.n_scored,
            "n_doomed": self.n_doomed,
            "n_pending": sum(len(v) for v in self._open.values()),
            "scored_wall_s": round(self.scored_wall_s, 6),
            "doomed_wall_s": round(self.doomed_wall_s, 6),
            "elapsed_s": round(elapsed, 6),
            "effective_trials_per_hour": eff,
            "regret": regret,
            "best_score": (round(self.best_score, 6)
                           if self.best_score is not None else None),
            "n_killed": self.n_killed,
            "n_false_kills": self.n_false_kills,
            "n_speculations": self.n_speculations,
            "n_corrections": self.n_corrections,
        }

    def snapshot(self) -> Dict[str, Any]:
        """JSON-able roll-up; this is the ``search`` collector."""
        with self._lock:
            return self._snapshot_locked()


#: Process-global search ledger (telemetry scope rules: per process).
search_ledger = SearchLedger()

telemetry.register_collector("search", search_ledger.snapshot)
