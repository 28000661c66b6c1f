"""Advisor rehydration: rebuild an equivalent posterior in a fresh
process (docs/recovery.md).

The port's own copy of ``rafiki_tpu/advisor/rehydrate.py``
(``rehydrate_advisor``, ``journal_observations``,
``journal_speculations``). A sweep's GP/TPE state lives only in the
supervisor's memory: a crash loses every observation unless it can be
replayed. Two sources reconstruct it, in a canonical order, so the
result is deterministic whatever the dead process was doing:

1. **Completed trial rows** (MetaStore): the authoritative (knobs,
   score) pairs, replayed sorted by trial ``no``.
2. **``kind="advisor"`` audit journals**: scores the store never saw as
   completed rows, each ``advisor/feedback`` record joined to its
   ``advisor/propose`` record by ``knobs_hash`` to recover the knob
   dict, replayed (sorted by hash) after the store rows. Both
   packages' advisors write these records, so either package's journal
   rehydrates either package's advisor.

Replay goes through the engine's ``feedback()``, so the rehydrated
advisor's internal rng advances exactly as a fresh advisor fed the same
observations would: with the GP's canonical-order fit, the first
post-resume ``propose_batch`` is byte-identical between a crashed and
resumed sweep and an unfaulted one. Speculations still uncorrected at
the crash are replayed AFTER all real observations, sorted by hash,
through ``speculate()``, each with the curve fit its record carries
(journaled again with the replayed speculation).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

from rafiki_tpu_torch.advisor.service import AdvisorService
from rafiki_tpu_torch.obs.journal import journal as _journal
from rafiki_tpu_torch.obs.search.audit import knobs_hash


def journal_observations(records: Sequence[Dict[str, Any]],
                         advisor_id: Optional[str] = None,
                         exclude_hashes: Optional[set] = None,
                         ) -> List[Tuple[Dict[str, Any], float]]:
    """(knobs, score) pairs recoverable from ``kind="advisor"`` journal
    records alone: feedback joined to its propose by ``knobs_hash``.
    Deduplicated per hash (last score wins), excluding ``exclude_hashes``
    (observations the store already supplies), sorted by hash for a
    replay order independent of journal file interleaving."""
    knobs_by_hash: Dict[str, Dict[str, Any]] = {}
    score_by_hash: Dict[str, float] = {}
    for r in records:
        if r.get("kind") != "advisor":
            continue
        if advisor_id is not None and r.get("advisor_id") != advisor_id:
            continue
        if r.get("name") == "propose" and isinstance(r.get("knobs"), dict):
            knobs_by_hash[r.get("knobs_hash")] = r["knobs"]
        elif r.get("name") == "feedback" and r.get("knobs_hash"):
            try:
                score_by_hash[r["knobs_hash"]] = float(r.get("score"))
            except (TypeError, ValueError):
                continue
    out: List[Tuple[Dict[str, Any], float]] = []
    for h in sorted(score_by_hash):
        if exclude_hashes and h in exclude_hashes:
            continue
        if h in knobs_by_hash:
            out.append((knobs_by_hash[h], score_by_hash[h]))
    return out


def journal_speculations(records: Sequence[Dict[str, Any]],
                         advisor_id: Optional[str] = None,
                         exclude_hashes: Optional[set] = None,
                         ) -> List[Tuple[Dict[str, Any], float, Optional[dict]]]:
    """(knobs, predicted, fit) for every speculation still UNCORRECTED
    in the journals: an ``advisor/speculate`` record whose hash has no
    ``advisor/feedback`` record anywhere in the stream (a correction
    or true score supersedes the speculation). Last prediction wins
    per hash; sorted by hash like :func:`journal_observations` so the
    replay order is independent of journal interleaving."""
    spec_by_hash: Dict[str, Tuple[Dict[str, Any], float, Optional[dict]]] = {}
    fed_hashes: set = set()
    for r in records:
        if r.get("kind") != "advisor":
            continue
        if advisor_id is not None and r.get("advisor_id") != advisor_id:
            continue
        if r.get("name") == "feedback" and r.get("knobs_hash"):
            fed_hashes.add(r["knobs_hash"])
        elif r.get("name") == "speculate" \
                and isinstance(r.get("knobs"), dict):
            try:
                pred = float(r.get("predicted"))
            except (TypeError, ValueError):
                continue
            spec_by_hash[r.get("knobs_hash")] = (
                r["knobs"], pred,
                r.get("fit") if isinstance(r.get("fit"), dict) else None)
    out = []
    for h in sorted(spec_by_hash):
        if h in fed_hashes:
            continue
        if exclude_hashes and h in exclude_hashes:
            continue
        out.append(spec_by_hash[h])
    return out


def rehydrate_advisor(advisors: AdvisorService,
                      knob_config,
                      kind: str,
                      advisor_id: str,
                      completed: Sequence[Dict[str, Any]],
                      journal_records: Sequence[Dict[str, Any]] = (),
                      seed: int = 0,
                      engine_kwargs: Optional[dict] = None,
                      job_id: Optional[str] = None) -> str:
    """Build a fresh advisor under the dead sweep's ``advisor_id`` and
    replay its observations into it. ``completed`` are MetaStore trial
    rows (replayed sorted by ``no``); ``journal_records`` supplement
    scores that never became completed rows. Returns the advisor id
    (identical to the input — the identity is adopted so post-resume
    audit records join the same sweep in ``obs sweep``)."""
    aid = advisors.create_advisor(knob_config, kind=kind, seed=seed,
                                  advisor_id=advisor_id,
                                  engine_kwargs=engine_kwargs)
    try:
        advisors.get(aid).job_id = job_id
    except KeyError:
        pass
    obs: List[Tuple[Dict[str, Any], float]] = []
    seen = set()
    for t in sorted(completed, key=lambda t: (t.get("no") or 0, t["id"])):
        if t.get("score") is None or not isinstance(t.get("knobs"), dict):
            continue
        obs.append((t["knobs"], float(t["score"])))
        seen.add(knobs_hash(t["knobs"]))
    obs.extend(journal_observations(journal_records, advisor_id=advisor_id,
                                    exclude_hashes=seen))
    for kn, score in obs:
        advisors.feedback(aid, score, kn)
    # Real observations first, THEN speculations still in flight at the
    # crash — same op order a fresh advisor would see, which is what
    # keeps post-resume proposals byte-identical (module docstring).
    scored = seen | {knobs_hash(kn) for kn, _ in obs}
    specs = journal_speculations(journal_records, advisor_id=advisor_id,
                                 exclude_hashes=scored)
    for kn, pred, fit in specs:
        advisors.speculate(aid, pred, kn, fit=fit)
    _journal.record("recovery", "rehydrated", advisor_id=aid,
                    job_id=job_id, engine=kind, n_observations=len(obs),
                    n_from_store=len(seen), n_from_journal=len(obs) - len(seen),
                    n_speculations=len(specs))
    return aid
