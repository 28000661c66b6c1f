"""Advisor ABC + knob-space vectorisation shared by engines.

The port's own copy of ``rafiki_tpu/advisor/base.py`` (``KnobSpace``,
``BaseAdvisor``, ``make_advisor``): the same encoding, the same
pending (constant-liar) bookkeeping, the same speculate/correct hooks
and the same search-audit journal records (``obs/search/audit.py``),
so from one seed and one scored history every engine proposes what the
JAX package's does and journals the same ``advisor/*`` records.

The vectorisation (knobs dict <-> R^d point) lives here so every engine
shares one encoding:
  * FloatKnob(is_exp)   -> log-space float dim
  * IntegerKnob         -> float dim, rounded on decode (log if is_exp)
  * CategoricalKnob     -> one float dim in [0, k), floor on decode
  * FixedKnob           -> excluded from the search space
"""

from __future__ import annotations

import math
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from rafiki_tpu_torch.model.knobs import (
    BaseKnob,
    CategoricalKnob,
    FixedKnob,
    FloatKnob,
    IntegerKnob,
    KnobConfig,
    Knobs,
)
from rafiki_tpu_torch.obs.search import audit
from rafiki_tpu_torch.obs.search.audit import knobs_hash  # noqa: F401  (re-exported)


class KnobSpace:
    """Bidirectional mapping between knob dicts and unit-ish R^d vectors."""

    def __init__(self, knob_config: KnobConfig):
        self.knob_config = dict(knob_config)
        self.dims: List[Tuple[str, BaseKnob]] = [
            (name, k) for name, k in sorted(knob_config.items())
            if not isinstance(k, FixedKnob)
        ]
        self.fixed: Knobs = {
            name: k.value for name, k in knob_config.items() if isinstance(k, FixedKnob)
        }

    @property
    def d(self) -> int:
        return len(self.dims)

    def bounds(self) -> np.ndarray:
        """(d, 2) array of [lo, hi] in encoded space."""
        out = []
        for _, k in self.dims:
            if isinstance(k, (FloatKnob, IntegerKnob)):
                lo, hi = ((math.log(k.value_min), math.log(k.value_max))
                          if k.is_exp else (k.value_min, k.value_max))
            elif isinstance(k, CategoricalKnob):
                lo, hi = 0.0, float(len(k.values)) - 1e-9
            else:
                raise TypeError(f"Unsupported knob type {type(k).__name__}")
            out.append((lo, hi))
        return np.asarray(out, dtype=np.float64) if out else np.zeros((0, 2))

    def encode(self, knobs: Knobs) -> np.ndarray:
        v = np.zeros(self.d)
        for i, (name, k) in enumerate(self.dims):
            val = knobs[name]
            if isinstance(k, (FloatKnob, IntegerKnob)):
                v[i] = math.log(val) if k.is_exp else float(val)
            elif isinstance(k, CategoricalKnob):
                v[i] = float(k.values.index(val))
        return v

    def decode(self, v: np.ndarray) -> Knobs:
        knobs = dict(self.fixed)
        b = self.bounds()
        for i, (name, k) in enumerate(self.dims):
            x = float(np.clip(v[i], b[i, 0], b[i, 1]))
            if isinstance(k, FloatKnob):
                val = float(math.exp(x)) if k.is_exp else float(x)
                # exp(log(max)) can overshoot max by 1 ulp -> clamp
                knobs[name] = min(max(val, k.value_min), k.value_max)
            elif isinstance(k, IntegerKnob):
                val = int(round(math.exp(x))) if k.is_exp else int(round(x))
                knobs[name] = int(np.clip(val, k.value_min, k.value_max))
            elif isinstance(k, CategoricalKnob):
                knobs[name] = k.values[int(x)]
        return knobs

    def sample(self, rng: np.random.Generator) -> Knobs:
        knobs = dict(self.fixed)
        for name, k in self.dims:
            knobs[name] = k.sample(rng)
        return knobs


class BaseAdvisor:
    """Ask/tell interface (reference: Advisor.propose()/feedback()).

    Thread-safe: the scheduler shares one advisor across all train
    workers; ask/tell are serialized behind a lock.
    """

    #: constant-liar list cap: a worker that dies before feedback()
    #: must not suppress a region forever (oldest liars expire first).
    PENDING_CAP = 16

    #: short engine tag stamped onto every advisor/* journal record;
    #: subclasses override.
    engine = "base"

    def __init__(self, knob_config: KnobConfig, seed: int = 0):
        self.space = KnobSpace(knob_config)
        self.knob_config = dict(knob_config)
        self.seed = int(seed)
        # Stamped by AdvisorService / the mesh scheduler so journal
        # records are filterable per sweep; None for bare advisors.
        self.advisor_id: Optional[str] = None
        self.job_id: Optional[str] = None
        self._rng = np.random.default_rng(seed)
        self._lock = threading.Lock()
        self.history: List[Tuple[Knobs, float]] = []
        # Proposed-but-unscored points (constant liars). Engines add
        # via _pending_add and read via _pending_dists; the drain on
        # feedback happens here so no engine can forget it.
        self._pending: List[np.ndarray] = []
        # Speculative scores in flight: knobs_hash -> predicted score.
        # feedback() routes the true score into a correction instead of
        # a fresh observation; never touches `history`.
        self._speculative: Dict[str, float] = {}

    def propose(self) -> Knobs:
        with self._lock:
            return self._propose()

    def propose_batch(self, n: int) -> List[Knobs]:
        """q proposals at once. Default: n sequential ``_propose`` calls
        under one lock hold (the constant-liar pending list steers each
        call away from its predecessors)."""
        with self._lock:
            return self._propose_batch(max(1, int(n)))

    def feedback(self, score: float, knobs: Knobs) -> None:
        with self._lock:
            predicted = self._speculative.pop(knobs_hash(knobs), None)
            self.history.append((dict(knobs), float(score)))
            if self._pending and self.space.d:
                x = self.space.encode(knobs)
                self._pending = [p for p in self._pending
                                 if not np.allclose(p, x, atol=1e-9)]
            if predicted is not None:
                self._correct(float(score), dict(knobs), predicted)
            else:
                self._feedback(float(score), dict(knobs))

    def speculate(self, score: float, knobs: Knobs, fit: Optional[Dict] = None) -> None:
        """Tell with a *predicted* score for a still-running trial
        (``advisor/speculative.py``; ``fit`` is its curve fit's record).
        The prediction enters the engine's training set (``_speculate``)
        but NOT ``history``; when the true score lands, ``feedback``
        routes it into ``_correct``. Idempotent per knob assignment while
        the speculation is outstanding."""
        with self._lock:
            h = knobs_hash(knobs)
            if h in self._speculative:
                return
            self._speculative[h] = float(score)
            # A speculation supersedes the constant-liar damping here.
            if self._pending and self.space.d:
                x = self.space.encode(knobs)
                self._pending = [p for p in self._pending
                                 if not np.allclose(p, x, atol=1e-9)]
            self._speculate(float(score), dict(knobs))
            audit.record_speculate(self, float(score), knobs, fit=fit)

    # -- constant-liar helpers (called under the lock) ----------------------

    def _pending_add(self, x: np.ndarray) -> None:
        """Record a proposal awaiting its score; capped on EVERY append."""
        self._pending.append(x)
        while len(self._pending) > self.PENDING_CAP:
            self._pending.pop(0)

    def _pending_dists(self, cand: np.ndarray, span: np.ndarray):
        """Span-normalized distance array (n_cand,) per pending point;
        engines turn these into their own damping."""
        for p in self._pending:
            yield np.linalg.norm((cand - p) / span, axis=1)

    def best(self) -> Optional[Tuple[Knobs, float]]:
        with self._lock:
            if not self.history:
                return None
            return max(self.history, key=lambda t: t[1])

    # engine hooks (called under the lock). Every implementation journals
    # its decision through rafiki_tpu_torch.obs.search.audit.
    def _propose(self) -> Knobs:
        raise NotImplementedError

    def _propose_batch(self, n: int) -> List[Knobs]:
        out = [self._propose() for _ in range(n)]
        audit.record_propose_batch(self, n, out, strategy="sequential")
        return out

    def _feedback(self, score: float, knobs: Knobs) -> None:
        """Engine hook: absorb a real score. Default: nothing to fit,
        the record alone."""
        audit.record_feedback(self, score, knobs)

    def _speculate(self, score: float, knobs: Knobs) -> None:
        """Engine hook: absorb a predicted score into the training set.
        Default no-op (engines without a surrogate)."""

    def _correct(self, score: float, knobs: Knobs, predicted: float) -> None:
        """Engine hook: the true score for a previously speculated
        assignment. Default: journal the correction, then treat it as a
        fresh observation."""
        audit.record_correct(self, knobs, predicted, score)
        self._feedback(score, knobs)


def make_advisor(knob_config: KnobConfig, kind: str = "gp", seed: int = 0,
                 **engine_kwargs) -> BaseAdvisor:
    """Factory: 'gp' (default), 'tpe' or 'random', under the JAX
    package's names and aliases. ``engine_kwargs`` pass through to the
    chosen engine's constructor (e.g. ``n_initial`` for GP)."""
    from rafiki_tpu_torch.advisor.gp import GpAdvisor
    from rafiki_tpu_torch.advisor.random_advisor import RandomAdvisor
    from rafiki_tpu_torch.advisor.tpe import TpeAdvisor

    kinds = {"gp": GpAdvisor, "bayesian": GpAdvisor, "btb_gp": GpAdvisor,
             "skopt": GpAdvisor, "random": RandomAdvisor,
             "tpe": TpeAdvisor, "hyperopt": TpeAdvisor}
    if kind not in kinds:
        raise ValueError(f"Unknown advisor kind {kind!r}; choose from {sorted(kinds)}")
    return kinds[kind](knob_config, seed=seed, **engine_kwargs)
