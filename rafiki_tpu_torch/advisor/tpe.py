"""Tree-structured Parzen Estimator (TPE) advisor.

The port's own copy of ``rafiki_tpu/advisor/tpe.py`` ``TpeAdvisor``
(numpy only), with its search-audit records, so ``make_advisor`` offers
the same kinds, proposes the same knobs from one seed and one scored
history, and journals the same ``advisor/*`` records.

TPE models p(x | good) and p(x | bad) with kernel density estimates
over the encoded knob space and proposes the candidate maximising the
density ratio l(x)/g(x) (Bergstra et al., NeurIPS 2011, "Algorithms for
Hyper-Parameter Optimization"). It is O(n) per proposal, so it stays
cheap past a few hundred observations.
"""

from __future__ import annotations

import math
from typing import List

import numpy as np

from rafiki_tpu_torch.advisor.base import BaseAdvisor
from rafiki_tpu_torch.model.knobs import CategoricalKnob, IntegerKnob, KnobConfig, Knobs
from rafiki_tpu_torch.obs.search import audit


class TpeAdvisor(BaseAdvisor):
    engine = "tpe"

    def __init__(self, knob_config: KnobConfig, seed: int = 0,
                 n_initial: int = 8, n_candidates: int = 64,
                 gamma: float = 0.25, epsilon: float = 0.1):
        super().__init__(knob_config, seed=seed)
        self.n_initial = n_initial
        self.n_candidates = n_candidates
        self.gamma = gamma  # top fraction modelled as "good"
        self.epsilon = epsilon  # fraction of pure-random proposals
        self._X: List[np.ndarray] = []
        self._y: List[float] = []

    def _dim_kinds(self, span):
        cat, cont, sizes, floors = [], [], {}, []
        for i, (name, k) in enumerate(self.space.dims):
            if isinstance(k, CategoricalKnob):
                cat.append(i)
                sizes[i] = len(k.values)
            else:
                cont.append(i)
                f = 0.05 * span[i]
                if isinstance(k, IntegerKnob):
                    # Floor at one integer step in ENCODED units: when
                    # the whole good set shares one value (std 0) at a
                    # range boundary, a sub-step bandwidth can never
                    # sample the neighbor and the dim locks up. For
                    # is_exp dims the widest encoded step is at the low
                    # boundary: log(min+1) - log(min).
                    step = (math.log(k.value_min + 1) - math.log(k.value_min)
                            if k.is_exp else 1.0)
                    f = max(f, step)
                floors.append(f)
        return cat, cont, sizes, np.asarray(floors)

    def _propose(self) -> Knobs:
        if self.space.d == 0:
            knobs = dict(self.space.fixed)
            audit.record_propose(self, knobs, {"phase": "fixed"})
            return knobs
        # Short-circuit order matters for RNG-stream parity: the
        # epsilon draw only happens past warmup.
        if (len(self._X) < max(2, self.n_initial)
                or self._rng.random() < self.epsilon):
            # Warmup (>=2 observations or the good/bad split is
            # degenerate) — or epsilon-exploration: the density-ratio
            # model can only believe what it has sampled, so a value
            # never proposed (e.g. a categorical choice absent from the
            # good set) would stay unproposed forever without this.
            phase = "warmup" if len(self._X) < max(2, self.n_initial) else "epsilon"
            knobs = self.space.sample(self._rng)
            self._pending_add(self.space.encode(knobs))
            audit.record_propose(self, knobs, {
                "phase": phase, "n_initial": self.n_initial, "epsilon": self.epsilon})
            return knobs

        b = self.space.bounds()
        span = np.maximum(b[:, 1] - b[:, 0], 1e-12)
        X = np.vstack(self._X)
        y = np.asarray(self._y)
        n_good = max(2, int(np.ceil(self.gamma * len(y))))
        order = np.argsort(-y)  # maximise score
        good, bad = X[order[:n_good]], X[order[n_good:]]
        if len(bad) < 2:
            bad = X  # degenerate early split: contrast against everything
        cat_idx, cont_idx, cat_sizes, floors = self._dim_kinds(span)

        n_cand = self.n_candidates + max(4, self.n_candidates // 8)
        cand = np.empty((n_cand, self.space.d))
        score = np.zeros(n_cand)

        if cont_idx:
            gc, bc = good[:, cont_idx], bad[:, cont_idx]
            # Scott-ish per-dim bandwidths, floored so early narrow
            # splits don't collapse the sampler (integer dims floor at
            # one step — see _dim_kinds).
            bw_g = np.maximum(gc.std(axis=0) * len(gc) ** (-1 / (len(cont_idx) + 4)),
                              floors)
            bw_b = np.maximum(bc.std(axis=0) * len(bc) ** (-1 / (len(cont_idx) + 4)),
                              floors)
            centers = gc[self._rng.integers(0, len(gc), size=self.n_candidates)]
            drawn = centers + self._rng.normal(0.0, bw_g, size=centers.shape)
            uniform = self._rng.uniform(b[cont_idx, 0], b[cont_idx, 1],
                                        size=(n_cand - self.n_candidates, len(cont_idx)))
            cc = np.clip(np.vstack([drawn, uniform]), b[cont_idx, 0], b[cont_idx, 1])
            cand[:, cont_idx] = cc
            score += self._log_kde(cc, gc, bw_g) - self._log_kde(cc, bc, bw_b)

        # Categorical dims: a KDE over category indices collapses onto
        # whatever the good set happens to contain (std 0 -> no mass on
        # unseen values). Model them as add-one-smoothed frequency
        # distributions instead: sampling keeps every category
        # reachable, and scoring is the smoothed log-probability ratio.
        for i in cat_idx:
            k = cat_sizes[i]
            cg = np.bincount(good[:, i].astype(int), minlength=k) + 1.0
            cb = np.bincount(bad[:, i].astype(int), minlength=k) + 1.0
            pg, pb = cg / cg.sum(), cb / cb.sum()
            draws = self._rng.choice(k, size=n_cand, p=pg)
            cand[:, i] = draws
            score += np.log(pg[draws]) - np.log(pb[draws])

        # Constant-liar: damp candidates near pending proposals
        # (bookkeeping in BaseAdvisor; only the damping shape here).
        for dist in self._pending_dists(cand, span):
            score = score - 4.0 * np.exp(-(dist / 0.05) ** 2)
        i = int(np.argmax(score))
        knobs = self.space.decode(cand[i])
        self._pending_add(self.space.encode(knobs))
        audit.record_propose(self, knobs, {
            "phase": "tpe", "log_ratio": round(float(score[i]), 6), "pool": int(n_cand),
            "n_good": int(n_good), "gamma": self.gamma})
        return knobs

    def _feedback(self, score: float, knobs: Knobs) -> None:
        self._X.append(self.space.encode(knobs))
        self._y.append(score)
        audit.record_feedback(self, score, knobs)

    @staticmethod
    def _log_kde(cand: np.ndarray, pts: np.ndarray, bw: np.ndarray) -> np.ndarray:
        """log mean_k N(cand; pts_k, diag(bw^2)), up to a shared const."""
        d2 = ((cand[:, None, :] - pts[None, :, :]) / bw) ** 2  # (c, k, d)
        logp = -0.5 * d2.sum(-1)  # (c, k)
        m = logp.max(axis=1, keepdims=True)
        return (m[:, 0] + np.log(np.exp(logp - m).mean(axis=1) + 1e-300)
                - np.log(bw).sum())
