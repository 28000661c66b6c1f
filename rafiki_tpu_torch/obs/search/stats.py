"""Seeded bootstrap statistics for the sweep reconstruction.

The port's own copy of ``rafiki_tpu/obs/search/stats.py``
(``bootstrap_ci``, ``regret_curve``): numpy's seeded generator and the
same operations, so a CI printed by either package's ``obs sweep`` on
one journal is the same. Deterministic under a fixed seed.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence

DEFAULT_N_BOOT = 1000


def bootstrap_ci(diffs: Sequence[float], n_boot: int = DEFAULT_N_BOOT,
                 seed: int = 0, alpha: float = 0.05) -> Dict[str, Any]:
    """Percentile bootstrap CI of the mean of ``diffs``.

    ``diffs`` are paired per-position score differences (advisor minus
    random); the interval answers "is the lift real or seed noise".
    Returns ``{"mean", "lo", "hi", "n", "n_boot", "seed"}``; degenerate
    inputs (fewer than 2 points) collapse the interval onto the mean.
    """
    import numpy as np

    arr = np.asarray(list(diffs), dtype=float)
    n = int(arr.size)
    if n == 0:
        return {"mean": None, "lo": None, "hi": None, "n": 0,
                "n_boot": int(n_boot), "seed": int(seed)}
    mean = float(arr.mean())
    if n == 1:
        return {"mean": round(mean, 6), "lo": round(mean, 6),
                "hi": round(mean, 6), "n": 1,
                "n_boot": int(n_boot), "seed": int(seed)}
    rng = np.random.default_rng(int(seed))
    idx = rng.integers(0, n, size=(int(n_boot), n))
    means = arr[idx].mean(axis=1)
    lo, hi = np.quantile(means, [alpha / 2.0, 1.0 - alpha / 2.0])
    return {"mean": round(mean, 6), "lo": round(float(lo), 6),
            "hi": round(float(hi), 6), "n": n,
            "n_boot": int(n_boot), "seed": int(seed)}


def regret_curve(scores: Sequence[float]) -> Dict[str, Any]:
    """Best-so-far and regret trajectories for an ordered score list.

    ``regret[t] = max(scores) - best_so_far[t]`` — non-increasing by
    construction and 0 at the end; ``mean_regret`` (the area under the
    curve, normalised by length) is the scalar the SWEEP artifact
    trends: a sharper advisor front-loads good proposals and shrinks
    it at equal final best.
    """
    best_so_far = []
    best = None
    for s in scores:
        best = s if best is None else max(best, s)
        best_so_far.append(best)
    if best is None:
        return {"best_so_far": [], "regret": [], "mean_regret": None,
                "best_score": None}
    regret = [round(best - b, 6) for b in best_so_far]
    return {
        "best_so_far": [round(b, 6) for b in best_so_far],
        "regret": regret,
        "mean_regret": round(sum(regret) / len(regret), 6),
        "best_score": round(best, 6),
    }
