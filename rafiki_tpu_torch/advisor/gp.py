"""Gaussian-process Bayesian optimisation (expected improvement).

The port's own copy of ``rafiki_tpu/advisor/gp.py`` ``GpAdvisor``. The
JAX package fits scikit-learn's ``GaussianProcessRegressor``; the port
may not need scikit-learn, so :class:`GaussianProcess` below is its own
regressor in numpy and scipy. It computes what the JAX package asks of
scikit-learn, in the same order of operations, so that from one seed
and one scored history both advisors propose the same knobs:

  * kernel ``ConstantKernel(1.0) * Matern(length_scale=0.25*span,
    nu=2.5) + WhiteKernel(1e-4)``, the Matern anisotropic when the space
    has more than one dimension; each hyperparameter bounded to
    (1e-5, 1e5) and searched as log-theta;
  * ``normalize_y=True`` (a standard deviation of 0 counts as 1) and a
    diagonal jitter of ``alpha=1e-10``;
  * the fit: the negative log marginal likelihood and its analytic
    gradient minimised by ``scipy.optimize.minimize(method="L-BFGS-B",
    jac=True)`` from the initial theta, then from one restart drawn by
    ``np.random.RandomState(random_state).uniform`` over the log bounds;
    the lower minimum wins (the first on a tie);
  * ``predict(return_std=True)``: the white-noise term counts in the
    prior variance but not in the cross-kernel, and a negative
    posterior variance is clipped to 0.

The advisor consumes its ``np.random.default_rng`` as the JAX package's
does: one ``integers(1 << 31)`` per fit, then the candidate ``uniform``
draws and the local ``normal`` draws per EI proposal. Each proposal,
batch, feedback and correction is journaled as the JAX package's
(``obs/search/audit.py``: phase, EI, posterior mean and standard
deviation, pool, fit seconds), and its phase is also counted in
telemetry (``advisor.gp_warmup_proposals``, ``advisor.gp_ei_proposals``,
``advisor.gp_fixed_proposals``).

Startup behaviour: the first ``n_initial`` proposals are random
exploration; after that, EI argmax over a random candidate set plus
local perturbations of the incumbent.
"""

from __future__ import annotations

import math
import time
from typing import Dict, List, Optional

import numpy as np
import scipy.optimize
from scipy.linalg import cho_solve, cholesky, solve_triangular
from scipy.spatial.distance import cdist, pdist, squareform
from scipy.stats import norm

from rafiki_tpu_torch import telemetry
from rafiki_tpu_torch.advisor.base import BaseAdvisor, knobs_hash
from rafiki_tpu_torch.model.knobs import KnobConfig, Knobs
from rafiki_tpu_torch.obs.search import audit

_BOUNDS = (1e-5, 1e5)
_ALPHA = 1e-10


def _matern52(X: np.ndarray, length_scale: np.ndarray, Y: Optional[np.ndarray] = None,
              eval_gradient: bool = False):
    """Matern nu=2.5 kernel matrix, and with ``eval_gradient`` its
    gradient in log length-scale, (n, n, d) anisotropic or (n, n, 1)."""
    anisotropic = length_scale.shape[0] > 1
    ls = length_scale if anisotropic else length_scale[0]
    if Y is None:
        dists = pdist(X / ls, metric="euclidean")
    else:
        dists = cdist(X / ls, Y / ls, metric="euclidean")
    K = dists * math.sqrt(5)
    K = (1.0 + K + K**2 / 3.0) * np.exp(-K)
    if Y is None:
        K = squareform(K)
        np.fill_diagonal(K, 1)
    if not eval_gradient:
        return K
    if anisotropic:
        D = (X[:, np.newaxis, :] - X[np.newaxis, :, :]) ** 2 / (ls**2)
    else:
        D = squareform(dists**2)[:, :, np.newaxis]
    tmp = np.sqrt(5 * D.sum(-1))[..., np.newaxis]
    K_gradient = 5.0 / 3.0 * D * (tmp + 1) * np.exp(-tmp)
    if not anisotropic:
        K_gradient = K_gradient[:, :].sum(-1)[:, :, np.newaxis]
    return K, K_gradient


class GaussianProcess:
    """GP regressor with the kernel ``C * Matern52 + White`` and
    scikit-learn's fit and predict (see the module docstring).

    ``theta`` is ``log([constant, length_scale..., noise])``."""

    def __init__(self, length_scale: np.ndarray, random_state: int,
                 constant: float = 1.0, noise_level: float = 1e-4):
        length_scale = np.asarray(length_scale, dtype=np.float64).reshape(-1)
        # A one-dimensional space gets the isotropic kernel, whose
        # length scale is one hyperparameter.
        n_ls = max(1, length_scale.shape[0])
        self.theta = np.log(np.hstack([constant, length_scale[:n_ls], noise_level]))
        self.bounds = np.log(np.vstack([_BOUNDS] * (n_ls + 2)))
        self.random_state = int(random_state)

    def _params(self, theta: np.ndarray):
        return np.exp(theta[0]), np.exp(theta[1:-1]), np.exp(theta[-1])

    def kernel(self, theta: np.ndarray, X: np.ndarray, Y: Optional[np.ndarray] = None,
               eval_gradient: bool = False):
        """The kernel matrix at ``theta`` (and its gradient in theta,
        (n, n, len(theta)))."""
        c, ls, noise = self._params(theta)
        if not eval_gradient:
            K1 = np.full((X.shape[0], X.shape[0] if Y is None else Y.shape[0]), c)
            K1 = K1 * _matern52(X, ls, Y)
            K2 = noise * np.eye(X.shape[0]) if Y is None else np.zeros((X.shape[0], Y.shape[0]))
            return K1 + K2
        n = X.shape[0]
        Kc = np.full((n, n), c)
        Kc_gradient = np.full((n, n, 1), c)
        Km, Km_gradient = _matern52(X, ls, eval_gradient=True)
        K1 = Kc * Km
        K1_gradient = np.dstack((Kc_gradient * Km[:, :, np.newaxis],
                                 Km_gradient * Kc[:, :, np.newaxis]))
        K2 = noise * np.eye(n)
        K2_gradient = noise * np.eye(n)[:, :, np.newaxis]
        return K1 + K2, np.dstack((K1_gradient, K2_gradient))

    def diag(self, theta: np.ndarray, X: np.ndarray) -> np.ndarray:
        c, _, noise = self._params(theta)
        return np.full(X.shape[0], c) * np.ones(X.shape[0]) + np.full(X.shape[0], noise)

    def log_marginal_likelihood(self, theta: np.ndarray):
        """The log marginal likelihood of the training data at ``theta``
        and its gradient in theta."""
        K, K_gradient = self.kernel(theta, self.X_train_, eval_gradient=True)
        K[np.diag_indices_from(K)] += _ALPHA
        try:
            L = cholesky(K, lower=True, check_finite=False)
        except np.linalg.LinAlgError:
            return -np.inf, np.zeros_like(theta)
        y_train = self.y_train_[:, np.newaxis]
        alpha = cho_solve((L, True), y_train, check_finite=False)
        log_likelihood_dims = -0.5 * np.einsum("ik,ik->k", y_train, alpha)
        log_likelihood_dims -= np.log(np.diag(L)).sum()
        log_likelihood_dims -= K.shape[0] / 2 * np.log(2 * np.pi)
        log_likelihood = log_likelihood_dims.sum(axis=-1)
        inner_term = np.einsum("ik,jk->ijk", alpha, alpha)
        K_inv = cho_solve((L, True), np.eye(K.shape[0]), check_finite=False)
        inner_term -= K_inv[..., np.newaxis]
        log_likelihood_gradient_dims = 0.5 * np.einsum("ijl,jik->kl", inner_term, K_gradient)
        return log_likelihood, log_likelihood_gradient_dims.sum(axis=-1)

    def _minimize(self, theta0: np.ndarray):
        def obj(theta):
            lml, grad = self.log_marginal_likelihood(theta)
            return -lml, -grad

        res = scipy.optimize.minimize(obj, theta0, method="L-BFGS-B", jac=True,
                                      bounds=self.bounds)
        return res.x, res.fun

    def fit(self, X: np.ndarray, y: np.ndarray) -> "GaussianProcess":
        X = np.asarray(X, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        self._y_train_mean = np.mean(y, axis=0)
        std = np.std(y, axis=0)
        self._y_train_std = 1.0 if std == 0.0 else std
        self.X_train_ = np.copy(X)
        self.y_train_ = (y - self._y_train_mean) / self._y_train_std
        rng = np.random.RandomState(self.random_state)
        optima = [self._minimize(self.theta)]
        optima.append(self._minimize(rng.uniform(self.bounds[:, 0], self.bounds[:, 1])))
        lml_values = [o[1] for o in optima]
        self.theta = optima[int(np.argmin(lml_values))][0]
        self.log_marginal_likelihood_value_ = -np.min(lml_values)
        K = self.kernel(self.theta, self.X_train_)
        K[np.diag_indices_from(K)] += _ALPHA
        self.L_ = cholesky(K, lower=True, check_finite=False)
        self.alpha_ = cho_solve((self.L_, True), self.y_train_, check_finite=False)
        return self

    def predict(self, X: np.ndarray):
        """Posterior mean and standard deviation at ``X``."""
        X = np.asarray(X, dtype=np.float64)
        K_trans = self.kernel(self.theta, X, self.X_train_)
        y_mean = K_trans @ self.alpha_
        y_mean = self._y_train_std * y_mean + self._y_train_mean
        V = solve_triangular(self.L_, K_trans.T, lower=True, check_finite=False)
        y_var = self.diag(self.theta, X).copy()
        y_var -= np.einsum("ij,ji->i", V.T, V)
        y_var[y_var < 0] = 0.0
        y_var = y_var * self._y_train_std**2
        return y_mean, np.sqrt(y_var)


class GpAdvisor(BaseAdvisor):
    engine = "gp"

    def __init__(self, knob_config: KnobConfig, seed: int = 0,
                 n_initial: int = 8, n_candidates: int = 512, xi: float = 0.01):
        super().__init__(knob_config, seed=seed)
        self.n_initial = n_initial
        self.n_candidates = n_candidates
        self.xi = xi
        self._X: List[np.ndarray] = []
        self._y: List[float] = []
        self._gp: Optional[GaussianProcess] = None
        self._last_fit_s: Optional[float] = None
        # Speculative training rows: knobs_hash -> index into _X/_y.
        self._spec_idx: Dict[str, int] = {}

    def _propose(self) -> Knobs:
        if self.space.d == 0:
            telemetry.inc("advisor.gp_fixed_proposals")
            knobs = dict(self.space.fixed)
            audit.record_propose(self, knobs, {"phase": "fixed"})
            return knobs
        if len(self._X) < self.n_initial or self._gp is None:
            knobs = self.space.sample(self._rng)
            self._pending_add(self.space.encode(knobs))
            telemetry.inc("advisor.gp_warmup_proposals")
            audit.record_propose(self, knobs, {"phase": "warmup", "n_initial": self.n_initial})
            return knobs
        b = self.space.bounds()
        cand = self._rng.uniform(b[:, 0], b[:, 1], size=(self.n_candidates, self.space.d))
        # Refine a slice of candidates around the incumbent (local search)
        best_x = self._X[int(np.argmax(self._y))]
        local = best_x[None, :] + self._rng.normal(
            0.0, 0.1 * (b[:, 1] - b[:, 0]), size=(self.n_candidates // 4, self.space.d))
        cand = np.clip(np.vstack([cand, local]), b[:, 0], b[:, 1])
        ei, mu, sigma = self._expected_improvement(cand)
        # Penalise candidates near pending (liar) points so concurrent
        # workers don't all get the same proposal.
        span = np.maximum(b[:, 1] - b[:, 0], 1e-12)
        ei_damped = ei
        for dist in self._pending_dists(cand, span):
            ei_damped = ei_damped * (1.0 - np.exp(-(dist / 0.05) ** 2))
        i = int(np.argmax(ei_damped))
        knobs = self.space.decode(cand[i])
        # Store the *re-encoded* point: decode rounds integer/categorical
        # dims, and the feedback drain removes by encode(knobs).
        self._pending_add(self.space.encode(knobs))
        telemetry.inc("advisor.gp_ei_proposals")
        audit.record_propose(self, knobs, {
            "phase": "ei",
            "ei": round(float(ei[i]), 9),
            "ei_damped": round(float(ei_damped[i]), 9),
            "mu": round(float(mu[i]), 6),
            "sigma": round(float(sigma[i]), 6),
            "pool": int(len(cand)),
            "fit_s": self._last_fit_s,
        })
        return knobs

    def _propose_batch(self, n: int) -> List[Knobs]:
        """q-batch via the constant-liar(min) strategy: after each pick,
        pretend it scored the worst value seen and refit, so the next
        pick explores elsewhere. The lies are popped (and the GP refit on
        real data) before returning."""
        if self.space.d == 0 or self._gp is None or len(self._X) < self.n_initial:
            return super()._propose_batch(n)  # still exploring randomly
        out: List[Knobs] = []
        lies = 0
        lie = float(min(self._y))
        try:
            for _ in range(n):
                knobs = self._propose()
                out.append(knobs)
                self._X.append(self.space.encode(knobs))
                self._y.append(lie)
                lies += 1
                self._fit()
        finally:
            if lies:
                del self._X[-lies:]
                del self._y[-lies:]
                self._fit()
        audit.record_propose_batch(self, n, out, strategy="constant_liar_min",
                                   liar={"lie": round(lie, 6), "lies_planted": len(out)})
        return out

    def _feedback(self, score: float, knobs: Knobs) -> None:
        self._X.append(self.space.encode(knobs))
        self._y.append(score)
        if len(self._X) >= max(2, min(self.n_initial, 4)):
            self._fit()
        audit.record_feedback(self, score, knobs)

    def _speculate(self, score: float, knobs: Knobs) -> None:
        """A predicted score enters the training set as a provisional
        row; ``_correct`` replaces its y in place when the truth lands."""
        self._spec_idx[knobs_hash(knobs)] = len(self._X)
        self._X.append(self.space.encode(knobs))
        self._y.append(score)
        if len(self._X) >= max(2, min(self.n_initial, 4)):
            self._fit()

    def _correct(self, score: float, knobs: Knobs, predicted: float) -> None:
        """True score replaces the speculative row and the GP refits."""
        idx = self._spec_idx.pop(knobs_hash(knobs), None)
        if idx is None:
            # Known to the base but never absorbed here: a plain append.
            audit.record_correct(self, knobs, predicted, score)
            self._feedback(score, knobs)
            return
        self._y[idx] = score
        if len(self._X) >= max(2, min(self.n_initial, 4)):
            self._fit()
        audit.record_correct(self, knobs, predicted, score)
        audit.record_feedback(self, score, knobs)

    def _fit(self) -> None:
        t0 = time.monotonic()
        X = np.vstack(self._X)
        y = np.asarray(self._y)
        # Canonical row order before fitting: the Cholesky is not
        # bit-level permutation-invariant, so the same observation SET
        # in another arrival order must give the same proposals.
        if len(y) > 1:
            order = np.lexsort(np.concatenate([X, y[:, None]], axis=1).T[::-1])
            X = X[order]
            y = y[order]
        b = self.space.bounds()
        span = np.maximum(b[:, 1] - b[:, 0], 1e-12)
        gp = GaussianProcess(0.25 * span, random_state=int(self._rng.integers(1 << 31)))
        self._gp = gp.fit(X, y)
        # The fit's wall seconds ride the next propose record.
        self._last_fit_s = round(time.monotonic() - t0, 6)

    def _expected_improvement(self, cand: np.ndarray):
        """EI per candidate, with the posterior mean and standard
        deviation it was computed from."""
        mu, sigma = self._gp.predict(cand)
        sigma = np.maximum(sigma, 1e-9)
        best = max(self._y)
        z = (mu - best - self.xi) / sigma
        return (mu - best - self.xi) * norm.cdf(z) + sigma * norm.pdf(z), mu, sigma
