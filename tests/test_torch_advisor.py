"""The port's advisors against the JAX package's, on the CPU.

From one seed and one scored history, ``rafiki_tpu.advisor`` and
``rafiki_tpu_torch.advisor`` must propose the same knobs: random, TPE
and GP (whose port fits its own Gaussian process in numpy and scipy,
where the JAX package fits scikit-learn's). The GP's posterior and its
fitted hyperparameters are held against scikit-learn directly.
"""

import numpy as np
import pytest
import torch

import rafiki_tpu.model.knobs as jax_knobs
import rafiki_tpu_torch.model.knobs as port_knobs
from rafiki_tpu.advisor import make_advisor as jax_make_advisor
from rafiki_tpu_torch import telemetry
from rafiki_tpu_torch.advisor import make_advisor
from rafiki_tpu_torch.advisor.gp import GaussianProcess

# See test_torch_train.py: two intra-op threads per xdist worker.
torch.set_num_threads(2)

ROUNDS = 14
# The GP's posterior and fitted log-hyperparameters against
# scikit-learn's. Readings: 0 (the port computes the same operations in
# the same order); the bound leaves room for another BLAS build.
GP_RTOL = 1e-6


def bench_space(k):
    """The bench's canonical template (``bench.py BenchVgg``)."""
    return {"depth": k.FixedKnob(16), "width_mult": k.FixedKnob(1.0),
            "dropout": k.FloatKnob(0.0, 0.5),
            "learning_rate": k.FloatKnob(1e-4, 3e-2, is_exp=True),
            "batch_size": k.CategoricalKnob([64, 128, 256], affects_shape=True),
            "epochs": k.FixedKnob(1), "seed": k.FixedKnob(0)}


def small_space(k):
    """A small space with an integer knob (log-scaled) and a linear one."""
    return {"units": k.IntegerKnob(4, 64, is_exp=True),
            "layers": k.IntegerKnob(1, 4),
            "lr": k.FloatKnob(1e-3, 1e-1, is_exp=True)}


SPACES = {"bench": bench_space, "small": small_space}


def score(knobs) -> float:
    """A fixed synthetic objective with one peak in learning rate."""
    lr = knobs.get("learning_rate", knobs.get("lr"))
    s = 1.0 - (np.log10(lr) + 2.3) ** 2 / 4.0
    s -= 0.3 * knobs.get("dropout", 0.2)
    s += 0.01 * np.sqrt(knobs.get("units", 0)) - 0.02 * knobs.get("layers", 0)
    s += {64: 0.0, 128: 0.02, 256: -0.01}.get(knobs.get("batch_size"), 0.0)
    return float(s)


def drive(jax_adv, port_adv, rounds):
    """Propose, compare, score and feed back the same score to both."""
    seen = []
    for r in range(rounds):
        want, got = jax_adv.propose(), port_adv.propose()
        assert got == want, (r, got, want)
        jax_adv.feedback(score(want), want)
        port_adv.feedback(score(got), got)
        seen.append(got)
    return seen


@pytest.mark.parametrize("space", sorted(SPACES))
@pytest.mark.parametrize("kind", ["random", "tpe", "gp"])
def test_same_seed_and_history_give_the_same_proposals(kind, space):
    telemetry.reset()
    jax_adv = jax_make_advisor(SPACES[space](jax_knobs), kind=kind, seed=3)
    port_adv = make_advisor(SPACES[space](port_knobs), kind=kind, seed=3)
    seen = drive(jax_adv, port_adv, ROUNDS)
    assert len({tuple(sorted(k.items())) for k in seen}) == ROUNDS
    assert port_adv.best() == jax_adv.best()
    if kind == "gp":
        # 8 warm-up proposals; the GP fits from the 4th score on, so
        # rounds 9-14 come from expected improvement.
        assert telemetry.get_counter("advisor.gp_warmup_proposals") == 8
        assert telemetry.get_counter("advisor.gp_ei_proposals") == ROUNDS - 8


@pytest.mark.parametrize("space", sorted(SPACES))
def test_gp_posterior_and_fit_match_scikit_learn(space):
    from sklearn.gaussian_process import GaussianProcessRegressor
    from sklearn.gaussian_process.kernels import ConstantKernel, Matern, WhiteKernel

    adv = make_advisor(SPACES[space](port_knobs), kind="random", seed=5)
    X = np.vstack([adv.space.encode(adv.propose()) for _ in range(12)])
    y = np.asarray([score(adv.space.decode(x)) for x in X])
    b = adv.space.bounds()
    span = np.maximum(b[:, 1] - b[:, 0], 1e-12)
    kernel = (ConstantKernel(1.0) * Matern(length_scale=0.25 * span, nu=2.5)
              + WhiteKernel(noise_level=1e-4))
    ref = GaussianProcessRegressor(kernel=kernel, normalize_y=True, n_restarts_optimizer=1,
                                   random_state=1234).fit(X, y)
    got = GaussianProcess(0.25 * span, random_state=1234).fit(X, y)
    probe = np.random.default_rng(0).uniform(b[:, 0], b[:, 1], size=(64, len(span)))
    mu, sd = ref.predict(probe, return_std=True)
    got_mu, got_sd = got.predict(probe)
    np.testing.assert_allclose(got.theta, ref.kernel_.theta, rtol=GP_RTOL, atol=0)
    np.testing.assert_allclose(got_mu, mu, rtol=GP_RTOL, atol=0)
    np.testing.assert_allclose(got_sd, sd, rtol=GP_RTOL, atol=0)
    np.testing.assert_allclose(got.log_marginal_likelihood_value_,
                               ref.log_marginal_likelihood_value_, rtol=GP_RTOL)


def test_gp_with_one_dimension_matches_scikit_learn():
    """A one-knob space takes the isotropic Matern kernel."""
    from sklearn.gaussian_process import GaussianProcessRegressor
    from sklearn.gaussian_process.kernels import ConstantKernel, Matern, WhiteKernel

    X = np.random.default_rng(1).uniform(-3, 0, size=(9, 1))
    y = np.sin(3 * X[:, 0])
    kernel = ConstantKernel(1.0) * Matern(length_scale=np.array([0.75]), nu=2.5) + WhiteKernel(1e-4)
    ref = GaussianProcessRegressor(kernel=kernel, normalize_y=True, n_restarts_optimizer=1,
                                   random_state=7).fit(X, y)
    got = GaussianProcess(np.array([0.75]), random_state=7).fit(X, y)
    probe = np.linspace(-3, 0, 64)[:, None]
    mu, sd = ref.predict(probe, return_std=True)
    assert got.theta.shape == ref.kernel_.theta.shape == (3,)
    np.testing.assert_allclose(got.predict(probe)[0], mu, rtol=GP_RTOL, atol=0)
    np.testing.assert_allclose(got.predict(probe)[1], sd, rtol=GP_RTOL, atol=0)


def test_gp_posterior_of_a_constant_history():
    """Equal scores: the standard deviation of y counts as 1, as
    scikit-learn's ``normalize_y`` has it, and the fit stays finite."""
    from sklearn.gaussian_process import GaussianProcessRegressor
    from sklearn.gaussian_process.kernels import ConstantKernel, Matern, WhiteKernel

    X = np.random.default_rng(2).uniform(0, 1, size=(6, 2))
    y = np.full(6, 0.5)
    kernel = ConstantKernel(1.0) * Matern(length_scale=np.array([0.25, 0.25]), nu=2.5) + WhiteKernel(1e-4)
    ref = GaussianProcessRegressor(kernel=kernel, normalize_y=True, n_restarts_optimizer=1,
                                   random_state=3).fit(X, y)
    got = GaussianProcess(np.array([0.25, 0.25]), random_state=3).fit(X, y)
    probe = np.random.default_rng(4).uniform(0, 1, size=(64, 2))
    mu, sd = ref.predict(probe, return_std=True)
    np.testing.assert_allclose(got.predict(probe)[0], mu, rtol=GP_RTOL, atol=0)
    np.testing.assert_allclose(got.predict(probe)[1], sd, rtol=GP_RTOL, atol=0)


@pytest.mark.parametrize("kind", ["gp", "random"])
def test_constant_liar_batch_matches(kind):
    """``propose_batch`` past the warm-up: GP's constant-liar(min)
    q-batch (refit after each planted lie), random's n draws."""
    jax_adv = jax_make_advisor(bench_space(jax_knobs), kind=kind, seed=11)
    port_adv = make_advisor(bench_space(port_knobs), kind=kind, seed=11)
    drive(jax_adv, port_adv, 9)
    want, got = jax_adv.propose_batch(4), port_adv.propose_batch(4)
    assert got == want
    assert len({tuple(sorted(k.items())) for k in got}) == 4
    # The lies are gone: the next single proposal agrees too.
    assert port_adv.propose() == jax_adv.propose()


def test_speculation_then_correction_matches():
    """A predicted score for a running trial, then its true score."""
    jax_adv = jax_make_advisor(small_space(jax_knobs), kind="gp", seed=2)
    port_adv = make_advisor(small_space(port_knobs), kind="gp", seed=2)
    drive(jax_adv, port_adv, 9)
    k = port_adv.propose()
    assert jax_adv.propose() == k
    jax_adv.speculate(0.4, k)
    port_adv.speculate(0.4, k)
    assert port_adv.propose() == jax_adv.propose()
    jax_adv.feedback(score(k), k)
    port_adv.feedback(score(k), k)
    assert port_adv.propose() == jax_adv.propose()
    assert port_adv.history == jax_adv.history


def test_advisor_service_and_kinds():
    from rafiki_tpu_torch.advisor import AdvisorService
    from rafiki_tpu_torch.model.knobs import serialize_knob_config

    svc = AdvisorService()
    aid = svc.create_advisor(serialize_knob_config(small_space(port_knobs)), kind="tpe", seed=1)
    assert svc.create_advisor(small_space(port_knobs), advisor_id=aid) == aid
    knobs = svc.propose(aid)
    svc.feedback(aid, 0.5, knobs)
    assert svc.best(aid) == (knobs, 0.5)
    assert len(svc.propose_batch(aid, 3)) == 3
    svc.delete_advisor(aid)
    with pytest.raises(KeyError):
        svc.propose(aid)
    with pytest.raises(ValueError, match="Unknown advisor kind"):
        make_advisor(small_space(port_knobs), kind="nope")
    for alias in ("bayesian", "btb_gp", "skopt", "hyperopt"):
        assert type(make_advisor(small_space(port_knobs), kind=alias)).__name__ == \
            type(jax_make_advisor(small_space(jax_knobs), kind=alias)).__name__
