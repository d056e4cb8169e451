"""PDEModel inverse-problem tests: recover known parameters from trajectories.

Exercises the reference's ``train``/``optimize`` surfaces
(``pde_model.py:325-551``) with this framework's LM / L-BFGS / Adam
optimizers differentiating through the scan rollouts.
"""

import jax
import jax.numpy as jnp
import numpy as np

import pde_opt_jax as p
from pde_opt_jax.models.functions import DiffusionLegendrePolynomials

N = 32
L = 0.01 * N
KAPPA_TRUE = 0.002
DT0 = 0.00025  # divides both the generation (0.0005) and training (0.001) save intervals
# so the effective substep is identical and the data is exactly reproducible.


def _domain():
    return p.Domain((N, N), ((-L / 2, L / 2), (-L / 2, L / 2)), dtype=jnp.float64)


def _model(domain):
    return p.PDEModel(
        equation_type=p.CahnHilliard2DPeriodic,
        domain=domain,
        solver_type=p.SemiImplicitFourierSpectral,
    )


def _make_data(model, mu, D, kappa=KAPPA_TRUE):
    key = jax.random.PRNGKey(0)
    y0 = jnp.clip(0.01 * jax.random.normal(key, (N, N)) + 0.5, 0.0, 1.0)
    ts = np.linspace(0.0, 0.004, 9)
    sol = model.solve(
        {"kappa": kappa, "mu": mu, "D": D, "derivs": "fd"},
        y0, ts, {"A": 0.5}, dt0=DT0,
    )
    return {"ys": list(sol), "ts": list(ts)}


MU = lambda c: c**3 - c
DCONST = lambda c: jnp.ones_like(c)


def test_train_least_squares_recovers_kappa():
    domain = _domain()
    model = _model(domain)
    data = _make_data(model, MU, DCONST)
    inds = [[0, 2, 4], [4, 6, 8]]
    res = model.train(
        data, inds,
        opt_parameters={"kappa": 0.004},
        other_parameters={"mu": MU, "D": DCONST, "derivs": "fd"},
        solver_parameters={"A": 0.5},
        weights={"kappa": None},
        lambda_reg=0.0,
        method="least_squares",
        max_steps=30,
        dt0=DT0,
    )
    assert abs(res["kappa"] - KAPPA_TRUE) < 2e-5
    assert res["mu"] is MU  # fixed params carried through


def test_train_mse_lbfgs_recovers_kappa():
    domain = _domain()
    model = _model(domain)
    data = _make_data(model, MU, DCONST)
    inds = [[0, 2, 4]]
    res = model.train(
        data, inds,
        opt_parameters={"kappa": 0.003},
        other_parameters={"mu": MU, "D": DCONST, "derivs": "fd"},
        solver_parameters={"A": 0.5},
        weights={"kappa": None},
        lambda_reg=0.0,
        method="mse",
        max_steps=40,
        dt0=DT0,
    )
    assert abs(res["kappa"] - KAPPA_TRUE) < 5e-4


def test_train_legendre_diffusivity():
    """Fit a Legendre-parameterized mobility D(u) through the rollout."""
    domain = _domain()
    model = _model(domain)
    true_D = DiffusionLegendrePolynomials(jnp.array([0.3, 0.2]))
    data = _make_data(model, MU, true_D)
    inds = [[0, 2, 4, 6]]
    init_D = DiffusionLegendrePolynomials(jnp.array([0.0, 0.0]))
    res = model.train(
        data, inds,
        opt_parameters={"D": init_D},
        other_parameters={"mu": MU, "kappa": KAPPA_TRUE, "derivs": "fd"},
        solver_parameters={"A": 0.5},
        weights={"D": None},
        lambda_reg=0.0,
        method="least_squares",
        max_steps=25,
        dt0=DT0,
    )
    got = np.asarray(res["D"].expansion.params)
    np.testing.assert_allclose(got, [0.3, 0.2], atol=2e-2)


def test_regularization_pytree_semantics():
    domain = _domain()
    model = _model(domain)
    params = {"kappa": 2.0, "D": DiffusionLegendrePolynomials(jnp.array([1.0, 2.0]))}
    weights = {"kappa": 1.0, "D": None}
    reg = model.regularization(params, weights, lambda_reg=0.5)
    np.testing.assert_allclose(float(reg), 0.5 * 1.0 * 4.0)
    # Weighted module params
    wmod = DiffusionLegendrePolynomials(jnp.array([1.0, 1.0]))
    reg2 = model.regularization(
        {"D": params["D"]}, {"D": wmod}, lambda_reg=1.0
    )
    np.testing.assert_allclose(float(reg2), 1.0 + 4.0)


def test_optimize_objective_control():
    """optimize() drives kappa to minimize interface energy proxy."""
    domain = _domain()
    model = _model(domain)
    key = jax.random.PRNGKey(0)
    y0 = jnp.clip(0.01 * jax.random.normal(key, (N, N)) + 0.5, 0.0, 1.0)
    ts = np.linspace(0.0, 0.002, 4)

    target = 0.0025

    def objective(sol):
        # Quadratic in the *parameter's effect*: pull final variance toward
        # the variance obtained with kappa=target (precomputed).
        return jnp.sum((sol[-1] - ref_sol[-1]) ** 2)

    ref_sol = model.solve(
        {"kappa": target, "mu": MU, "D": DCONST, "derivs": "fd"},
        y0, ts, {"A": 0.5}, dt0=DT0,
    )
    res = model.optimize(
        objective, y0, ts,
        opt_parameters={"kappa": 0.004},
        other_parameters={"mu": MU, "D": DCONST, "derivs": "fd"},
        solver_parameters={"A": 0.5},
        weights={"kappa": None},
        lambda_reg=0.0,
        max_steps=25,
        dt0=DT0,
    )
    assert abs(res["kappa"] - target) < 5e-4


def test_train_least_squares_jitted_recovers_kappa():
    """The device-resident (single while_loop) LM matches the host-loop fit."""
    domain = _domain()
    model = _model(domain)
    data = _make_data(model, MU, DCONST)
    inds = [[0, 2, 4], [4, 6, 8]]
    res = model.train(
        data, inds,
        opt_parameters={"kappa": 0.004},
        other_parameters={"mu": MU, "D": DCONST, "derivs": "fd"},
        solver_parameters={"A": 0.5},
        weights={"kappa": None},
        lambda_reg=0.0,
        method="least_squares_jit",
        max_steps=30,
        dt0=DT0,
    )
    assert abs(res["kappa"] - KAPPA_TRUE) < 2e-5


def test_lm_jitted_reports_stall_as_not_converged():
    from pde_opt_jax.optim import least_squares_lm, least_squares_lm_jitted

    # Residual with a floor at a nonzero value and a cliff to NaN for any
    # step away from theta0: no damping level can improve -> stall.
    def residual(theta):
        return jnp.where(jnp.all(theta == 1.0), jnp.ones(3),
                         jnp.full(3, jnp.nan))

    theta0 = jnp.ones(2)
    for solver in (least_squares_lm, least_squares_lm_jitted):
        out = solver(residual, theta0, max_steps=5)
        assert not out.converged
