"""Smoothed-boundary galvanostatic Butler-Volmer: golden parity + fleet.

Covers the reference's flagship physics workload (SBM constant-current
charging, ``/root/reference/pde_opt/numerics/equations/allen_cahn.py:284-383``,
``notebooks/run_butler_volmer_sbm.ipynb``): the equation against the
pure-numpy golden (field AND ψ-weighted voltage trace), and the env preset
(``make_sbm_butler_volmer_control_env``) including the ψ-weighted charge
balance the closure enforces.
"""

import pytest
import os

import jax
import jax.numpy as jnp
import numpy as np

import pde_opt_jax as p
from pde_opt_jax.envs import make_sbm_butler_volmer_control_env
from pde_opt_jax.models.allen_cahn import (
    AllenCahn2DSmoothedBoundaryButlerVolmerConstantCurrent,
)
from pde_opt_jax.ops.integrate import evolve
from pde_opt_jax.ops.steppers import RK4

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens",
                      "sbm_bv_cc_rk4.npz")

CLIP = lambda c: jnp.clip(c, 1e-4, 1 - 1e-4)
MU = lambda c: jnp.log(CLIP(c) / (1 - CLIP(c))) + 3.0 * (1.0 - 2.0 * c)
J0 = lambda c: jnp.sqrt(jnp.clip(c * (1 - c), 1e-6, None))
F = lambda c: 3.0 * c * (1.0 - c)


def _equation_from_golden(g):
    N = int(g["N"])
    domain = p.Domain((N, N), ((-0.5, 0.5), (-0.5, 0.5)))
    return AllenCahn2DSmoothedBoundaryButlerVolmerConstantCurrent(
        domain, kappa=float(g["kappa"]), f=F, mu=MU, j0=J0,
        alpha=float(g["alpha"]), Crate=float(g["Crate"]),
        psi=jnp.asarray(g["psi"]),
    )


def test_sbm_bv_golden_field_and_voltage_parity():
    """RK4 rollout matches the numpy transcription of the cited reference
    formulas at 1e-12 per save point — field and ψ-weighted voltage."""
    g = np.load(GOLDEN)
    eq = _equation_from_golden(g)
    dt = float(g["dt"])
    save = int(g["save_every"])
    u = jnp.asarray(g["u0"], jnp.float64)
    stepper = RK4()

    for i in range(1, g["traj"].shape[0]):
        u = evolve(stepper, eq.rhs, u, (i - 1) * save * dt, dt, save)
        np.testing.assert_allclose(np.asarray(u), g["traj"][i],
                                   rtol=0, atol=1e-12)
        np.testing.assert_allclose(float(eq.get_voltage(u)),
                                   float(g["volts"][i]), rtol=0, atol=1e-12)


def test_sbm_bv_batch_transparency():
    """A stacked batch must evolve exactly as each instance alone — the
    ψ-weighted integrals must stay per-env."""
    g = np.load(GOLDEN)
    eq = _equation_from_golden(g)
    rng = np.random.default_rng(11)
    N = int(g["N"])
    u_batch = jnp.asarray(np.clip(
        0.1 + 0.02 * rng.standard_normal((3, N, N)), 0.01, 0.99))
    dt = float(g["dt"])
    stepper = RK4()
    out_batch = evolve(stepper, eq.rhs, u_batch, 0.0, dt, 5)
    for i in range(3):
        out_i = evolve(stepper, eq.rhs, u_batch[i], 0.0, dt, 5)
        # not bitwise: XLA accumulates the batched global reductions in a
        # different order than the single-instance ones
        np.testing.assert_allclose(np.asarray(out_batch[i]),
                                   np.asarray(out_i), rtol=0, atol=1e-12)
    v = eq.get_voltage(u_batch)
    assert v.shape == (3,)


def test_sbm_preset_rollout_finite_and_charges_particle():
    env = make_sbm_butler_volmer_control_env(num_envs=4, grid_size=32,
                                             substeps=4)
    state, obs = env.reset(jax.random.PRNGKey(0))
    assert obs.shape == (4, 1, 32, 32) and obs.dtype == jnp.uint8
    psi = env.static_equation_parameters["psi"]
    fill0 = float(jnp.sum(psi * state.y[0]) / jnp.sum(psi))
    policy = lambda o, k: jnp.zeros((4, 1))
    state, rewards, terms = env.rollout(state, policy, 8,
                                        key=jax.random.PRNGKey(1))
    assert bool(jnp.isfinite(rewards).all())
    fill1 = float(jnp.sum(psi * state.y[0]) / jnp.sum(psi))
    assert fill1 > fill0


def test_sbm_preset_galvanostatic_charge_balance():
    """The ψ-weighted closure conserves applied current per env:
    d(Σ ψ c · cell)/dt == Crate (derivation: I₋/y − I₊·y == C)."""
    env = make_sbm_butler_volmer_control_env(num_envs=2, grid_size=32,
                                             substeps=4, auto_reset=False)
    state, _ = env.reset(jax.random.PRNGKey(2))
    psi = env.static_equation_parameters["psi"]
    hx, hy = env.domain.dx
    cell = float(hx) * float(hy)
    q0 = np.asarray(jnp.sum(psi * state.y, axis=(-2, -1)) * cell)
    state, *_ = env.step(state, jnp.zeros((2, 1)))
    q1 = np.asarray(jnp.sum(psi * state.y, axis=(-2, -1)) * cell)
    # Crate = 1 at reset.
    np.testing.assert_allclose((q1 - q0) / env.step_dt, 1.0, rtol=0.05)


def test_sbm_preset_crate_control_affects_charging_rate():
    env = make_sbm_butler_volmer_control_env(num_envs=2, grid_size=32,
                                             substeps=4, auto_reset=False)
    state, _ = env.reset(jax.random.PRNGKey(3))
    y = state.y.at[1].set(state.y[0])
    state = state._replace(
        y=y, control_value=state.control_value.at[1].set(
            state.control_value[0]))
    psi = env.static_equation_parameters["psi"]
    acts = jnp.array([[1.0], [-1.0]])
    for _ in range(4):
        state, *_ = env.step(state, acts)
    fill = jnp.sum(psi * state.y, axis=(-2, -1))
    assert float(fill[0]) > float(fill[1])


@pytest.mark.slow
def test_sbm_preset_smooth_geometry_pipeline():
    """The Shape smoothing-flow path (the reference pipeline) constructs
    and produces a particle-interior ψ usable by the fleet."""
    env = make_sbm_butler_volmer_control_env(num_envs=2, grid_size=24,
                                             substeps=2,
                                             smooth_geometry=True)
    psi = env.static_equation_parameters["psi"]
    assert float(psi.max()) > 0.9 and float(psi.min()) <= 0.001 + 1e-6
    state, _ = env.reset(jax.random.PRNGKey(4))
    state, rewards, _ = env.rollout(
        state, lambda o, k: jnp.zeros((2, 1)), 3,
        key=jax.random.PRNGKey(5))
    assert bool(jnp.isfinite(rewards).all())
