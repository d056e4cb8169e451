"""Adaptive-driver parity on the PDEModel.solve(PIDController) path under
accelerator dtypes.

``tests/test_adaptive_saves.py`` pins the low-level ``integrate_adaptive``
save cursor on adversarial f32 grids; this file drives the same guarantees
through the USER path — ``PDEModel.solve(..., stepsize_controller=
PIDController)`` (the reference's diffrax usage,
``/root/reference/pde_opt/pde_model.py:77``) — under f32 and bf16 state,
mirroring the mixed-precision conditions of the accelerator fast path: save-point
exactness, dtype stability of the carried state, and agreement with the
fixed-step rollout.
"""

import jax
import jax.numpy as jnp
import numpy as np

import pde_opt_jax as p
from pde_opt_jax.ops.integrate import PIDController

N = 16
L = 0.16


def _model(dtype):
    domain = p.Domain((N, N), ((-L / 2, L / 2), (-L / 2, L / 2)),
                      "dimensionless", dtype=dtype)
    model = p.PDEModel(p.AllenCahn2DPeriodic, domain, p.Tsit5)
    params = {
        "kappa": 1e-3,
        "mu": lambda c: c**3 - c,
        "R": lambda c: jnp.ones_like(c),
        "derivs": "fd",
    }
    return model, params


def _y0(dtype, seed=0):
    return (0.1 * jax.random.normal(jax.random.PRNGKey(seed), (N, N))
            ).astype(dtype)


def test_pid_path_f32_matches_fixed_step():
    model, params = _model(jnp.float32)
    y0 = _y0(jnp.float32)
    ts = jnp.linspace(0.0, 0.02, 5)
    sol_pid = model.solve(params, y0, ts, dt0=1e-4,
                          stepsize_controller=PIDController(
                              rtol=1e-6, atol=1e-9))
    sol_fix = model.solve(params, y0, ts, dt0=1e-4)
    assert sol_pid.shape == (5, N, N)
    assert sol_pid.dtype == jnp.float32
    # Linear save interpolation is O(dt²) between accepted steps; budget
    # an absolute tolerance for near-zero elements of the O(0.1) field.
    np.testing.assert_allclose(np.asarray(sol_pid), np.asarray(sol_fix),
                               rtol=5e-3, atol=1e-3)
    # Save slot 0 is the initial state exactly.
    np.testing.assert_array_equal(np.asarray(sol_pid[0]), np.asarray(y0))


def test_pid_path_bf16_state_stays_bf16_and_finite():
    """bf16 state through the adaptive driver: the carry must stay dtype-
    stable (no silent f32 promotion between accepted steps) and every save
    slot must be written (non-zero) and close to the f32 trajectory within
    bf16 resolution."""
    model, params = _model(jnp.bfloat16)
    y0 = _y0(jnp.bfloat16)
    ts = jnp.linspace(0.0, 0.02, 5)
    sol = model.solve(params, y0, ts, dt0=1e-4,
                      stepsize_controller=PIDController(
                          rtol=1e-3, atol=1e-5))
    assert sol.dtype == jnp.bfloat16
    assert bool(jnp.isfinite(sol.astype(jnp.float32)).all())

    model32, params32 = _model(jnp.float32)
    ref = model32.solve(params32, _y0(jnp.float32), ts, dt0=1e-4,
                        stepsize_controller=PIDController(
                            rtol=1e-6, atol=1e-9))
    # bf16 has ~2-3 significant digits; the trajectories stay O(0.1).
    np.testing.assert_allclose(np.asarray(sol, np.float32),
                               np.asarray(ref), rtol=0, atol=0.03)
    # Interior save slots are genuinely written (an unwritten slot is 0).
    for i in range(1, 5):
        assert float(jnp.abs(sol[i].astype(jnp.float32)).max()) > 1e-3


def test_pid_path_adversarial_irregular_save_grid():
    """Irregular, tightly-spaced f32 save points through the model path:
    every slot captured (the r2 save-cursor bug class, now via solve())."""
    model, params = _model(jnp.float32)
    y0 = _y0(jnp.float32, seed=1)
    ts = jnp.asarray([0.0, 1e-4, 1.3e-3, 1.31e-3, 0.01, 0.0123],
                     jnp.float32)
    sol = model.solve(params, y0, ts, dt0=5e-5,
                      stepsize_controller=PIDController(
                          rtol=1e-6, atol=1e-9))
    assert sol.shape == (6, N, N)
    ref = model.solve(params, y0, jnp.linspace(0.0, 0.0123, 2), dt0=5e-5)
    # Early saves stay near y0; the final save matches an independent run.
    np.testing.assert_allclose(np.asarray(sol[1]), np.asarray(y0),
                               rtol=0, atol=5e-3)
    np.testing.assert_allclose(np.asarray(sol[-1]), np.asarray(ref[-1]),
                               rtol=2e-3, atol=2e-4)
