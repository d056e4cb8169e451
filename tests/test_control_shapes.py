"""Shape contract of per-env scalar controls across all fused steppers.

A stepper that squeezed the *last two* axes of any ndim>=2 control would
crash or mis-broadcast a ``(B, 1)`` control (the natural product of
``update_control_value`` on ``(B,)`` actions) for B > 1.  The contract is
explicit (``ops/steppers.py:_normalize_per_env_control``): scalar,
``batch_shape``, or ``batch_shape`` + trailing singleton axes are all
accepted and equivalent; anything else raises.  This sweeps every fused
stepper over every accepted shape (the cas kernel in interpret mode on
CPU).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pde_opt_jax import grid as gridmod
from pde_opt_jax.ops.steppers import (
    FusedMobilitySpectral,
    FusedSemiImplicitSpectral,
    FusedSemiImplicitSpectral3D,
)

B, H, W = 3, 16, 16


def _domain2d(dtype=jnp.float32):
    return gridmod.Domain((H, W), ((-0.08, 0.08), (-0.08, 0.08)),
                          "dimensionless", dtype=dtype)


def _mu(c):
    return c**3 - c


def _ones(c):
    return jnp.ones_like(c)


def _make_ch(ctrl):
    return FusedSemiImplicitSpectral(
        kappa=ctrl, mu=_mu, D=_ones, domain=_domain2d(), A=1.0,
        mats_dtype=jnp.float32,
    )


def _make_ch_bf16(ctrl):
    # The kernel's default operands: 3-pass bf16 products.
    return FusedSemiImplicitSpectral(
        kappa=ctrl, mu=_mu, D=_ones, domain=_domain2d(), A=1.0,
    )


def _make_mobility(ctrl):
    return FusedMobilitySpectral(
        kappa=ctrl, mu=_mu, D=lambda c: 1.0 + 0.5 * c**2,
        domain=_domain2d(), A=1.0, mats_dtype=jnp.float32,
    )


def _state2d(key, lo=0.4, hi=0.6):
    u = jax.random.uniform(key, (B, H, W), jnp.float32)
    return lo + (hi - lo) * u


CASES = [
    ("ch", _make_ch, 0.004, 1e-4),
    ("ch_bf16", _make_ch_bf16, 0.004, 1e-4),
    ("mobility", _make_mobility, 0.004, 1e-6),
]


@pytest.mark.parametrize("name,make,base_val,dt", CASES,
                         ids=[c[0] for c in CASES])
@pytest.mark.parametrize("shape", [(), (B,), (B, 1), (B, 1, 1)],
                         ids=["scalar", "B", "B1", "B11"])
def test_fused_stepper_accepts_all_control_shapes(name, make, base_val, dt,
                                                  shape):
    y0 = _state2d(jax.random.PRNGKey(0))
    baseline = make(jnp.full((B,), base_val, jnp.float32)).evolve(
        None, y0, 0.0, dt, 2)
    ctrl = jnp.full(shape, base_val, jnp.float32)
    out = make(ctrl).evolve(None, y0, 0.0, dt, 2)
    assert out.shape == y0.shape
    np.testing.assert_array_equal(np.asarray(out), np.asarray(baseline))


@pytest.mark.parametrize("name,make,base_val,dt", CASES,
                         ids=[c[0] for c in CASES])
def test_fused_stepper_per_env_control_stays_per_env(name, make, base_val,
                                                     dt):
    """A (B, 1) control with DISTINCT per-env values must act per env —
    the old squeeze heuristic would have collapsed or crashed here."""
    y0 = _state2d(jax.random.PRNGKey(1))
    vals = jnp.asarray([0.5 * base_val, base_val, 1.5 * base_val],
                       jnp.float32)
    out_b = make(vals).evolve(None, y0, 0.0, dt, 2)
    out_b1 = make(vals[:, None]).evolve(None, y0, 0.0, dt, 2)
    out_b11 = make(vals[:, None, None]).evolve(None, y0, 0.0, dt, 2)
    np.testing.assert_array_equal(np.asarray(out_b1), np.asarray(out_b))
    np.testing.assert_array_equal(np.asarray(out_b11), np.asarray(out_b))
    # distinct controls produce distinct per-env dynamics
    d01 = float(jnp.max(jnp.abs(out_b[0] - out_b[1])))
    assert d01 > 0.0


@pytest.mark.parametrize("name,make,base_val,dt", CASES,
                         ids=[c[0] for c in CASES])
def test_fused_stepper_rejects_nonsingleton_trailing_axis(name, make,
                                                          base_val, dt):
    y0 = _state2d(jax.random.PRNGKey(2))
    bad = jnp.full((B, 2), base_val, jnp.float32)
    with pytest.raises((ValueError, TypeError)):
        make(bad).evolve(None, y0, 0.0, dt, 2)


def test_fused_3d_control_shapes():
    N = 8
    domain = gridmod.Domain((N, N, N), ((-0.04, 0.04),) * 3,
                            "dimensionless", dtype=jnp.float32)
    y0 = 0.5 + 0.05 * jax.random.normal(jax.random.PRNGKey(3), (B, N, N, N),
                                        dtype=jnp.float32)

    def make(ctrl):
        return FusedSemiImplicitSpectral3D(
            kappa=ctrl, mu=_mu, D=_ones, domain=domain, A=1.0,
            mats_dtype=jnp.float32,
        )

    baseline = make(jnp.full((B,), 0.004, jnp.float32)).evolve(
        None, y0, 0.0, 1e-4, 2)
    for shape in [(), (B,), (B, 1), (B, 1, 1), (B, 1, 1, 1)]:
        ctrl = jnp.full(shape, 0.004, jnp.float32)
        out = make(ctrl).evolve(None, y0, 0.0, 1e-4, 2)
        assert out.shape == y0.shape
        np.testing.assert_array_equal(np.asarray(out), np.asarray(baseline))


# ---------------------------------------------------------------------------
# Env-layer contract: mis-shaped update_control_value
# outputs must fail loudly on EVERY stepper path, including the generic XLA
# steppers that do their own broadcasting.
# ---------------------------------------------------------------------------


def _bad_env(update_value, spectral_solve="fft", update_param=None):
    from pde_opt_jax.envs.presets import make_cahn_hilliard_control_env

    env = make_cahn_hilliard_control_env(
        num_envs=4, grid_size=16, substeps=2, spectral_solve=spectral_solve,
        derivs="fd",
    )
    if update_value is not None:
        env.update_control_value = update_value
    if update_param is not None:
        env.update_control_parameter = update_param
    # Re-jit with the mutated hooks (the constructor jitted the originals).
    env._step = jax.jit(env._step_impl, donate_argnums=(0,))
    return env


@pytest.mark.parametrize("bad_shape", [(1, 4), (2,), (3, 1), (4, 4)])
def test_env_rejects_misbroadcast_control_value_on_xla_path(bad_shape):
    # The control is a scan carry: its shape must be stable step to step
    # (the reset path batches it to (B, ...)).  That catches the classic
    # (B,) + (B, 1) -> (B, B) mis-broadcast — whose leading dim still
    # equals B — while multi-component controls simply keep the shape
    # their reset gave them (next test).
    env = _bad_env(lambda off, old: jnp.zeros(bad_shape) + 0.004)
    state, _ = env.reset(jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match="must keep its per-env shape"):
        env.step(state, jnp.zeros((4, 1)))


def test_env_accepts_multicomponent_control_value():
    # A (B, 2) control (e.g. a stirrer position from a 2-dim action space)
    # must pass the contract check — the reference's generic env wrapper
    # permits it (/root/reference/pde_opt/pde_env.py:43-138).
    env = _bad_env(
        lambda off, old: jnp.zeros((4, 2)) + 0.004,
        update_param=lambda old, new: new.mean(axis=-1)[..., None, None],
    )
    env.reset_control_value = jnp.full((2,), 0.004)
    env._reset = jax.jit(env._reset_impl)
    state, _ = env.reset(jax.random.PRNGKey(0))
    state, obs, r, term, trunc, info = env.step(state, jnp.zeros((4, 1)))
    assert bool(jnp.isfinite(r).all())


def test_env_rejects_state_growing_control_param():
    # (B,) value passes the value check, but a (1, B, 1, 1) equation
    # parameter would grow the fleet through broadcasting.  The per-substep
    # scan carry check catches it inside ``evolve`` (TypeError); the env's
    # state-shape guard backstops whole-segment steppers that bypass the
    # scan (ValueError).  Either way: loud, at trace time.
    env = _bad_env(None,
                   update_param=lambda old, new: new[None, :, None, None])
    state, _ = env.reset(jax.random.PRNGKey(0))
    with pytest.raises((ValueError, TypeError),
                       match="changed the state shape|carry"):
        env.step(state, jnp.zeros((4, 1)))


def test_env_accepts_contract_shapes_on_both_paths():
    for solve in ("fft", "fused"):
        env = _bad_env(None, spectral_solve=solve)
        state, _ = env.reset(jax.random.PRNGKey(0))
        state, obs, r, term, trunc, info = env.step(state, jnp.zeros((4, 1)))
        assert bool(jnp.isfinite(r).all())
