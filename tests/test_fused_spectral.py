"""Cas macro-step kernel vs its FFT reference (interpret mode on CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pde_opt_jax.ops.cas_spectral import make_ch_cas_fused_macro
from pde_opt_jax.ops.spectral_reference import ch_sif_macro_reference


def mu(c):
    return c**3 - c


def test_fused_macro_matches_fft_reference():
    B, H, W = 8, 16, 16
    hx, hy = 0.01, 0.02
    A, dt, n = 1.0, 1e-3, 3
    key = jax.random.PRNGKey(0)
    u = 0.5 + 0.05 * jax.random.normal(key, (B, H, W), jnp.float32)
    kappa = jnp.linspace(0.002, 0.01, B)

    fused = make_ch_cas_fused_macro(
        mu, H, W, hx, hy, A, dt, n, mats_dtype=jnp.float32
    )
    ref = ch_sif_macro_reference(mu, hx, hy, A, dt, n)
    out = fused(u, kappa)
    expect = ref(u, kappa)
    np.testing.assert_allclose(np.asarray(out), np.asarray(expect),
                               rtol=0, atol=5e-5)
    # the step must actually move the field
    assert float(jnp.max(jnp.abs(out - u))) > 1e-6


def test_fused_macro_per_env_kappa_differs():
    B, H, W = 4, 16, 16
    u = 0.5 + 0.05 * jax.random.normal(jax.random.PRNGKey(1), (B, H, W))
    u = u.astype(jnp.float32)
    fused = make_ch_cas_fused_macro(
        mu, H, W, 0.01, 0.01, 1.0, 1e-3, 2, mats_dtype=jnp.float32,
    )
    out_lo = fused(u, jnp.full((B,), 0.002))
    out_hi = fused(u, jnp.full((B,), 0.01))
    assert float(jnp.max(jnp.abs(out_lo - out_hi))) > 1e-7


def test_fused_macro_scalar_kappa_and_leading_batch_shapes():
    H, W = 16, 16
    u = 0.5 + 0.05 * jax.random.normal(jax.random.PRNGKey(2), (2, 3, H, W))
    u = u.astype(jnp.float32)
    fused = make_ch_cas_fused_macro(
        mu, H, W, 0.01, 0.01, 1.0, 1e-3, 2, mats_dtype=jnp.float32,
    )
    out = fused(u, 0.005)
    assert out.shape == u.shape
    ref = ch_sif_macro_reference(mu, 0.01, 0.01, 1.0, 1e-3, 2)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref(u, 0.005)),
                               rtol=0, atol=5e-5)


def test_fused_stepper_through_env():
    from pde_opt_jax.envs.presets import make_cahn_hilliard_control_env

    env = make_cahn_hilliard_control_env(
        num_envs=4, grid_size=16, substeps=2, spectral_solve="fused",
        vectorized_control=True,
    )
    # the kernel runs in interpret mode on CPU (ops/kernel_backend.py)
    state, obs = env.reset(jax.random.PRNGKey(0))
    actions = jnp.zeros((4, 1), jnp.float32)
    state2, obs2, reward, term, trunc, info = env._step_impl(state, actions)
    assert bool(jnp.isfinite(state2.y).all())
    assert reward.shape == (4,)
    assert float(jnp.max(jnp.abs(state2.y - state.y))) > 0.0


def test_fused_stepper_rejects_nonunit_mobility():
    from pde_opt_jax.grid import Domain
    from pde_opt_jax.ops.steppers import FusedSemiImplicitSpectral

    domain = Domain((16, 16), ((0.0, 0.16), (0.0, 0.16)), "dimensionless")
    with pytest.raises(ValueError, match="unit mobility"):
        FusedSemiImplicitSpectral(
            kappa=0.01, mu=mu, D=lambda c: c * (1 - c), domain=domain
        )
