"""Dense-matmul spectral solve stepper: exactness (f32) and stability (bf16_sqrt)."""

import jax
import jax.numpy as jnp
import numpy as np

import pde_opt_jax as p
from pde_opt_jax.ops.dft import make_dense_spectral_solve
from pde_opt_jax.ops.steppers import SemiImplicitDenseSolve, SemiImplicitFourierSpectral

N = 32
L = 0.01 * N


def _setup():
    domain = p.Domain((N, N), ((-L / 2, L / 2), (-L / 2, L / 2)))
    eq = p.CahnHilliard2DPeriodic(
        domain, 0.004, lambda c: c**3 - c, lambda c: jnp.ones_like(c)
    )
    kx, ky = domain.fft_mesh()
    symbol = 0.01 * ((2 * np.pi * kx) ** 2 + (2 * np.pi * ky) ** 2) ** 2
    u0 = jnp.clip(
        0.5 + 0.01 * jax.random.normal(jax.random.PRNGKey(0), (4, N, N)), 0, 1
    ).astype(jnp.float32)
    return domain, eq, symbol, u0


def test_dense_f32_matches_fft_fixed_symbol():
    domain, eq, symbol, u0 = _setup()
    dense = SemiImplicitDenseSolve(0.5, symbol, domain.points, dtype="f32")
    krx, kry = domain.rfft_mesh()
    symbol_r = 0.01 * ((2 * np.pi * krx) ** 2 + (2 * np.pi * kry) ** 2) ** 2
    fft = SemiImplicitFourierSpectral(0.5, symbol_r, eq.fft, eq.ifft)
    y_d, y_f = u0, u0
    for i in range(5):
        y_d, _ = dense.step(eq.rhs, y_d, 0.0, 1e-3)
        y_f, _ = fft.step(eq.rhs, y_f, 0.0, 1e-3)
    np.testing.assert_allclose(np.asarray(y_d), np.asarray(y_f),
                               rtol=1e-4, atol=1e-6)


def test_dense_solve_matrix_matches_fft_solve():
    domain, eq, symbol, u0 = _setup()
    denom = 1.0 / (1.0 + 0.5 * 1e-3 * symbol)
    solve = make_dense_spectral_solve(domain.points, denom, dtype="f32")
    x = jax.random.normal(jax.random.PRNGKey(1), (N, N))
    ref = jnp.real(jnp.fft.ifftn(jnp.fft.fftn(x) * denom))
    np.testing.assert_allclose(np.asarray(solve(x)), np.asarray(ref),
                               rtol=1e-5, atol=1e-6)


def test_bf16_sqrt_long_rollout_stable():
    """The sqrt-factored bf16 solve must stay bounded in the stiff loop.

    (The flat bf16 variant diverges here — its rounding noise re-amplifies
    through κ∆² each substep; the second √P matmul damps the injected
    high-k noise. Regression for the measured instability.)
    """
    domain, eq, symbol, u0 = _setup()
    dense = SemiImplicitDenseSolve(0.5, symbol, domain.points, dtype="bf16_sqrt")

    def sub(y, _):
        y1, _err = dense.step(eq.rhs, y, 0.0, 1e-3)
        return y1.astype(y.dtype), None

    y = jax.lax.scan(sub, u0, None, length=300)[0]
    assert bool(jnp.isfinite(y).all())
    assert float(jnp.max(jnp.abs(y))) < 2.0


def test_dense_requires_concrete_dt():
    domain, eq, symbol, u0 = _setup()
    dense = SemiImplicitDenseSolve(0.5, symbol, domain.points)
    import pytest

    with pytest.raises(TypeError):
        jax.jit(lambda dt: dense.step(eq.rhs, u0, 0.0, dt)[0])(1e-3)
