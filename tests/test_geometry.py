"""Smoothed-boundary geometry (Shape) and SBM equation oracles."""

import jax
import jax.numpy as jnp
import numpy as np

import pde_opt_jax as p
from pde_opt_jax.geometry import Shape

N = 32
L = 1.0


def _disk_mask(radius_frac=1 / 3):
    yy, xx = np.mgrid[0:N, 0:N]
    mask = ((yy - N / 2) ** 2 + (xx - N / 2) ** 2 < (radius_frac * N) ** 2)
    return jnp.asarray(mask.astype(np.float64))


def _disk_shape():
    return Shape(_disk_mask(), dx=(L / N, L / N), smooth_epsilon=2 * L / N,
                 smooth_dt=0.001, smooth_tf=0.02)


def test_shape_smoothing_bounds_and_interior():
    shape = _disk_shape()
    psi = np.asarray(shape.smooth)
    assert psi.min() >= 0.001 and psi.max() <= 1.0
    # Interior stays solid, exterior stays (clamped) empty.
    assert psi[N // 2, N // 2] > 0.9
    assert psi[1, 1] < 0.05
    # The smooth field has an interface: intermediate values exist.
    assert ((psi > 0.2) & (psi < 0.8)).sum() > 0


def test_shape_modes_graph_laplacian():
    shape = _disk_shape()
    basis, evals = shape.get_shape_modes(4)
    assert basis.shape == (N, N, 4)
    # First graph-Laplacian eigenvalue of a connected mask is ~0 with a
    # constant eigenvector on the mask.
    assert abs(evals[0]) < 1e-8
    mask = np.asarray(_disk_mask()) > 0
    v0 = np.asarray(basis[..., 0])[mask]
    np.testing.assert_allclose(v0, v0[0], atol=1e-6)
    # Eigenvectors vanish outside the mask.
    assert np.all(np.asarray(basis)[~mask] == 0)


def test_sbm_cahn_hilliard_conserves_weighted_mass():
    """CH-SBM with zero normal flux conserves ∫ψu: ∫ψ·rhs = 0.

    (Multiply the SBM equation ψ∂u/∂t = ∇·(ψD∇μ) + |∇ψ|J_n by dA and use
    periodicity of the outer box; with J_n = 0 the flux form telescopes.)
    """
    shape = _disk_shape()
    domain = p.Domain((N, N), ((-L / 2, L / 2), (-L / 2, L / 2)),
                      geometry=shape, dtype=jnp.float64)
    eq = p.CahnHilliard2DSmoothedBoundary(
        domain, kappa=1e-3,
        f=lambda c: 0.25 * (c**2) * (1 - c) ** 2 + 1e-8,
        mu=lambda c: c**3 - c,
        D=lambda c: jnp.ones_like(c),
        theta=lambda t: jnp.pi / 2,  # 90° contact angle
        flux=lambda t: 0.0,
    )
    u = jnp.clip(0.5 + 0.05 * jax.random.normal(jax.random.PRNGKey(0), (N, N)),
                 0.05, 0.95)
    weighted_rate = float(jnp.sum(eq.rhs(u, 0.0) * eq.psi)) * domain.dx[0] ** 2
    np.testing.assert_allclose(weighted_rate, 0.0, atol=1e-10)


def test_sbm_allen_cahn_finite_and_batched():
    shape = _disk_shape()
    domain = p.Domain((N, N), ((-L / 2, L / 2), (-L / 2, L / 2)),
                      geometry=shape, dtype=jnp.float64)
    eq = p.AllenCahn2DSmoothedBoundary(
        domain, kappa=1e-3,
        f=lambda c: 0.25 * (c**2) * (1 - c) ** 2 + 1e-8,
        mu=lambda c: c**3 - c,
        R=lambda c: jnp.ones_like(c),
        theta=lambda t: jnp.pi / 3,
    )
    u = jnp.clip(0.5 + 0.05 * jax.random.normal(jax.random.PRNGKey(1), (3, N, N)),
                 0.05, 0.95)
    r = eq.rhs(u, 0.0)
    assert r.shape == (3, N, N)
    assert bool(jnp.isfinite(r).all())
    np.testing.assert_allclose(np.asarray(r[1]), np.asarray(eq.rhs(u[1], 0.0)),
                               rtol=1e-12)


def test_smoothed_advection_diffusion_conserves_weighted_mass():
    shape = _disk_shape()
    domain = p.Domain((N, N), ((-L / 2, L / 2), (-L / 2, L / 2)),
                      geometry=shape, dtype=jnp.float64)
    eq = p.AdvectionDiffusion2D(
        domain, velocity=lambda t, X, Y: (0.3 * jnp.ones_like(X), -0.2 * jnp.ones_like(Y)),
        diffusion_coeff=0.05, smooth=True,
    )
    u = jnp.clip(0.5 + 0.05 * jax.random.normal(jax.random.PRNGKey(2), (N, N)), 0, 1)
    weighted_rate = float(jnp.sum(eq.rhs(u, 0.0) * eq.psi)) * domain.dx[0] ** 2
    np.testing.assert_allclose(weighted_rate, 0.0, atol=1e-10)
