"""Gradients through the cas macro kernel (interpret mode on CPU).

The kernel registers a custom VJP whose backward pass is the checkpointed
recompute through its exact XLA oracle.  These tests pin the criterion:
``jax.grad`` through the fused path matches the per-substep reference
semantics (`ch_sif_macro_reference` — the independent jnp.fft
implementation of the reference update,
``/root/reference/pde_opt/numerics/solvers.py:56-70``), plus
finite-difference sanity checks.
"""

import jax
import jax.numpy as jnp
import numpy as np

from pde_opt_jax.ops.cas_spectral import make_ch_cas_fused_macro
from pde_opt_jax.ops.spectral_reference import ch_sif_macro_reference


def mu(c):
    return c**3 - c


def _setup(B=8, H=16, W=16, seed=0):
    u = 0.5 + 0.05 * jax.random.normal(jax.random.PRNGKey(seed), (B, H, W))
    u = u.astype(jnp.float32)
    kappa = jnp.linspace(0.002, 0.01, B).astype(jnp.float32)
    return u, kappa


def test_cas_macro_grad_matches_reference():
    """du and dkappa of the cas macro == grads of the FFT oracle."""
    B, H, W = 8, 16, 16
    hx, hy, A, dt, n = 0.01, 0.02, 1.0, 1e-3, 3
    u, kappa = _setup(B, H, W)
    fused = make_ch_cas_fused_macro(
        mu, H, W, hx, hy, A, dt, n, mats_dtype=jnp.float32
    )
    ref = ch_sif_macro_reference(mu, hx, hy, A, dt, n)

    w = jax.random.normal(jax.random.PRNGKey(1), (B, H, W)).astype(jnp.float32)

    def loss(f):
        return lambda uu, kk: jnp.sum(w * f(uu, kk))

    gu_f, gk_f = jax.grad(loss(fused), argnums=(0, 1))(u, kappa)
    gu_r, gk_r = jax.grad(loss(ref), argnums=(0, 1))(u, kappa)
    np.testing.assert_allclose(np.asarray(gu_f), np.asarray(gu_r),
                               rtol=0, atol=2e-6)
    np.testing.assert_allclose(np.asarray(gk_f), np.asarray(gk_r),
                               rtol=2e-4, atol=1e-6)


def test_cas_macro_grad_kappa_finite_difference():
    """Finite differences confirm the kappa cotangent end-to-end.

    Chain: (a) x64 central differences validate the FFT oracle's AD (the
    macro update is strongly nonlinear in kappa — 1/(1+A·dt·κ·λ²) with
    A·dt·κ·λ² ≫ 1 — so this needs small eps and f64); (b) the parity test
    above pins the kernel's VJP to that same oracle AD.
    """
    B, H, W = 4, 16, 16
    hx, hy, A, dt, n = 0.01, 0.01, 1.0, 1e-3, 2
    u64 = (0.5 + 0.05 * jax.random.normal(jax.random.PRNGKey(2), (B, H, W))
           ).astype(jnp.float64)
    kappa = jnp.linspace(0.002, 0.01, B).astype(jnp.float64)
    ref = ch_sif_macro_reference(mu, hx, hy, A, dt, n)

    def loss(kk):
        return jnp.sum(ref(u64, kk) ** 2)  # NOT mass — CH conserves mass

    g = jax.grad(loss)(kappa)
    eps = 1e-6
    for i in range(B):
        e = jnp.zeros_like(kappa).at[i].set(eps)
        fd = (loss(kappa + e) - loss(kappa - e)) / (2 * eps)
        np.testing.assert_allclose(float(g[i]), float(fd), rtol=1e-3,
                                   atol=1e-9)


def test_cas_macro_grad_scalar_and_batched_kappa_shapes():
    """Cotangents come back in the caller's kappa shape (scalar / (B,))."""
    B, H, W = 4, 16, 16
    u, _ = _setup(B, H, W, seed=3)
    fused = make_ch_cas_fused_macro(
        mu, H, W, 0.01, 0.01, 1.0, 1e-3, 2,
        mats_dtype=jnp.float32,
    )
    g_scalar = jax.grad(lambda kk: jnp.sum(fused(u, kk) ** 2))(0.005)
    assert jnp.shape(g_scalar) == ()
    g_vec = jax.grad(lambda kk: jnp.sum(fused(u, kk) ** 2))(
        jnp.full((B,), 0.005)
    )
    assert g_vec.shape == (B,)
    # scalar cotangent is the sum of the per-env ones
    np.testing.assert_allclose(float(g_scalar), float(jnp.sum(g_vec)),
                               rtol=1e-4, atol=1e-7)


def test_grad_through_fused_stepper_evolve():
    """jax.grad through FusedSemiImplicitSpectral.evolve (cas path) matches
    the per-substep reference semantics."""
    from pde_opt_jax.grid import Domain
    from pde_opt_jax.ops.integrate import evolve
    from pde_opt_jax.ops.steppers import FusedSemiImplicitSpectral

    B, N = 4, 16
    domain = Domain((N, N), ((0.0, 0.16), (0.0, 0.16)), "dimensionless")
    u0, kappa = _setup(B, N, N, seed=6)
    dt, n_sub = 1e-3, 3
    hx, hy = (float(d) for d in domain.dx)

    def loss_fused(kap):
        stepper = FusedSemiImplicitSpectral(
            kappa=kap, mu=mu, D=lambda c: jnp.ones_like(c), domain=domain,
            A=1.0, mats_dtype=jnp.float32,
        )
        y1 = evolve(stepper, None, u0, 0.0, dt, n_sub)
        return jnp.sum(y1**2)

    ref = ch_sif_macro_reference(mu, hx, hy, 1.0, dt, n_sub)

    def loss_ref(kap):
        return jnp.sum(ref(u0, kap) ** 2)

    g_fused = jax.grad(loss_fused)(kappa)
    g_ref = jax.grad(loss_ref)(kappa)
    np.testing.assert_allclose(np.asarray(g_fused), np.asarray(g_ref),
                               rtol=2e-3, atol=1e-6)


def test_model_optimize_on_fused_path():
    """PDEModel.optimize runs end-to-end on the fused stepper (training on
    the fused path — reference capability ``pde_model.py:462-551``)."""
    from pde_opt_jax.grid import Domain
    from pde_opt_jax.models.cahn_hilliard import CahnHilliard2DPeriodic
    from pde_opt_jax.models.pde_model import PDEModel
    from pde_opt_jax.ops.steppers import FusedSemiImplicitSpectral

    N = 16
    domain = Domain((N, N), ((0.0, 0.16), (0.0, 0.16)), "dimensionless")
    model = PDEModel(CahnHilliard2DPeriodic, domain, FusedSemiImplicitSpectral)
    y0 = 0.5 + 0.05 * jax.random.normal(jax.random.PRNGKey(7), (N, N))
    y0 = y0.astype(jnp.float32)
    ts = np.linspace(0.0, 3e-3, 4)

    # Drive the field toward uniformity by tuning kappa.
    result = model.optimize(
        objective_function=lambda sol: jnp.var(sol[-1]),
        y0=y0,
        ts=ts,
        opt_parameters={"kappa": jnp.asarray(0.004, jnp.float32)},
        other_parameters={
            "mu": mu,
            "D": lambda c: jnp.ones_like(c),
        },
        solver_parameters={"A": 1.0, "mats_dtype": jnp.float32},
        weights={"kappa": None},
        lambda_reg=0.0,
        max_steps=3,
        dt0=1e-3,
        method="adam",
        learning_rate=1e-4,
    )
    assert np.isfinite(float(result["kappa"]))
    # the optimizer must have moved kappa (a real gradient flowed)
    assert abs(float(result["kappa"]) - 0.004) > 1e-9
