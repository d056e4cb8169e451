"""General-mobility fused CH macros vs their FFT oracles (2D + 3D)."""

import jax
import jax.numpy as jnp
import numpy as np

from pde_opt_jax.ops.cas_mobility import (
    ch3d_mobility_macro_reference,
    ch_mobility_macro_reference,
    make_ch3d_mobility_cas_macro,
    make_ch_mobility_cas_macro,
)

MU = lambda c: c**3 - c
D = lambda c: 1.0 + 0.5 * c**2  # smooth non-unit mobility


def _u2d(B=4, N=16, seed=0):
    rng = np.random.default_rng(seed)
    return jnp.asarray(0.5 + 0.05 * rng.standard_normal((B, N, N)),
                       jnp.float32)


def test_2d_matches_fft_oracle_per_env_kappa():
    u = _u2d()
    N = u.shape[-1]
    h = 1.0 / N
    kap = jnp.linspace(2e-3, 8e-3, u.shape[0])
    macro = make_ch_mobility_cas_macro(MU, D, N, N, h, h, 1.0, 1e-5, 5,
                                       mats_dtype=jnp.float32)
    ref = ch_mobility_macro_reference(MU, D, h, h, 1.0, 1e-5, 5)
    np.testing.assert_allclose(np.asarray(macro(u, kap)),
                               np.asarray(ref(u, kap)),
                               rtol=0, atol=1e-6)


def test_2d_unit_mobility_matches_sif_scheme():
    """With D ≡ 1 the roll-rhs + cas-solve update is algebraically the
    unit-mobility SIF scheme (C[lap_roll z] = λ·C[z] exactly)."""
    from pde_opt_jax.ops.spectral_reference import ch_sif_macro_reference

    u = _u2d(B=3, seed=1)
    N = u.shape[-1]
    h = 1.0 / N
    kap = jnp.full((3,), 4e-3)
    macro = make_ch_mobility_cas_macro(MU, lambda c: jnp.ones_like(c),
                                       N, N, h, h, 0.5, 1e-5, 4,
                                       mats_dtype=jnp.float32)
    sif = ch_sif_macro_reference(MU, h, h, 0.5, 1e-5, 4)
    np.testing.assert_allclose(np.asarray(macro(u, kap)),
                               np.asarray(sif(u, kap)),
                               rtol=0, atol=1e-6)


def test_2d_conserves_mass():
    """The conservative face-flux form telescopes: per-env mean is exact."""
    u = _u2d(B=2, N=24, seed=2)
    h = 1.0 / 24
    macro = make_ch_mobility_cas_macro(MU, D, 24, 24, h, h, 1.0, 1e-5, 20,
                                       mats_dtype=jnp.float32)
    u1 = macro(u, 4e-3)
    np.testing.assert_allclose(np.asarray(u1.mean(axis=(-2, -1))),
                               np.asarray(u.mean(axis=(-2, -1))),
                               rtol=0, atol=1e-6)


def test_2d_grads_match_oracle_native_diff():
    u = _u2d(B=2, seed=3)
    N = u.shape[-1]
    h = 1.0 / N
    kap = jnp.asarray([3e-3, 5e-3])
    macro = make_ch_mobility_cas_macro(MU, D, N, N, h, h, 1.0, 1e-5, 3,
                                       mats_dtype=jnp.float32)
    ref = ch_mobility_macro_reference(MU, D, h, h, 1.0, 1e-5, 3)
    gu_m, gk_m = jax.grad(lambda a, k: jnp.sum(macro(a, k) ** 2),
                          argnums=(0, 1))(u, kap)
    gu_r, gk_r = jax.grad(lambda a, k: jnp.sum(ref(a, k) ** 2),
                          argnums=(0, 1))(u, kap)
    np.testing.assert_allclose(np.asarray(gu_m), np.asarray(gu_r),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(np.asarray(gk_m), np.asarray(gk_r),
                               rtol=1e-4, atol=1e-8)


def test_2d_grads_flow_to_learnable_mobility_params():
    """Parameters closed over by D_fn get native gradients (the training
    hook the reference's 3D workload exercises via Legendre D)."""
    u = _u2d(B=2, seed=4)
    N = u.shape[-1]
    h = 1.0 / N

    def loss(theta):
        Dp = lambda c: 1.0 + theta[0] * c + theta[1] * c**2
        macro = make_ch_mobility_cas_macro(MU, Dp, N, N, h, h, 1.0, 1e-5, 3,
                                           mats_dtype=jnp.float32)
        return jnp.sum(macro(u, 4e-3) ** 2)

    g = jax.grad(loss)(jnp.asarray([0.3, 0.2]))
    assert g.shape == (2,) and bool(jnp.all(jnp.isfinite(g)))
    assert float(jnp.abs(g).min()) > 0.0


def test_3d_matches_fft_oracle():
    rng = np.random.default_rng(5)
    B, N = 2, 8
    u = jnp.asarray(0.5 + 0.05 * rng.standard_normal((B, N, N, N)),
                    jnp.float32)
    h = 1.0 / N
    kap = jnp.asarray([2e-3, 6e-3])
    macro = make_ch3d_mobility_cas_macro(MU, D, N, N, N, h, h, h,
                                         1.0, 1e-6, 4,
                                         mats_dtype=jnp.float32)
    ref = ch3d_mobility_macro_reference(MU, D, h, h, h, 1.0, 1e-6, 4)
    np.testing.assert_allclose(np.asarray(macro(u, kap)),
                               np.asarray(ref(u, kap)),
                               rtol=0, atol=1e-6)


def test_3d_stab_scale_stabilizes_large_mobility():
    """D ~ 25: the bare scheme's step bound shrinks ~25x; stab_scale=Dmax
    restores a stable update at the same dt."""
    rng = np.random.default_rng(6)
    B, N = 2, 16
    u = jnp.asarray(0.5 + 0.05 * rng.standard_normal((B, N, N, N)),
                    jnp.float32)
    h = 1.0 / N
    bigD = lambda c: 25.0 * jnp.ones_like(c)
    dt = 2e-7
    stab = make_ch3d_mobility_cas_macro(MU, bigD, N, N, N, h, h, h,
                                        1.0, dt, 200, stab_scale=25.0,
                                        mats_dtype=jnp.float32)
    out = stab(u, 4e-3)
    assert bool(jnp.isfinite(out).all())
    assert float(jnp.abs(out).max()) < 10.0


def test_stepper_dispatches_rank_and_matches_macro():
    from pde_opt_jax.grid import Domain
    from pde_opt_jax.models.cahn_hilliard import CahnHilliard2DPeriodic
    from pde_opt_jax.ops.integrate import evolve
    from pde_opt_jax.ops.steppers import FusedMobilitySpectral
    from pde_opt_jax.utils.compat import prepare_solver_params

    u = _u2d(B=3, seed=7)
    N = u.shape[-1]
    L = 1.0
    domain = Domain((N, N), ((-L / 2, L / 2), (-L / 2, L / 2)),
                    "dimensionless", dtype=jnp.float32)
    kap = jnp.linspace(2e-3, 6e-3, 3)
    eq = CahnHilliard2DPeriodic(domain, kap[:, None, None], MU, D,
                                derivs="fd")
    solver = FusedMobilitySpectral(
        **prepare_solver_params(FusedMobilitySpectral, {"A": 1.0}, eq),
        mats_dtype=jnp.float32,
    )
    h = L / N
    out = evolve(solver, eq.rhs, u, 0.0, 1e-5, 4)
    ref = ch_mobility_macro_reference(MU, D, h, h, 1.0, 1e-5, 4)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref(u, kap)),
                               rtol=0, atol=1e-6)


def test_2d_flux_rhs_matches_model_rhs():
    """The macro's conservative flux rhs == CahnHilliard2DPeriodic.rhs_fd
    with a per-env kappa."""
    from pde_opt_jax.grid import Domain
    from pde_opt_jax.models.cahn_hilliard import CahnHilliard2DPeriodic
    from pde_opt_jax.ops.cas_mobility import _flux_div_rhs

    u = _u2d(B=3, N=16, seed=8)
    L = 0.16
    h = L / 16
    kap = jnp.linspace(2e-3, 6e-3, 3).reshape(3, 1, 1)
    domain = Domain((16, 16), ((-L / 2, L / 2),) * 2, "dimensionless",
                    dtype=jnp.float32)
    eq = CahnHilliard2DPeriodic(domain, kap, MU, D, derivs="fd")
    rhs = _flux_div_rhs(MU, D, kap, (h, h), (-2, -1))
    ref = np.asarray(eq.rhs(u, 0.0), np.float64)
    # rhs values scale like 1/h^4; compare at f32 resolution relative to
    # the field's own magnitude.
    np.testing.assert_allclose(np.asarray(rhs(u), np.float64), ref,
                               rtol=0, atol=1e-5 * np.abs(ref).max())


def test_3d_flux_rhs_matches_model_rhs():
    """The 3D flux rhs == CahnHilliard3DPeriodic.rhs_fd."""
    from pde_opt_jax.grid import Domain
    from pde_opt_jax.models.cahn_hilliard import CahnHilliard3DPeriodic
    from pde_opt_jax.ops.cas_mobility import _flux_div_rhs

    rng = np.random.default_rng(10)
    B, N = 3, 8
    u = jnp.asarray(0.5 + 0.05 * rng.standard_normal((B, N, N, N)),
                    jnp.float32)
    L = 0.08
    h = L / N
    domain = Domain((N, N, N), ((-L / 2, L / 2),) * 3, "dimensionless",
                    dtype=jnp.float32)
    eq = CahnHilliard3DPeriodic(domain, 3e-3, MU, D, derivs="fd")
    rhs = _flux_div_rhs(MU, D, 3e-3, (h, h, h), (-3, -2, -1))
    ref = np.asarray(eq.rhs(u, 0.0), np.float64)
    np.testing.assert_allclose(np.asarray(rhs(u), np.float64), ref,
                               rtol=0, atol=1e-5 * np.abs(ref).max())


def test_3d_grads_match_oracle_native_diff():
    """State and kappa grads of the plain-XLA 3D macro == the FFT
    oracle's (both natively differentiated)."""
    rng = np.random.default_rng(9)
    B, N = 2, 8
    u = jnp.asarray(0.5 + 0.05 * rng.standard_normal((B, N, N, N)),
                    jnp.float32)
    h = 1.0 / N
    kap = jnp.asarray([2e-3, 6e-3])
    macro = make_ch3d_mobility_cas_macro(MU, D, N, N, N, h, h, h,
                                         1.0, 1e-6, 4,
                                         mats_dtype=jnp.float32)
    ref = ch3d_mobility_macro_reference(MU, D, h, h, h, 1.0, 1e-6, 4)
    gu_m, gk_m = jax.grad(lambda a, k: jnp.sum(macro(a, k) ** 2),
                          argnums=(0, 1))(u, kap)
    gu_r, gk_r = jax.grad(lambda a, k: jnp.sum(ref(a, k) ** 2),
                          argnums=(0, 1))(u, kap)
    np.testing.assert_allclose(np.asarray(gu_m), np.asarray(gu_r),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(np.asarray(gk_m), np.asarray(gk_r),
                               rtol=1e-4, atol=1e-8)
