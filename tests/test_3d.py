"""3D Cahn-Hilliard parity: MMS order, spectral rollout, 32³ LM training.

Covers the reference's 3D workload surface: its 3D equation
(``/root/reference/pde_opt/numerics/equations/cahn_hilliard.py:112-200``)
and its 32³ Legendre-parameterized training notebook
(``/root/reference/docs/notebooks/optimization_3D.ipynb`` cells 4, 23) —
with verification the reference itself never had (no 3D MMS or rollout test
exists upstream).
"""

import pytest
import jax
import jax.numpy as jnp
import numpy as np
import sympy as sp

import pde_opt_jax as p
from pde_opt_jax.models.cahn_hilliard import CahnHilliard3DPeriodic
from pde_opt_jax.models.functions import DiffusionLegendrePolynomials
from pde_opt_jax.models.symbolic import SymbolicCahnHilliard3DPeriodic
from pde_opt_jax.utils.testing import check_convergence, fit_order

MU = lambda c: c**3 - c
DCONST = lambda c: jnp.ones_like(c)


@pytest.mark.slow
def test_rhs_convergence_cahn_hilliard_3d():
    """FD RHS is 2nd-order accurate in 3D (slope ≈ 2 on the grid ladder)."""
    X, Y, Z, T = sp.symbols("x y z t", real=True)
    # One wavelength per axis: the 4th-order CH operator amplifies high
    # frequencies, so higher-k manufactured solutions stay preasymptotic
    # until much finer grids (measured: slope 1.3 with sin2x·cos3y·sinz on
    # this ladder vs 1.97 here — both reach 2.0 in the limit).
    u_star = sp.sin(X) * sp.cos(Y) * sp.sin(Z) * sp.exp(-0.7 * T)
    mu_sym = lambda u: u**3 - u
    D_sym = lambda u: 1 + u**2
    dx, errors = check_convergence(
        CahnHilliard3DPeriodic,
        SymbolicCahnHilliard3DPeriodic,
        {"kappa": 1e-2, "mu": mu_sym, "D": D_sym, "derivs": "fd"},
        {"kappa": 1e-2, "mu_sym": mu_sym, "D_sym": D_sym, "u_star": u_star},
        [16, 32, 64, 96],
        2 * np.pi,
        dtype=jnp.float64,
        ndim=3,
    )
    np.testing.assert_allclose(fit_order(dx, errors), 2.0, rtol=0.1)


def _domain3(N=32):
    L = 0.01 * N
    return p.Domain(
        (N, N, N),
        ((-L / 2, L / 2), (-L / 2, L / 2), (-L / 2, L / 2)),
        dtype=jnp.float64,
    )


def test_3d_spectral_rollout_finite_and_conservative():
    """Batched rfft-based 3D SIF rollout: finite, mass-conserving."""
    domain = _domain3(32)
    model = p.PDEModel(CahnHilliard3DPeriodic, domain,
                       p.SemiImplicitFourierSpectral)
    key = jax.random.PRNGKey(0)
    # Leading batch axis: 3 independent 32³ fields integrate in one rollout.
    y0 = jnp.clip(0.05 * jax.random.normal(key, (3, 32, 32, 32)) + 0.5, 0, 1)
    ts = np.linspace(0.0, 2e-4, 3)
    sol = model.solve(
        {"kappa": 0.002, "mu": MU, "D": DCONST, "derivs": "fourier"},
        y0, ts, {"A": 0.5}, dt0=5e-5,
    )
    assert sol.shape == (3, 3, 32, 32, 32)
    assert bool(jnp.isfinite(sol).all())
    drift = jnp.abs(sol[-1].mean(axis=(-3, -2, -1)) - sol[0].mean(axis=(-3, -2, -1)))
    assert float(drift.max()) < 1e-10
    # and the dynamics actually moved the field
    assert float(jnp.max(jnp.abs(sol[-1] - sol[0]))) > 1e-6


def test_train_lm_recovers_kappa_32cubed():
    """32³ LM fit recovers κ — the optimization_3D.ipynb workload shape."""
    domain = _domain3(32)
    model = p.PDEModel(CahnHilliard3DPeriodic, domain,
                       p.SemiImplicitFourierSpectral)
    kappa_true = 0.002
    key = jax.random.PRNGKey(1)
    y0 = jnp.clip(0.01 * jax.random.normal(key, (32, 32, 32)) + 0.5, 0, 1)
    ts = np.linspace(0.0, 0.002, 5)
    dt0 = 0.00025
    sol = model.solve(
        {"kappa": kappa_true, "mu": MU, "D": DCONST, "derivs": "fd"},
        y0, ts, {"A": 0.5}, dt0=dt0,
    )
    data = {"ys": list(sol), "ts": list(ts)}
    res = model.train(
        data, [[0, 2, 4]],
        opt_parameters={"kappa": 0.004},
        other_parameters={"mu": MU, "D": DCONST, "derivs": "fd"},
        solver_parameters={"A": 0.5},
        weights={"kappa": None},
        lambda_reg=0.0,
        method="least_squares",
        max_steps=20,
        dt0=dt0,
    )
    assert abs(res["kappa"] - kappa_true) < 2e-5


def test_train_legendre_mobility_3d():
    """Legendre-parameterized D(u) recovered through a 16³ rollout (the
    reference's Legendre-μ/D 3D training reduced to CI scale)."""
    domain = _domain3(16)
    model = p.PDEModel(CahnHilliard3DPeriodic, domain,
                       p.SemiImplicitFourierSpectral)
    true_D = DiffusionLegendrePolynomials(jnp.array([0.3, 0.2]))
    key = jax.random.PRNGKey(2)
    y0 = jnp.clip(0.01 * jax.random.normal(key, (16, 16, 16)) + 0.5, 0, 1)
    ts = np.linspace(0.0, 0.002, 5)
    dt0 = 0.00025
    sol = model.solve(
        {"kappa": 0.002, "mu": MU, "D": true_D, "derivs": "fd"},
        y0, ts, {"A": 0.5}, dt0=dt0,
    )
    data = {"ys": list(sol), "ts": list(ts)}
    res = model.train(
        data, [[0, 1, 2, 3, 4]],
        opt_parameters={"D": DiffusionLegendrePolynomials(jnp.array([0.0, 0.0]))},
        other_parameters={"mu": MU, "kappa": 0.002, "derivs": "fd"},
        solver_parameters={"A": 0.5},
        weights={"D": None},
        lambda_reg=0.0,
        method="least_squares",
        max_steps=25,
        dt0=dt0,
    )
    got = np.asarray(res["D"].expansion.params)
    np.testing.assert_allclose(got, [0.3, 0.2], atol=2e-2)


def test_ch3d_cas_macro_matches_fft_oracle():
    """3D cas-matmul macro == jnp.fft oracle (exact semantics at f32)."""
    from pde_opt_jax.ops.cas3d import (
        ch3d_sif_macro_reference,
        make_ch3d_cas_macro,
    )

    B, N = 3, 16
    h = 0.01
    u = 0.5 + 0.05 * jax.random.normal(jax.random.PRNGKey(5), (B, N, N, N))
    u = u.astype(jnp.float32)
    kap = jnp.linspace(0.002, 0.006, B).astype(jnp.float32)
    fused = make_ch3d_cas_macro(MU, N, N, N, h, h, h, 1.0, 1e-4, 3,
                                mats_dtype=jnp.float32)
    ref = ch3d_sif_macro_reference(MU, h, h, h, 1.0, 1e-4, 3)
    np.testing.assert_allclose(np.asarray(fused(u, kap)),
                               np.asarray(ref(u, kap)), rtol=0, atol=5e-5)
    # natively differentiable
    gk_f = jax.grad(lambda kk: jnp.sum(fused(u, kk) ** 2))(kap)
    gk_r = jax.grad(lambda kk: jnp.sum(ref(u, kk) ** 2))(kap)
    np.testing.assert_allclose(np.asarray(gk_f), np.asarray(gk_r),
                               rtol=1e-3, atol=1e-7)


def test_ch3d_cas_stepper_through_model_solve():
    from pde_opt_jax.ops.steppers import FusedSemiImplicitSpectral3D

    domain = _domain3(16)
    model = p.PDEModel(CahnHilliard3DPeriodic, domain,
                       FusedSemiImplicitSpectral3D)
    y0 = jnp.clip(
        0.05 * jax.random.normal(jax.random.PRNGKey(6), (16, 16, 16)) + 0.5,
        0, 1,
    ).astype(jnp.float64)
    ts = np.linspace(0.0, 3e-4, 4)
    sol = model.solve(
        {"kappa": 0.002, "mu": MU, "D": DCONST, "derivs": "fd"},
        y0, ts, {"A": 1.0, "mats_dtype": jnp.float64}, dt0=1e-4,
    )
    assert bool(jnp.isfinite(sol).all())
    drift = abs(float(sol[-1].mean() - sol[0].mean()))
    # mass conserved to cas-transform f64 roundoff (not rfft-exact zero)
    assert drift < 1e-8
    assert float(jnp.max(jnp.abs(sol[-1] - sol[0]))) > 1e-7
