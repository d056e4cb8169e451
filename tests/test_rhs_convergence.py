"""Order-of-accuracy (MMS) tests — slope ≈ 2.0 over the 32..512 grid ladder.

Same oracle as the reference (``tests/test_rhs_convergence.py:14-77``), plus
advection-diffusion (restored ghost equation) and the spectral paths (which
should converge faster than any fixed order on smooth data).
"""

import jax.numpy as jnp
import numpy as np
import sympy as sp

from pde_opt_jax.models import (
    AdvectionDiffusion2D,
    AllenCahn2DPeriodic,
    CahnHilliard2DPeriodic,
)
from pde_opt_jax.models.symbolic import (
    SymbolicAdvectionDiffusion2D,
    SymbolicAllenCahn2DPeriodic,
    SymbolicCahnHilliard2DPeriodic,
)
from pde_opt_jax.utils.testing import check_convergence, fit_order

X, Y, T = sp.symbols("x y t", real=True)
U_STAR = sp.sin(2 * X) * sp.cos(3 * Y) * sp.exp(-0.7 * T)
NS = [32, 64, 128, 256, 512]
L = 2 * np.pi


def test_rhs_convergence_allen_cahn():
    mu_sym = lambda u: u**3 - u
    R_sym = lambda u: 1 + u**2
    dx, errors = check_convergence(
        AllenCahn2DPeriodic,
        SymbolicAllenCahn2DPeriodic,
        {"kappa": 1e-2, "mu": mu_sym, "R": R_sym, "derivs": "fd"},
        {"kappa": 1e-2, "mu_sym": mu_sym, "R_sym": R_sym, "u_star": U_STAR},
        NS,
        L,
        dtype=jnp.float64,
    )
    np.testing.assert_allclose(fit_order(dx, errors), 2.0, rtol=0.1)


def test_rhs_convergence_cahn_hilliard():
    mu_sym = lambda u: u**3 - u
    D_sym = lambda u: 1 + u**2
    dx, errors = check_convergence(
        CahnHilliard2DPeriodic,
        SymbolicCahnHilliard2DPeriodic,
        {"kappa": 1e-2, "mu": mu_sym, "D": D_sym, "derivs": "fd"},
        {"kappa": 1e-2, "mu_sym": mu_sym, "D_sym": D_sym, "u_star": U_STAR},
        NS,
        L,
        dtype=jnp.float64,
    )
    np.testing.assert_allclose(fit_order(dx, errors), 2.0, rtol=0.1)


def test_rhs_convergence_advection_diffusion():
    def v_jax(t, Xm, Ym):
        return (jnp.sin(Xm) * jnp.cos(Ym), -jnp.cos(Xm) * jnp.sin(Ym))

    def v_sym(t, x, y):
        return (sp.sin(x) * sp.cos(y), -sp.cos(x) * sp.sin(y))

    dx, errors = check_convergence(
        AdvectionDiffusion2D,
        SymbolicAdvectionDiffusion2D,
        {"velocity": v_jax, "diffusion_coeff": 0.1, "derivs": "fd"},
        {"diffusion_coeff": 0.1, "v_sym": v_sym, "u_star": U_STAR},
        NS,
        L,
        dtype=jnp.float64,
    )
    np.testing.assert_allclose(fit_order(dx, errors), 2.0, rtol=0.1)


def test_rhs_spectral_cahn_hilliard_superconvergent():
    """The pseudo-spectral RHS should beat 4th order on smooth data."""
    mu_sym = lambda u: u**3 - u
    D_sym = lambda u: 1 + u**2
    dx, errors = check_convergence(
        CahnHilliard2DPeriodic,
        SymbolicCahnHilliard2DPeriodic,
        {"kappa": 1e-2, "mu": mu_sym, "D": D_sym, "derivs": "fourier"},
        {"kappa": 1e-2, "mu_sym": mu_sym, "D_sym": D_sym, "u_star": U_STAR},
        [16, 32, 64],
        L,
        dtype=jnp.float64,
    )
    # Nonlinear terms alias at N=16 but errors must crash toward roundoff.
    assert errors[-1] < 1e-8
