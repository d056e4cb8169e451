"""Property-based MMS fuzz: order-2 accuracy holds for random coefficients.

The fixed convergence tests (tests/test_rhs_convergence.py) pin one
mu/D/R per family; here random polynomial coefficient functions (fixed
seeds, 3 draws per family) go through the same symbolic-twin machinery and
must still show ~4x error reduction per grid doubling — a guard against
operator-assembly bugs that happen to cancel for the hand-picked cases.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import sympy as sp

from pde_opt_jax.models.allen_cahn import AllenCahn2DPeriodic
from pde_opt_jax.models.cahn_hilliard import CahnHilliard2DPeriodic
from pde_opt_jax.models.symbolic import (
    SymbolicAllenCahn2DPeriodic,
    SymbolicCahnHilliard2DPeriodic,
)
from pde_opt_jax.utils.testing import check_convergence

X, Y, T = sp.symbols("x y t", real=True)
U_STAR = sp.sin(2 * X) * sp.cos(3 * Y) * sp.exp(-sp.Rational(1, 2) * T)
L = 2 * np.pi
NS = [64, 128]


def _poly(coeffs):
    """Coefficient function usable on jax arrays AND sympy expressions."""
    def f(u):
        out = coeffs[0]
        for c in coeffs[1:]:
            out = out * u + c
        return out + 0 * u   # keep sympy type; no-op for jax
    return f


def _ratio(res):
    return res.errors[0] / res.errors[1]


@pytest.mark.slow
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cahn_hilliard_mms_random_coeffs(seed):
    rng = np.random.default_rng(seed)
    mu_c = rng.uniform(-1.0, 1.0, size=3)
    # D must stay positive on the manufactured solution's range [-1, 1].
    D_c = np.array([rng.uniform(0.1, 0.5), 0.0,
                    rng.uniform(0.5, 1.5)])  # a*u^2 + b > 0
    mu_f, D_f = _poly(mu_c), _poly(D_c)
    res = check_convergence(
        CahnHilliard2DPeriodic,
        SymbolicCahnHilliard2DPeriodic,
        {"kappa": 1e-2, "mu": mu_f, "D": D_f, "derivs": "fd"},
        {"kappa": 1e-2, "mu_sym": mu_f, "D_sym": D_f, "u_star": U_STAR},
        NS, L, dtype=jnp.float64,
    )
    assert 3.0 < _ratio(res) < 5.0, res


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_allen_cahn_mms_random_coeffs(seed):
    rng = np.random.default_rng(seed)
    mu_c = rng.uniform(-1.0, 1.0, size=4)
    R_c = np.array([rng.uniform(0.1, 0.5), 0.0, rng.uniform(0.5, 1.5)])
    mu_f, R_f = _poly(mu_c), _poly(R_c)
    res = check_convergence(
        AllenCahn2DPeriodic,
        SymbolicAllenCahn2DPeriodic,
        {"kappa": 1e-2, "mu": mu_f, "R": R_f, "derivs": "fd"},
        {"kappa": 1e-2, "mu_sym": mu_f, "R_sym": R_f, "u_star": U_STAR},
        NS, L, dtype=jnp.float64,
    )
    assert 3.0 < _ratio(res) < 5.0, res
