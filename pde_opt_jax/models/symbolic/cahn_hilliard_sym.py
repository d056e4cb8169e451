"""Cahn-Hilliard manufactured-solution twins (2D and 3D) via the MMS engine.

Capability parity with the reference's 2D symbolic class
(``/root/reference/pde_opt/numerics/symbolic/cahn_hilliard_sym.py:14-48``);
the 3D twin (no reference counterpart — the reference never order-verified
its 3D equation) backs the 32³ training-parity tests.  Both contribute only
the conserved-flux operator algebra
(:func:`pde_opt_jax.models.symbolic.mms.cahn_hilliard_operator`).
"""

from __future__ import annotations

from typing import Callable

import sympy as sp

from .base_sym_eq import BaseSymbolicEquation
from .mms import MMS, cahn_hilliard_operator

__all__ = ["SymbolicCahnHilliard2DPeriodic", "SymbolicCahnHilliard3DPeriodic"]


class _SymbolicCahnHilliard(BaseSymbolicEquation):
    def __init__(self, domain, kappa: float, mu_sym: Callable,
                 D_sym: Callable, u_star: sp.Expr):
        self.domain = domain
        self._mms = MMS(domain, u_star,
                        cahn_hilliard_operator(kappa, mu_sym, D_sym))

    def u_exact(self, t: float):
        return self._mms.u_exact(t)

    def rhs_exact(self, t: float):
        return self._mms.rhs_exact(t)


class SymbolicCahnHilliard2DPeriodic(_SymbolicCahnHilliard):
    """Exact RHS of u_t = ∇·(D(u)∇(μ(u) − κ∆u)) at a 2D manufactured u*."""


class SymbolicCahnHilliard3DPeriodic(_SymbolicCahnHilliard):
    """3D twin: same operator, u*(x, y, z, t) on a rank-3 Domain."""
