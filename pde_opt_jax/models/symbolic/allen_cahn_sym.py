"""Allen-Cahn manufactured-solution twin — thin wrapper over the MMS engine.

Capability parity with the reference's per-equation symbolic class
(``/root/reference/pde_opt/numerics/symbolic/allen_cahn_sym.py:12-45``); here
the equation contributes only its operator algebra
(:func:`pde_opt_jax.models.symbolic.mms.allen_cahn_operator`) and the
generic :class:`~pde_opt_jax.models.symbolic.mms.MMS` engine does the rest.
"""

from __future__ import annotations

from typing import Callable

import sympy as sp

from .base_sym_eq import BaseSymbolicEquation
from .mms import MMS, allen_cahn_operator

__all__ = ["SymbolicAllenCahn2DPeriodic"]


class SymbolicAllenCahn2DPeriodic(BaseSymbolicEquation):
    """Exact RHS of u_t = −R(u)(μ(u) − κ∆u) at a manufactured u*(x, y, t)."""

    def __init__(self, domain, kappa: float, mu_sym: Callable,
                 R_sym: Callable, u_star: sp.Expr):
        self.domain = domain
        self._mms = MMS(domain, u_star,
                        allen_cahn_operator(kappa, mu_sym, R_sym))

    def u_exact(self, t: float):
        return self._mms.u_exact(t)

    def rhs_exact(self, t: float):
        return self._mms.rhs_exact(t)
