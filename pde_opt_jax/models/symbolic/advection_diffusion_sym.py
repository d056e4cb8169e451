"""Advection-diffusion manufactured-solution twin via the MMS engine.

No reference counterpart (the equation only ever appeared in reference
notebooks, ``notebooks/run_advection_diffusion.ipynb``); backs the restored
:class:`pde_opt_jax.models.advection_diffusion.AdvectionDiffusion2D`.
"""

from __future__ import annotations

from typing import Callable

import sympy as sp

from .base_sym_eq import BaseSymbolicEquation
from .mms import MMS, advection_diffusion_operator

__all__ = ["SymbolicAdvectionDiffusion2D"]


class SymbolicAdvectionDiffusion2D(BaseSymbolicEquation):
    """Exact RHS of u_t = −∇·(u·v) + D∆u at a manufactured u*(x, y, t).

    ``v_sym(t, x, y) -> (vx, vy)`` is the symbolic velocity field.
    """

    def __init__(self, domain, diffusion_coeff: float, v_sym: Callable,
                 u_star: sp.Expr):
        self.domain = domain
        self._mms = MMS(
            domain, u_star,
            advection_diffusion_operator(diffusion_coeff, v_sym),
        )

    def u_exact(self, t: float):
        return self._mms.u_exact(t)

    def rhs_exact(self, t: float):
        return self._mms.rhs_exact(t)
