"""Generic method-of-manufactured-solutions (MMS) builder.

One engine for every symbolic twin: a :class:`MMS` problem is a Domain, a
manufactured solution ``u*`` (a sympy expression in the coordinate symbols
and ``t``), and a symbolic *operator* — a callable that receives ``u*`` and
the coordinate symbols and returns the exact right-hand side F(u*) as a
sympy expression.  Spatial dimension comes from the Domain's rank, so the
same engine serves 1D/2D/3D twins (the 3D Cahn-Hilliard twin backs the 32³
training-parity tests).

This replaces per-equation symbolic classes (the reference carries one
hand-written sympy class per equation,
``/root/reference/pde_opt/numerics/symbolic/``) with operator composition:
equations contribute only their operator algebra, the lambdify/meshing
machinery exists once.

Test-only, host-side (sympy never enters the jit path).
"""

from __future__ import annotations

from typing import Callable, Sequence

import jax.numpy as jnp
import sympy as sp

__all__ = [
    "MMS",
    "sym_lap",
    "sym_div",
    "sym_grad",
    "allen_cahn_operator",
    "cahn_hilliard_operator",
    "advection_diffusion_operator",
]

_COORD_NAMES = ("x", "y", "z", "w")


# ---------------------------------------------------------------------------
# symbolic differential-operator helpers
# ---------------------------------------------------------------------------

def sym_grad(expr: sp.Expr, syms: Sequence[sp.Symbol]):
    """Symbolic gradient: tuple of ∂expr/∂xᵢ."""
    return tuple(sp.diff(expr, s) for s in syms)


def sym_div(vec: Sequence[sp.Expr], syms: Sequence[sp.Symbol]) -> sp.Expr:
    """Symbolic divergence of a vector field."""
    return sum(sp.diff(v, s) for v, s in zip(vec, syms))


def sym_lap(expr: sp.Expr, syms: Sequence[sp.Symbol]) -> sp.Expr:
    """Symbolic Laplacian: Σᵢ ∂²expr/∂xᵢ²."""
    return sum(sp.diff(expr, s, 2) for s in syms)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

class MMS:
    """Manufactured-solution problem: exact field and exact RHS on a grid.

    Args:
        domain: a :class:`pde_opt_jax.grid.Domain`; its rank selects the
            coordinate symbols ``x, y, z, ...`` and its ``mesh()`` supplies
            the evaluation points.
        u_star: manufactured solution — sympy expression in the coordinate
            symbols (named ``x``/``y``/``z``) and ``t``.
        operator: ``operator(u_star, syms, t) -> sympy expr`` producing the
            exact right-hand side F(u*).
    """

    def __init__(self, domain, u_star: sp.Expr, operator: Callable):
        ndim = len(domain.points)
        if ndim > len(_COORD_NAMES):
            raise ValueError(f"unsupported spatial rank {ndim}")
        self.domain = domain
        # sp.symbols on a tuple of names returns a tuple (rank 1 included).
        syms = sp.symbols(_COORD_NAMES[:ndim], real=True)
        t = sp.Symbol("t", real=True)
        rhs_expr = operator(u_star, syms, t)
        argspec = (*syms, t)
        self._u = sp.lambdify(argspec, sp.simplify(u_star), "numpy")
        self._rhs = sp.lambdify(argspec, sp.simplify(rhs_expr), "numpy")

    def _eval(self, fn, t: float):
        meshes = self.domain.mesh()
        if not isinstance(meshes, (tuple, list)):
            meshes = (meshes,)
        return jnp.asarray(fn(*meshes, float(t)))

    def u_exact(self, t: float):
        """u*(·, t) sampled on the domain grid."""
        return self._eval(self._u, t)

    def rhs_exact(self, t: float):
        """F(u*)(·, t) sampled on the domain grid."""
        return self._eval(self._rhs, t)


# ---------------------------------------------------------------------------
# operator factories for the shipped equations
# ---------------------------------------------------------------------------

def allen_cahn_operator(kappa, mu_sym: Callable, R_sym: Callable):
    """Allen-Cahn (nonconserved relaxation): F(u) = −R(u)·(μ(u) − κ∆u)."""

    def op(u, syms, t):
        return -R_sym(u) * (mu_sym(u) - kappa * sym_lap(u, syms))

    return op


def cahn_hilliard_operator(kappa, mu_sym: Callable, D_sym: Callable):
    """Cahn-Hilliard (conserved flux form): F(u) = ∇·(D(u)∇(μ(u) − κ∆u))."""

    def op(u, syms, t):
        chem = mu_sym(u) - kappa * sym_lap(u, syms)
        flux = tuple(D_sym(u) * g for g in sym_grad(chem, syms))
        return sym_div(flux, syms)

    return op


def advection_diffusion_operator(diffusion_coeff, v_sym: Callable):
    """Advection-diffusion: F(u) = −∇·(u·v(t,·)) + D∆u."""

    def op(u, syms, t):
        v = v_sym(t, *syms)
        return (
            -sym_div(tuple(u * vi for vi in v), syms)
            + diffusion_coeff * sym_lap(u, syms)
        )

    return op
