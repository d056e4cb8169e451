"""Levenberg-Marquardt fitting of Legendre-parameterized physics.

Mirrors the reference's 3D Legendre optimization workload
(``docs/notebooks/optimization_3D.ipynb``): recover the chemical-potential
and mobility expansions of a Cahn-Hilliard system from trajectory snapshots,
forward-mode differentiating through the rollout (small parameter count →
LM normal equations).
"""

import argparse

import jax
import jax.numpy as jnp
import numpy as np

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import pde_opt_jax as p
from pde_opt_jax.models.functions import (
    ChemicalPotentialLegendrePolynomials,
    DiffusionLegendrePolynomials,
)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--grid", type=int, default=32)
    ap.add_argument("--three-d", action="store_true", help="use a 32³ 3D domain")
    ap.add_argument("--steps", type=int, default=30)
    args = ap.parse_args()

    N = args.grid
    L = 0.01 * N
    if args.three_d:
        domain = p.Domain((N, N, N), ((-L/2, L/2),) * 3)
        eq_type = p.CahnHilliard3DPeriodic
        shape = (N, N, N)
    else:
        domain = p.Domain((N, N), ((-L/2, L/2),) * 2)
        eq_type = p.CahnHilliard2DPeriodic
        shape = (N, N)
    model = p.PDEModel(eq_type, domain, p.SemiImplicitFourierSpectral)

    true_mu = ChemicalPotentialLegendrePolynomials(
        jnp.array([0.0, 1.5, 0.4]), prior_fn=None
    )
    true_D = DiffusionLegendrePolynomials(jnp.array([0.2, 0.1]))
    params = {"kappa": 0.002, "mu": true_mu, "D": true_D, "derivs": "fd"}
    y0 = jnp.clip(0.01 * jax.random.normal(jax.random.PRNGKey(0), shape) + 0.5, 0, 1)
    ts = np.linspace(0.0, 0.004, 9)
    DT0 = 0.00025
    sol = model.solve(params, y0, ts, {"A": 0.5}, dt0=DT0)
    data = {"ys": list(sol), "ts": list(ts)}

    res = model.train(
        data, [[0, 2, 4], [4, 6, 8]],
        opt_parameters={
            "mu": ChemicalPotentialLegendrePolynomials(jnp.zeros(3)),
            "D": DiffusionLegendrePolynomials(jnp.zeros(2)),
        },
        other_parameters={"kappa": 0.002, "derivs": "fd"},
        solver_parameters={"A": 0.5},
        weights={"mu": None, "D": None},
        lambda_reg=0.0,
        method="least_squares",
        max_steps=args.steps,
        dt0=DT0,
        verbose=True,
    )
    print("true mu coeffs:", np.asarray(true_mu.expansion.params))
    print("fit  mu coeffs:", np.asarray(res["mu"].expansion.params))
    print("true D  coeffs:", np.asarray(true_D.expansion.params))
    print("fit  D  coeffs:", np.asarray(res["D"].expansion.params))


if __name__ == "__main__":
    from pde_opt_jax.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    main()
