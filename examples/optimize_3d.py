"""32³ Cahn-Hilliard inverse problem: fit Legendre-parameterized μ and D.

The reference's 3D training workload
(``/root/reference/docs/notebooks/optimization_3D.ipynb`` cells 4, 23):
generate a 32³ trajectory with known chemical potential / mobility, then
recover their Legendre coefficients by Levenberg-Marquardt through the
rollout.  Runs on the GPU (f32) or CPU (x64); the whole batch of observation
windows integrates as one natively-batched scan.

Usage: python examples/optimize_3d.py [--jit-lm] [--fused]

``--fused`` swaps the XLA-rfft semi-implicit stepper for
:class:`pde_opt_jax.ops.steppers.FusedMobilitySpectral` — the
general-mobility cas-matmul path (no FFTs; bench.py ``ch3d_mobility``
times both).  Same scheme
order, FD-consistent symbol; gradients flow natively through the fused
macro, so LM training runs on the fast path too.
"""

import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

import pde_opt_jax as p
from pde_opt_jax.models.cahn_hilliard import CahnHilliard3DPeriodic
from pde_opt_jax.models.functions import (
    ChemicalPotentialLegendrePolynomials,
    DiffusionLegendrePolynomials,
)


def main():
    N = 32
    L = 0.01 * N
    domain = p.Domain((N, N, N), ((-L / 2, L / 2),) * 3)
    if "--fused" in sys.argv:
        from pde_opt_jax.ops.steppers import FusedMobilitySpectral

        solver_type = FusedMobilitySpectral
    else:
        solver_type = p.SemiImplicitFourierSpectral
    model = p.PDEModel(CahnHilliard3DPeriodic, domain, solver_type)

    true_mu = ChemicalPotentialLegendrePolynomials(jnp.array([0.0, 1.0, 0.5]))
    true_D = DiffusionLegendrePolynomials(jnp.array([0.3, 0.2]))
    kappa = 0.002
    dt0 = 0.00025

    key = jax.random.PRNGKey(0)
    y0 = jnp.clip(0.01 * jax.random.normal(key, (N, N, N)) + 0.5, 0.0, 1.0)
    ts = np.linspace(0.0, 0.004, 9)
    print(f"generating 32^3 ground-truth trajectory ({len(ts)} saves)...")
    sol = model.solve(
        {"kappa": kappa, "mu": true_mu, "D": true_D, "derivs": "fd"},
        y0, ts, {"A": 0.5}, dt0=dt0,
    )
    data = {"ys": list(sol), "ts": list(ts)}

    method = "least_squares_jit" if "--jit-lm" in sys.argv else "least_squares"
    print(f"fitting Legendre mu (3 coeffs) + D (2 coeffs) with {method}...")
    t0 = time.perf_counter()
    res = model.train(
        data, [[0, 2, 4], [4, 6, 8]],
        opt_parameters={
            "mu": ChemicalPotentialLegendrePolynomials(jnp.zeros(3)),
            "D": DiffusionLegendrePolynomials(jnp.zeros(2)),
        },
        other_parameters={"kappa": kappa, "derivs": "fd"},
        solver_parameters={"A": 0.5},
        weights={"mu": None, "D": None},
        lambda_reg=0.0,
        method=method,
        max_steps=60,
        dt0=dt0,
        verbose=True,
    )
    dt = time.perf_counter() - t0
    got_mu = np.asarray(res["mu"].expansion.params)
    got_D = np.asarray(res["D"].expansion.params)
    print(f"done in {dt:.1f}s")
    print(f"mu coeffs: fit {np.round(got_mu, 4)} true [0.0, 1.0, 0.5]")
    print(f"D  coeffs: fit {np.round(got_D, 4)} true [0.3, 0.2]")


if __name__ == "__main__":
    from pde_opt_jax.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    main()
