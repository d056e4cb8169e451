"""Forward Cahn-Hilliard spinodal decomposition (reference: run_cahn_hilliard.ipynb).

Run: python examples/run_cahn_hilliard.py [--grid 128] [--save out.npy]
"""

import argparse

import jax
import jax.numpy as jnp
import numpy as np

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import pde_opt_jax as p


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--grid", type=int, default=128)
    ap.add_argument("--t-final", type=float, default=0.02)
    ap.add_argument("--saves", type=int, default=100)
    ap.add_argument("--dt", type=float, default=1e-6)
    ap.add_argument("--save", type=str, default=None)
    args = ap.parse_args()

    N = args.grid
    L = 0.01 * N
    domain = p.Domain((N, N), ((-L / 2, L / 2), (-L / 2, L / 2)))
    model = p.PDEModel(p.CahnHilliard2DPeriodic, domain, p.SemiImplicitFourierSpectral)

    params = {
        "kappa": 0.002,
        # Flory-Huggins-style chemical potential (reference optimize_nn_script.py:33)
        "mu": lambda c: jnp.log(c / (1.0 - c)) + 3.0 * (1.0 - 2.0 * c),
        "D": lambda c: jnp.ones_like(c),
        "derivs": "fd",
    }
    y0 = jnp.clip(0.01 * jax.random.normal(jax.random.PRNGKey(0), (N, N)) + 0.5, 0.0, 1.0)
    ts = np.linspace(0.0, args.t_final, args.saves)
    sol = model.solve(params, y0, ts, {"A": 0.5}, dt0=args.dt)
    sol = np.asarray(sol)
    print(f"solution {sol.shape}; final field range "
          f"[{sol[-1].min():.3f}, {sol[-1].max():.3f}]; "
          f"mass drift {abs(sol[-1].mean() - sol[0].mean()):.2e}")
    if args.save:
        np.save(args.save, sol)
        print(f"saved to {args.save}")


if __name__ == "__main__":
    from pde_opt_jax.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    main()
