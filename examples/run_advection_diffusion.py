"""Forward advection-diffusion (reference: run_advection_diffusion.ipynb).

A rotating velocity field transports a Gaussian blob while it diffuses.
"""

import argparse

import jax.numpy as jnp
import numpy as np

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import pde_opt_jax as p


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--grid", type=int, default=64)
    ap.add_argument("--t-final", type=float, default=1.0)
    args = ap.parse_args()

    N = args.grid
    domain = p.Domain((N, N), ((-1, 1), (-1, 1)))

    def velocity(t, X, Y):
        return (-Y, X)  # solid-body rotation

    model = p.PDEModel(p.AdvectionDiffusion2D, domain, p.RK4)
    X, Y = domain.mesh()
    y0 = jnp.exp(-((jnp.asarray(X) + 0.4) ** 2 + jnp.asarray(Y) ** 2) / 0.05)
    ts = np.linspace(0.0, args.t_final, 50)
    sol = model.solve(
        {"velocity": velocity, "diffusion_coeff": 0.01, "derivs": "fd"},
        y0, ts, {}, dt0=5e-4,
    )
    sol = np.asarray(sol)
    print(f"solution {sol.shape}; mass drift {abs(sol[-1].sum() - sol[0].sum())/sol[0].sum():.2e}; "
          f"peak decayed {sol[0].max():.3f} -> {sol[-1].max():.3f}")


if __name__ == "__main__":
    from pde_opt_jax.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    main()
