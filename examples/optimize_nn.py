"""Learn a neural-network chemical potential by differentiating through the solver.

Mirrors the reference's end-to-end NN training driver
(``notebooks/optimize_nn_script.py:15-112``): generate Cahn-Hilliard data
with a known Flory-Huggins μ, then fit a PeriodicCNN μ from snapshots.
Small sizes by default so it runs on CPU in ~a minute; crank --grid/--steps
on the GPU.
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
    ap.add_argument("--grid", type=int, default=32)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--method", type=str, default="adam", choices=["adam", "mse"])
    ap.add_argument("--lr", type=float, default=1e-2)
    args = ap.parse_args()

    N = args.grid
    L = 0.01 * N
    domain = p.Domain((N, N), ((-L / 2, L / 2), (-L / 2, L / 2)))
    model = p.PDEModel(p.CahnHilliard2DPeriodic, domain, p.SemiImplicitFourierSpectral)

    true_mu = lambda c: jnp.log(jnp.clip(c, 1e-3, 1 - 1e-3) / (1.0 - jnp.clip(c, 1e-3, 1 - 1e-3))) + 3.0 * (1.0 - 2.0 * c)
    D = lambda c: jnp.ones_like(c)
    params = {"kappa": 0.002, "mu": true_mu, "D": D, "derivs": "fd"}

    key = jax.random.PRNGKey(0)
    y0 = jnp.clip(0.01 * jax.random.normal(key, (N, N)) + 0.5, 0.0, 1.0)
    ts = np.linspace(0.0, 0.004, 9)
    DT0 = 0.00025
    sol = model.solve(params, y0, ts, {"A": 0.5}, dt0=DT0)
    data = {"ys": list(sol), "ts": list(ts)}
    inds = [[0, 2, 4], [4, 6, 8]]

    cnn = p.PeriodicCNN(in_channels=1, hidden_channels=(16, 16), out_channels=1,
                        kernel_size=3, key=jax.random.PRNGKey(1))
    res = model.train(
        data, inds,
        opt_parameters={"mu": cnn},
        other_parameters={"kappa": 0.002, "D": D, "derivs": "fd"},
        solver_parameters={"A": 0.5},
        weights={"mu": None},
        lambda_reg=0.0,
        method=args.method,
        max_steps=args.steps,
        dt0=DT0,
        learning_rate=args.lr,
        verbose=True,
    )

    fit = model.solve({**res}, y0, ts, {"A": 0.5}, dt0=DT0)
    err = float(jnp.sqrt(jnp.mean((fit - sol) ** 2)))
    print(f"trajectory RMSE after training: {err:.3e}")


if __name__ == "__main__":
    from pde_opt_jax.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    main()
