"""Galvanostatic Butler-Volmer electrochemistry (reference: run_butler_volmer notebooks).

Simulates lithiation of a phase-separating electrode particle under constant
current; tracks the cell voltage from the closed-form galvanostatic closure.
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
    ap.add_argument("--grid", type=int, default=64)
    ap.add_argument("--crate", type=float, default=1.0)
    ap.add_argument("--steps", type=int, default=400)
    args = ap.parse_args()

    N = args.grid
    domain = p.Domain((N, N), ((-0.5, 0.5), (-0.5, 0.5)))
    eq = p.AllenCahn2DPeriodicButlerVolmerConstantCurrent(
        domain,
        kappa=5e-4,
        mu=lambda c: jnp.log(jnp.clip(c, 1e-4, 1 - 1e-4) / (1 - jnp.clip(c, 1e-4, 1 - 1e-4)))
        + 3.0 * (1.0 - 2.0 * c),
        j0=lambda c: jnp.sqrt(jnp.clip(c * (1 - c), 1e-6, None)),
        alpha=0.5,
        Crate=args.crate,
    )
    key = jax.random.PRNGKey(0)
    u = jnp.clip(0.05 + 0.005 * jax.random.normal(key, (N, N)), 0.01, 0.99)
    dt = 5e-4
    stepper = p.RK4()
    voltages = []
    fill = []
    chunk = 20                      # one compiled scan per record point
    for i in range(0, args.steps, chunk):
        voltages.append(float(eq.get_voltage(u)))
        fill.append(float(u.mean()))
        u = p.evolve(stepper, eq.rhs, u, i * dt, dt, chunk)
    # Final record: the post-evolution state after the full args.steps steps.
    voltages.append(float(eq.get_voltage(u)))
    fill.append(float(u.mean()))
    print("state of charge:", [f"{f:.3f}" for f in fill])
    print("cell voltage:   ", [f"{v:+.3f}" for v in voltages])
    # Conservation check: mean filling rate == Crate / area
    area = domain.L[0] * domain.L[1]
    print(f"expected d<c>/dt = Crate/area = {args.crate/area:.3f}; "
          f"measured ≈ {(fill[-1]-fill[0])/(chunk*dt*(len(fill)-1)):.3f}")


if __name__ == "__main__":
    from pde_opt_jax.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    main()
