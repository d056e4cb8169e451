"""Optimal fast-charging protocol by differentiating through the physics.

The classic electrochemistry control problem on the galvanostatic
Butler-Volmer cell (reference equations ``allen_cahn.py:213-281``): find a
piecewise-constant C-rate schedule that reaches a target state of charge in
fixed time while keeping lithiation *uniform* (suppressing the phase
separation that damages electrodes). The schedule is optimized by direct
gradient descent THROUGH the solver: the XLA RK4 macro
(``ops/bv_reference.py``) is a checkpointed scan, so ``jax.grad`` flows
through every RK4 substep and the per-segment C-rates get exact pathwise
gradients.

Run: python examples/optimize_charging.py  (CPU ~1 min)
"""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import optax

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

from pde_opt_jax.ops.bv_reference import bv_cc_reference  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--grid", type=int, default=16)
    ap.add_argument("--segments", type=int, default=10)
    ap.add_argument("--substeps", type=int, default=40)
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--target-soc", type=float, default=0.45)
    ap.add_argument("--var-weight", type=float, default=30.0)
    ap.add_argument("--lr", type=float, default=0.05)
    args = ap.parse_args()

    N = args.grid
    h = 1.0 / N
    dt = 5e-4
    kappa = 5e-5                    # thin interfaces: separation can develop
    clip = lambda c: jnp.clip(c, 1e-4, 1 - 1e-4)
    mu = lambda c: jnp.log(clip(c) / (1 - clip(c))) + 3.0 * (1.0 - 2.0 * c)
    j0 = lambda c: jnp.sqrt(jnp.clip(c * (1 - c), 1e-6, None))

    macro = bv_cc_reference(mu, j0, kappa, h, h, dt, args.substeps)

    u0 = jnp.clip(
        0.05 + 0.02 * jax.random.normal(jax.random.PRNGKey(0), (1, N, N)),
        0.01, 0.99,
    )
    total_t = args.segments * args.substeps * dt
    # Uniform-rate baseline that exactly reaches the target (area = 1).
    c_uniform = (args.target_soc - float(u0.mean())) / total_t

    def loss_fn(log_rates):
        rates = jnp.exp(log_rates)                     # positivity
        u = u0
        var_peak = 0.0
        for s in range(args.segments):
            u = macro(u, rates[s][None])
            var_peak = jnp.maximum(var_peak, jnp.var(u))
        soc = jnp.mean(u)
        loss = (soc - args.target_soc) ** 2 + args.var_weight * var_peak
        return loss, (soc, var_peak)

    log_rates = jnp.log(jnp.full((args.segments,), c_uniform))
    opt = optax.adam(args.lr)
    opt_state = opt.init(log_rates)
    vg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))

    (l0, (soc0, vp0)), _ = vg(log_rates)
    print(f"uniform baseline: C = {c_uniform:.3f} x {args.segments} segments"
          f" -> loss {float(l0):.4e}  SOC {float(soc0):.3f}  "
          f"peak var {float(vp0):.2e}")

    for k in range(args.steps):
        (loss, (soc, vpeak)), g = vg(log_rates)
        updates, opt_state = opt.update(g, opt_state)
        log_rates = optax.apply_updates(log_rates, updates)
        if k % 10 == 0 or k == args.steps - 1:
            print(f"step {k:3d}  loss {float(loss):.4e}  "
                  f"SOC {float(soc):.3f} (target {args.target_soc})  "
                  f"peak var {float(vpeak):.2e}", flush=True)

    rates = np.exp(np.asarray(log_rates))
    print("optimized C-rate schedule:", np.round(rates, 3))
    ratio = rates[0] / rates[-1]
    print(f"schedule shape: first/last segment ratio {ratio:.2f} "
          f"({'front-loaded' if ratio > 1 else 'back-loaded'}; for these "
          f"parameters the exchange kinetics j0*e^(+/-mu/2) amplify "
          f"non-uniformity hardest at LOW filling, so easing in and "
          f"finishing hard minimizes the peak variance)")


if __name__ == "__main__":
    from pde_opt_jax.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    main()
