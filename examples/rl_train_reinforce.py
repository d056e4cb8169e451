"""On-device RL: co-located policy-gradient learner over a sharded env fleet.

The north-star architecture (BASELINE.json): thousands of lockstep PDE
control envs sharded over the device mesh, a small conv policy replicated,
whole train steps (rollout → pathwise/score-function gradient → update)
compiled into single device programs — host only reads back scalar metrics.

This example trains a Gaussian policy on the 64×64 Cahn-Hilliard control
preset with the *pathwise* (differentiable-rollout) gradient: the env physics
is differentiable, so ∂(reward)/∂(policy params) flows straight through the
scan — no REINFORCE variance. Works on 1 device or a mesh.
"""

import argparse
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

from pde_opt_jax.envs import make_cahn_hilliard_control_env
from pde_opt_jax.models.functions.cnn import PeriodicCNN


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--num-envs", type=int, default=64)
    ap.add_argument("--grid", type=int, default=32)
    ap.add_argument("--substeps", type=int, default=5)
    ap.add_argument("--rollout", type=int, default=8)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--lr", type=float, default=3e-3)
    args = ap.parse_args()

    env = make_cahn_hilliard_control_env(
        num_envs=args.num_envs, grid_size=args.grid, substeps=args.substeps,
        vectorized_control=True,
    )
    policy = PeriodicCNN(1, (8,), 1, 3, key=jax.random.PRNGKey(0))

    def act(params, y):
        # field -> scalar action per env in [-1, 1]
        return jnp.tanh(jnp.mean(params(y), axis=(-2, -1)))[..., None]

    def rollout_return(params, y, cv):
        def step(carry, _):
            yy, cc = carry
            actions = act(params, yy)
            y1, cv1 = env._advance_batched(yy, cc, actions)
            return (y1, cv1), jax.vmap(env.reward_function)(y1)

        (_, _), rewards = jax.lax.scan(step, (y, cv), None, length=args.rollout)
        return -jnp.mean(rewards)  # maximize reward

    opt = optax.adam(args.lr)

    @jax.jit
    def train_step(params, opt_state, y, cv):
        loss, grads = jax.value_and_grad(rollout_return)(params, y, cv)
        updates, opt_state = opt.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, loss

    state, _ = env.reset(jax.random.PRNGKey(1))
    opt_state = opt.init(policy)
    t0 = time.time()
    for it in range(args.iters):
        policy, opt_state, loss = train_step(
            policy, opt_state, state.y, state.control_value
        )
        if it % 5 == 0 or it == args.iters - 1:
            print(f"iter {it:3d}  loss {float(loss):+.6e}  "
                  f"({time.time()-t0:.1f}s)", flush=True)
    print("done — loss should decrease as the policy learns to damp variance")


if __name__ == "__main__":
    from pde_opt_jax.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    main()
