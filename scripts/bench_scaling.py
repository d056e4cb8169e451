"""Scaling-efficiency harness: aggregate env-steps/s vs shard count.

Measures the flagship fleet (CH control env, fused cas kernel) under
``ShardedVectorPDEEnv`` at 1, 2, 4, ... N mesh shards with a FIXED number
of envs per shard (weak scaling — the deployment shape), and reports
efficiency against linear scaling from the 1-shard rate.  This is the
harness behind the BASELINE ">=85% 1->N scaling" claim.

On the GPUs of one host (one process drives all cards):
    python scripts/bench_scaling.py --envs-per-device 4096 --grid 64 --steps 50

Multi-host (one process per host): add ``--distributed``.

Virtual-mesh validation of the harness itself, on the CPU:
    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
    python scripts/bench_scaling.py --grid 16 --envs-per-device 16 \
        --steps 10 --substeps 2

Prints ONE JSON line: per-shard-count rates + efficiency.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--devices", type=int, default=0,
                   help="max shard count (0 = all local devices)")
    p.add_argument("--envs-per-device", type=int, default=512)
    p.add_argument("--grid", type=int, default=64)
    p.add_argument("--substeps", type=int, default=10)
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--timed-runs", type=int, default=2)
    p.add_argument("--distributed", action="store_true",
                   help="multi-host run: call init_distributed() first")
    args = p.parse_args(argv)

    if args.distributed:
        from pde_opt_jax.parallel.mesh import init_distributed

        init_distributed()

    import jax
    import jax.numpy as jnp

    from pde_opt_jax.envs.presets import make_cahn_hilliard_control_env
    from pde_opt_jax.parallel.mesh import make_mesh
    from pde_opt_jax.parallel.sharded_env import ShardedVectorPDEEnv

    devices = jax.devices()
    n_max = args.devices or len(devices)
    counts = []
    n = 1
    while n <= n_max:
        counts.append(n)
        n *= 2
    if counts[-1] != n_max:
        counts.append(n_max)

    results = {}
    for n_dev in counts:
        num_envs = args.envs_per_device * n_dev
        env = make_cahn_hilliard_control_env(
            num_envs=num_envs, grid_size=args.grid, substeps=args.substeps,
        )
        mesh = make_mesh(devices[:n_dev], axis_names=("env",))
        senv = ShardedVectorPDEEnv(env, mesh)

        def policy(obs, key, _n=num_envs):
            return jax.random.uniform(key, (_n, 1), minval=-1.0, maxval=1.0,
                                      dtype=jnp.float32)

        state, _ = senv.reset(jax.random.PRNGKey(n_dev))
        state, rewards, _ = senv.rollout(state, policy, args.steps,
                                         key=jax.random.PRNGKey(100 + n_dev))
        jax.block_until_ready(rewards)          # compile + warm up
        t0 = time.perf_counter()
        for i in range(args.timed_runs):
            state, rewards, _ = senv.rollout(
                state, policy, args.steps,
                key=jax.random.PRNGKey(200 + n_dev + i),
            )
        jax.block_until_ready(rewards)
        dt = time.perf_counter() - t0
        rate = num_envs * args.steps * args.timed_runs / dt
        results[n_dev] = rate
        print(f"# {n_dev} shard(s): {rate:,.0f} env-steps/s "
              f"({num_envs} envs)", file=sys.stderr, flush=True)

    base = results[counts[0]] / counts[0]
    out = {
        "harness": "weak-scaling env-fleet (fused cas kernel)",
        "platform": jax.default_backend(),
        "grid": args.grid,
        "envs_per_device": args.envs_per_device,
        "rates_env_steps_per_s": {str(k): round(v, 1)
                                  for k, v in results.items()},
        "efficiency_vs_linear": {
            str(k): round(v / (k * base), 3) for k, v in results.items()
        },
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
