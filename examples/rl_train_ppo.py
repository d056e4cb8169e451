"""Co-located PPO on the 64x64 Cahn-Hilliard control fleet.

The on-device counterpart of the reference's stable-baselines3 PPO notebook
(``/root/reference/notebooks/test_pde_RL.ipynb``): one jitted train step =
on-device rollout over the whole env batch + GAE + minibatched clipped
updates.  Scale ``--num-envs`` to the chip; wrap the env in
``ShardedVectorPDEEnv`` for a mesh.
"""

import argparse
import os as _os
import sys as _sys
import time

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import jax

from pde_opt_jax.envs import make_cahn_hilliard_control_env
from pde_opt_jax.rl import ActorCriticConv, PPOConfig, ppo_train


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--env", type=str, default="ch",
                    choices=["ch", "ac", "gpe", "gpe_rot", "bv", "sbm_bv"],
                    help="fleet preset: Cahn-Hilliard (kappa control), "
                         "Allen-Cahn (kappa control), Gross-Pitaevskii "
                         "(optical-spot control), rotating-frame GPE "
                         "(vortex stirring), Butler-Volmer (C-rate "
                         "charging), or smoothed-boundary BV charging")
    ap.add_argument("--policy", type=str, default="conv",
                    choices=["conv", "mlp"],
                    help="conv torso (SB3 CnnPolicy parity) or the "
                         "flattened-MLP torso")
    ap.add_argument("--num-envs", type=int, default=256)
    ap.add_argument("--grid", type=int, default=64)
    ap.add_argument("--substeps", type=int, default=10)
    ap.add_argument("--updates", type=int, default=50)
    ap.add_argument("--rollout", type=int, default=16)
    ap.add_argument("--lr", type=float, default=3e-4)
    args = ap.parse_args()

    if args.env == "ch":
        env = make_cahn_hilliard_control_env(
            num_envs=args.num_envs, grid_size=args.grid,
            substeps=args.substeps, vectorized_control=True,
        )
    elif args.env == "ac":
        from pde_opt_jax.envs import make_allen_cahn_control_env

        env = make_allen_cahn_control_env(
            num_envs=args.num_envs, grid_size=args.grid,
            substeps=args.substeps,
        )
    elif args.env == "gpe":
        from pde_opt_jax.envs import make_gpe_control_env

        env = make_gpe_control_env(
            num_envs=args.num_envs, grid_size=args.grid,
            substeps=args.substeps,
        )
    elif args.env == "gpe_rot":
        from pde_opt_jax.envs import make_gpe_rot_control_env

        env = make_gpe_rot_control_env(
            num_envs=args.num_envs, grid_size=args.grid,
            substeps=args.substeps,
        )
    elif args.env == "sbm_bv":
        from pde_opt_jax.envs import make_sbm_butler_volmer_control_env

        env = make_sbm_butler_volmer_control_env(
            num_envs=args.num_envs, grid_size=args.grid,
            substeps=args.substeps,
        )
    else:
        from pde_opt_jax.envs import make_butler_volmer_control_env

        env = make_butler_volmer_control_env(
            num_envs=args.num_envs, grid_size=args.grid,
            substeps=args.substeps,
        )
    if args.policy == "mlp":
        from pde_opt_jax.rl import ActorCriticMLP

        obs = env.reset(jax.random.PRNGKey(0))[1]
        in_f = int(obs.shape[-3] * obs.shape[-2] * obs.shape[-1])
        net = ActorCriticMLP(action_dim=1, in_features=in_f, widths=(256,),
                             features=64, key=jax.random.PRNGKey(0))
    else:
        net = ActorCriticConv(action_dim=1, channels=(16, 32), features=64,
                              key=jax.random.PRNGKey(0))
    cfg = PPOConfig(rollout_steps=args.rollout, lr=args.lr)

    t0 = time.time()

    def log(update, m):
        if update % 5 == 0 or update == args.updates - 1:
            steps = (update + 1) * args.rollout * args.num_envs
            print(f"update {update:4d}  reward {m['reward_mean']:+.3e}  "
                  f"loss {m['loss']:+.3e}  ent {m['entropy']:.3f}  "
                  f"{steps/(time.time()-t0):,.0f} env-steps/s", flush=True)

    ppo_train(env, net, cfg, num_updates=args.updates,
              key=jax.random.PRNGKey(1), log_fn=log)


if __name__ == "__main__":
    from pde_opt_jax.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    main()
