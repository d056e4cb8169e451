"""Env fleets sharded over a device mesh.

Wraps :class:`pde_opt_jax.envs.vector_env.VectorPDEEnv`'s pure reset/step in
``shard_map`` over a named mesh: each device owns ``num_envs/num_devices``
env instances, state never leaves its shard, and the only collectives are
whatever the caller's learner inserts (``psum`` of gradients/metrics).  This
is the multi-chip layer the reference lacks entirely (SURVEY.md §2.3) —
pure data parallelism over the interconnect, the natural shape of this
workload.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from pde_opt_jax.parallel.mesh import shard_map

from ..envs.vector_env import EnvState, VectorPDEEnv

__all__ = ["ShardedVectorPDEEnv"]


class ShardedVectorPDEEnv:
    """Shards a :class:`VectorPDEEnv` batch across a mesh axis.

    Args:
        env: the batched env; ``env.num_envs`` must divide evenly over the
            mesh axis.
        mesh: a named device mesh (see :func:`pde_opt_jax.parallel.make_mesh`).
        axis: mesh axis name to shard the env batch over.
    """

    def __init__(self, env: VectorPDEEnv, mesh: Mesh, axis: str = "env"):
        n_dev = mesh.shape[axis]
        if env.num_envs % n_dev != 0:
            raise ValueError(
                f"num_envs={env.num_envs} not divisible by mesh axis "
                f"'{axis}' size {n_dev}"
            )
        self.env = env
        self.mesh = mesh
        self.axis = axis
        self.envs_per_device = env.num_envs // n_dev

        spec = P(axis)
        rep = P()

        # Per-shard reset: each device resets its own slice of envs from its
        # own key (keys pre-split and sharded).
        def _reset_shard(keys):  # keys: (envs_per_device,)
            y0, cv, carry = jax.vmap(env._reset_single)(keys)
            B = keys.shape[0]
            state = EnvState(
                y=y0,
                t=jnp.zeros((B,), jnp.float32),
                control_value=cv,
                key=carry,
                step_count=jnp.zeros((B,), jnp.int32),
                done=jnp.zeros((B,), bool),
            )
            return state, env.state_to_observation_func(y0)

        def _step_shard(state, actions):
            return env._step_impl(state, actions)

        self._reset = jax.jit(
            shard_map(
                _reset_shard, mesh=mesh,
                in_specs=(spec,), out_specs=(spec, spec),
            )
        )
        # check_vma=False: pathwise-gradient training differentiates through
        # this sharded step, whose rfft-based spectral steppers hit the jax
        # 0.8 rfft-transpose VMA-checker bug (see mesh.shard_map docstring).
        # Scoped to this one region; all other shard_maps keep the checker.
        self._step = jax.jit(
            shard_map(
                _step_shard, mesh=mesh,
                in_specs=(spec, spec),
                out_specs=(spec, spec, spec, spec, spec, spec),
                check_vma=False,
            ),
            donate_argnums=(0,),
        )

    def reset(self, key):
        keys = jax.random.split(key, self.env.num_envs)
        keys = jax.device_put(keys, NamedSharding(self.mesh, P(self.axis)))
        return self._reset(keys)

    def step(self, state, actions):
        return self._step(state, actions)

    def make_rollout(self, policy_fn: Callable, n_steps: int):
        """Compile an ``n_steps`` on-device rollout across the mesh.

        Same carry discipline as :meth:`VectorPDEEnv.make_rollout`: the
        obs a step returns IS the next state's observation, so each state
        is observed exactly once per step — with the fused epilogue, by
        the kernel itself.  The whole rollout (including the initial
        observation) is one jitted program: nothing here runs outside the
        trace.
        """
        env = self.env

        def body(carry, _):
            st, obs, k = carry
            k, ak = jax.random.split(k)
            actions = policy_fn(obs, ak)
            st, obs, reward, terminated, truncated, _ = self._step(st, actions)
            return (st, obs, k), (reward, terminated)

        @partial(jax.jit, donate_argnums=(0,))
        def run(state, key):
            obs0 = env.state_to_observation_func(state.y)
            (state, _, _), (rewards, terms) = jax.lax.scan(
                body, (state, obs0, key), None, length=n_steps
            )
            return state, rewards, terms

        return run

    def rollout(self, state, policy_fn: Callable, n_steps: int,
                key: Optional[jax.Array] = None):
        """On-device rollout across the mesh (cached compile per
        ``(policy_fn, n_steps)``; state buffers are donated, as on the
        single-device path)."""
        if key is None:
            key = jax.random.PRNGKey(0)
        cache_key = (id(policy_fn), n_steps)
        cache = getattr(self, "_rollout_cache", None)
        if cache is None:
            cache = self._rollout_cache = {}
        if cache_key not in cache:
            # Hold a reference to policy_fn so its id stays unique; bound
            # the cache so per-iteration lambdas (fresh id every call)
            # cannot leak one compiled executable + closure per step —
            # use make_rollout directly for long-lived reuse.
            while len(cache) >= 8:
                cache.pop(next(iter(cache)))
            cache[cache_key] = (self.make_rollout(policy_fn, n_steps),
                                policy_fn)
        run, _ = cache[cache_key]
        return run(state, key)
