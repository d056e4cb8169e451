"""Co-located PPO over batched PDE control envs — fully on-device.

Capability parity with the reference's RL training workflow, which drives
its gym env with stable-baselines3 PPO on the host
(``/root/reference/notebooks/test_pde_RL.ipynb`` cells 0-10: ``PPO("CnnPolicy",
env)``), re-designed for the device: the rollout (env physics included), GAE,
minibatched clipped-surrogate updates, and optimizer all compile into ONE
jitted train step over the batched :class:`~pde_opt_jax.envs.vector_env.VectorPDEEnv`
(or its shard_map-wrapped fleet) — the host only reads back scalar metrics.

Standard PPO (Schulman et al., arXiv:1707.06347) with clipped value loss
and advantage normalization.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import partial
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
import optax

__all__ = ["PPOConfig", "gae", "make_ppo_train_step", "ppo_train"]


@dataclass(frozen=True)
class PPOConfig:
    rollout_steps: int = 16
    epochs: int = 2
    minibatches: int = 4
    gamma: float = 0.99
    lam: float = 0.95
    clip_eps: float = 0.2
    vf_coef: float = 0.5
    ent_coef: float = 0.01
    lr: float = 3e-4
    max_grad_norm: float = 0.5
    # Shuffle granularity: permute contiguous sample CHUNKS of this size
    # instead of individual samples when the batch divides evenly.  A
    # per-sample gather of T·B random ~256-byte rows is gather-bound;
    # chunks of consecutive samples are same-timestep
    # INDEPENDENT envs, so chunk-level shuffling preserves minibatch
    # decorrelation while the gather moves 64 KB pieces.  Set 1 to force
    # exact per-sample permutation.
    shuffle_chunk: int = 256


class Transition(NamedTuple):
    obs: jax.Array
    action: jax.Array
    logp: jax.Array
    value: jax.Array
    reward: jax.Array
    done: jax.Array


def gae(rewards, values, dones, last_value, gamma: float, lam: float):
    """Generalized advantage estimation over a (T, B) rollout.

    ``dones[t]`` marks that the episode ended AT step t (no bootstrap across
    it).  Returns ``(advantages, returns)`` with ``returns = adv + values``.
    """
    def step(carry, x):
        adv_next, v_next = carry
        r, v, d = x
        nonterminal = 1.0 - d.astype(jnp.float32)
        delta = r + gamma * v_next * nonterminal - v
        adv = delta + gamma * lam * nonterminal * adv_next
        return (adv, v), adv

    (_, _), advs = jax.lax.scan(
        step,
        (jnp.zeros_like(last_value), last_value),
        (rewards, values, dones),
        reverse=True,
    )
    return advs, advs + values


def _gaussian_sample_logp(key, mean, log_std):
    std = jnp.exp(log_std)
    eps = jax.random.normal(key, mean.shape, dtype=mean.dtype)
    a = mean + std * eps
    logp = -0.5 * jnp.sum(
        ((a - mean) / std) ** 2 + 2.0 * log_std + jnp.log(2.0 * jnp.pi), axis=-1
    )
    return a, logp


def _gaussian_logp_entropy(mean, log_std, action):
    std = jnp.exp(log_std)
    logp = -0.5 * jnp.sum(
        ((action - mean) / std) ** 2 + 2.0 * log_std + jnp.log(2.0 * jnp.pi),
        axis=-1,
    )
    ent = jnp.sum(log_std + 0.5 * jnp.log(2.0 * jnp.pi * jnp.e)) * jnp.ones(
        mean.shape[:-1]
    )
    return logp, ent


def _categorical_sample_logp(key, logits):
    a = jax.random.categorical(key, logits, axis=-1)
    logp = jnp.take_along_axis(
        jax.nn.log_softmax(logits), a[..., None], axis=-1
    )[..., 0]
    return a, logp


def _categorical_logp_entropy(logits, action):
    logp_all = jax.nn.log_softmax(logits)
    logp = jnp.take_along_axis(logp_all, action[..., None], axis=-1)[..., 0]
    ent = -jnp.sum(jnp.exp(logp_all) * logp_all, axis=-1)
    return logp, ent


def make_ppo_train_step(env, config: PPOConfig, optimizer=None):
    """Build ``train_step(params, opt_state, env_state, key)`` (jitted).

    ``env`` is a :class:`VectorPDEEnv` (continuous or discrete actions); the
    agent is an :class:`~pde_opt_jax.rl.nets.ActorCriticConv`-style pytree
    whose ``__call__(obs)`` returns ``(dist_params, value)``.

    Returns ``(train_step, optimizer)``; metrics include mean reward, losses,
    entropy, and the fraction of clipped ratios.
    """
    discrete = env.action_type == "discrete"
    if not env.auto_reset:
        raise ValueError(
            "make_ppo_train_step requires an auto_reset=True env: without "
            "auto-reset a terminated env stays terminal forever and keeps "
            "feeding frozen post-terminal transitions into every minibatch."
        )
    if optimizer is None:
        optimizer = optax.chain(
            optax.clip_by_global_norm(config.max_grad_norm),
            optax.adam(config.lr),
        )

    def policy_step(params, obs, key):
        dist, value = params(obs)
        if discrete:
            a, logp = _categorical_sample_logp(key, dist)
        else:
            a, logp = _gaussian_sample_logp(key, *dist)
        return a, logp, value

    a_low = None if discrete else env.action_low
    a_high = None if discrete else env.action_high

    def rollout(params, env_state, key):
        def body(carry, _):
            st, obs, k = carry
            k, ak = jax.random.split(k)
            a, logp, v = policy_step(params, obs, ak)
            # The env sees the DECLARED action space: clip the unbounded
            # Gaussian sample to [action_low, action_high] (SB3 behavior;
            # a tail sample can otherwise drive the PDE stiff and wipe
            # the env).  The surrogate ratio keeps the UNCLIPPED sample's
            # logp, so the policy gradient stays unbiased.
            a_env = a if discrete else jnp.clip(a, a_low, a_high)
            st1, obs1, reward, terminated, _, _ = env._step_impl(st, a_env)
            tr = Transition(obs, a, logp, v, reward, terminated)
            return (st1, obs1, k), tr

        # The obs a step returns IS the next state's observation (the
        # make_rollout carry discipline): each state is observed exactly
        # once — with the fused epilogue, by the Pallas macro itself,
        # killing one full-field obs pass per rollout step.
        obs0 = env.state_to_observation_func(env_state.y)
        (env_state, last_obs, _), traj = jax.lax.scan(
            body, (env_state, obs0, key), None, length=config.rollout_steps
        )
        _, last_value = params(last_obs)
        return env_state, traj, last_value

    def loss_fn(params, batch, adv, ret):
        dist, value = params(batch.obs)
        if discrete:
            logp, ent = _categorical_logp_entropy(dist, batch.action)
        else:
            logp, ent = _gaussian_logp_entropy(*dist, batch.action)
        ratio = jnp.exp(logp - batch.logp)
        clipped = jnp.clip(ratio, 1.0 - config.clip_eps, 1.0 + config.clip_eps)
        pg_loss = -jnp.mean(jnp.minimum(ratio * adv, clipped * adv))
        v_clip = batch.value + jnp.clip(
            value - batch.value, -config.clip_eps, config.clip_eps
        )
        v_loss = 0.5 * jnp.mean(
            jnp.maximum((value - ret) ** 2, (v_clip - ret) ** 2)
        )
        ent_mean = jnp.mean(ent)
        total = pg_loss + config.vf_coef * v_loss - config.ent_coef * ent_mean
        frac_clipped = jnp.mean(
            (jnp.abs(ratio - 1.0) > config.clip_eps).astype(jnp.float32)
        )
        return total, (pg_loss, v_loss, ent_mean, frac_clipped)

    @partial(jax.jit, donate_argnums=(1, 2))
    def train_step(params, opt_state, env_state, key):
        key, rkey, pkey = jax.random.split(key, 3)
        env_state, traj, last_value = rollout(params, env_state, rkey)
        adv, ret = gae(
            traj.reward, traj.value, traj.done, last_value,
            config.gamma, config.lam,
        )
        adv = (adv - adv.mean()) / (adv.std() + 1e-8)

        # flatten (T, B, ...) -> (T*B, ...)
        T = config.rollout_steps
        B = traj.reward.shape[1]
        N = T * B
        flat = jax.tree_util.tree_map(
            lambda x: x.reshape((N,) + x.shape[2:]), traj
        )
        adv_f, ret_f = adv.reshape(N), ret.reshape(N)

        # Ceil-sized minibatches: when N % minibatches != 0 the permutation
        # is cyclically extended, so every sample is used each epoch (a few
        # are seen twice) instead of silently dropping the trailing ones.
        mb = -(-N // config.minibatches)

        # Chunked shuffle when shapes allow (see PPOConfig.shuffle_chunk).
        # Flatten is time-major, so sample i = (t, b) with b = i % B: a chunk
        # of C consecutive samples holds C *distinct same-timestep envs* only
        # when chunk boundaries align to the env axis (B % C == 0).  For
        # small fleets shrink C to gcd(C, B) so chunks never span timesteps
        # — spanning would keep temporally correlated samples of the same
        # env together in every minibatch, silently undoing the shuffle's
        # decorrelation.
        C = math.gcd(config.shuffle_chunk, B)
        chunked = C > 1 and N % (config.minibatches * mb) == 0 and mb % C == 0

        def epoch(carry, ekey):
            params, opt_state = carry
            # ONE gather per epoch into (n_mb, mb, ...) stacks; the
            # minibatch scan then reads contiguous slices instead of
            # re-gathering 1/minibatches of the trajectory every step.
            if chunked:
                perm = jax.random.permutation(ekey, N // C)

                def stack(x):
                    xc = x.reshape((N // C, C) + x.shape[1:])
                    return jnp.take(xc, perm, axis=0).reshape(
                        (config.minibatches, mb) + x.shape[1:]
                    )
            else:
                perm = jax.random.permutation(ekey, N)
                idxs = jnp.resize(perm, (config.minibatches * mb,))
                stack = lambda x: jnp.take(x, idxs, axis=0).reshape(
                    (config.minibatches, mb) + x.shape[1:]
                )
            batches = jax.tree_util.tree_map(stack, flat)
            adv_s, ret_s = stack(adv_f), stack(ret_f)

            def minibatch(carry, batch_adv_ret):
                params, opt_state = carry
                batch, adv_b, ret_b = batch_adv_ret
                (loss, aux), grads = jax.value_and_grad(
                    loss_fn, has_aux=True
                )(params, batch, adv_b, ret_b)
                updates, opt_state = optimizer.update(grads, opt_state, params)
                params = optax.apply_updates(params, updates)
                return (params, opt_state), (loss, *aux)

            (params, opt_state), stats = jax.lax.scan(
                minibatch, (params, opt_state), (batches, adv_s, ret_s)
            )
            return (params, opt_state), stats

        ekeys = jax.random.split(pkey, config.epochs)
        (params, opt_state), stats = jax.lax.scan(
            epoch, (params, opt_state), ekeys
        )
        loss, pg, vl, ent, fc = (s.mean() for s in stats)
        metrics = {
            "reward_mean": traj.reward.mean(),
            "loss": loss, "pg_loss": pg, "v_loss": vl,
            "entropy": ent, "clip_frac": fc,
            "value_mean": traj.value.mean(),
        }
        return params, opt_state, env_state, key, metrics

    return train_step, optimizer


def ppo_train(env, params, config: PPOConfig, num_updates: int,
              key=None, log_fn: Callable = None, mesh=None,
              shard_axis: str = "env", metrics_every: int = 1):
    """Host convenience loop: returns ``(params, metrics_history)``.

    Pass ``mesh`` (e.g. from :func:`pde_opt_jax.parallel.make_mesh`) to run
    the SAME jitted train step data-parallel over a device mesh: the env
    state is sharded over ``shard_axis``, params/optimizer state are
    replicated, and GSPMD inserts the gradient/advantage collectives — no
    explicit shard_map needed for this pure data-parallel workload.
    """
    if key is None:
        key = jax.random.PRNGKey(0)
    train_step, optimizer = make_ppo_train_step(env, config)
    opt_state = optimizer.init(params)
    key, rkey = jax.random.split(key)
    env_state, _ = env.reset(rkey)
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        shard = NamedSharding(mesh, P(shard_axis))
        rep = NamedSharding(mesh, P())
        env_state = jax.tree_util.tree_map(
            lambda x: jax.device_put(x, shard), env_state
        )
        params = jax.tree_util.tree_map(
            lambda x: jax.device_put(x, rep), params
        )
        opt_state = jax.tree_util.tree_map(
            lambda x: jax.device_put(x, rep)
            if hasattr(x, "shape") else x, opt_state,
        )
    history = []
    for update in range(num_updates):
        params, opt_state, env_state, key, metrics = train_step(
            params, opt_state, env_state, key
        )
        # Metrics cross the host boundary as ONE transfer.  Per-key
        # ``float(v)`` would pay one device->host round-trip per metric.
        # Fetch only every
        # ``metrics_every`` updates (and the last) so back-to-back train
        # steps stay enqueued on device.
        if (update + 1) % metrics_every == 0 or update == num_updates - 1:
            metrics = {k: float(v) for k, v in
                       jax.device_get(metrics).items()}
            history.append(metrics)
            if log_fn is not None:
                log_fn(update, metrics)
    return params, history
