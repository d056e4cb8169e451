"""Co-located DDPG for continuous-action PDE control envs — fully on-device.

Completes the reference's SB3 agent trio (PPO/DQN/DDPG,
``/root/reference/notebooks/test_pde_RL.ipynb`` cell 6: ``DDPG("CnnPolicy",
env)``) with an on-device learner: deterministic conv actor + state-action
critic, device-resident ring replay shared with DQN
(:func:`pde_opt_jax.rl.dqn.init_replay`), Gaussian exploration noise, and
Polyak-averaged target networks — one jitted train step per env batch,
no host round-trips.

Reference algorithm: Lillicrap et al., arXiv:1509.02971.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import optax

from .dqn import ReplayState, _insert_batch, init_replay

__all__ = ["DDPGConfig", "DDPGState", "make_ddpg_train_step", "ddpg_train"]


@dataclass(frozen=True)
class DDPGConfig:
    capacity: int = 10_000
    batch_size: int = 256
    gamma: float = 0.99
    actor_lr: float = 1e-4
    critic_lr: float = 1e-3
    noise_std: float = 0.1          # exploration noise (action units)
    tau: float = 0.005              # Polyak target update
    learn_start: int = 1


class DDPGState(NamedTuple):
    actor: any
    critic: any
    target_actor: any
    target_critic: any
    actor_opt: any
    critic_opt: any


def make_ddpg_train_step(env, config: DDPGConfig,
                         actor_optimizer=None, critic_optimizer=None):
    """Build ``train_step(agent, replay, env_state, step, key)`` (jitted).

    ``agent`` is a :class:`DDPGState`; actor maps obs to actions of shape
    ``env.action_shape``; critic maps ``(obs, action)`` to a scalar Q.
    """
    if env.action_type != "continuous":
        raise ValueError("DDPG requires a continuous-action env")
    if not env.auto_reset:
        raise ValueError(
            "make_ddpg_train_step requires an auto_reset=True env: without "
            "auto-reset a terminated env stays terminal forever and keeps "
            "pushing frozen post-terminal transitions into the replay."
        )
    if config.capacity < env.num_envs:
        raise ValueError(
            f"replay capacity ({config.capacity}) < num_envs "
            f"({env.num_envs}): the batched ring insert would scatter a "
            "step's transitions to duplicate slots and silently drop "
            f"{env.num_envs - config.capacity} of them."
        )
    if actor_optimizer is None:
        actor_optimizer = optax.adam(config.actor_lr)
    if critic_optimizer is None:
        critic_optimizer = optax.adam(config.critic_lr)
    a_low = env.action_low
    a_high = env.action_high

    def critic_loss(critic, target_q, obs, action):
        q = critic(obs, action)
        return jnp.mean(optax.huber_loss(q, target_q))

    def actor_loss(actor, critic, obs):
        return -jnp.mean(critic(obs, actor(obs)))

    # NOTE: agent is NOT donated — at init actor/target_actor alias the same
    # buffers and donating aliased inputs is an XLA error.
    @partial(jax.jit, donate_argnums=(1, 2, 3))
    def train_step(agent: DDPGState, replay: ReplayState, env_state, obs,
                   step, key):
        key, nkey, skey = jax.random.split(key, 3)
        action = agent.actor(obs)
        noise = config.noise_std * jax.random.normal(
            nkey, action.shape, dtype=jnp.float32
        )
        action = jnp.clip(action + noise, a_low, a_high)
        # Obs-carry discipline (CLAUDE.md): the step's returned obs IS the
        # next state's observation (from the fused epilogue kernel where
        # available) — and the correct replay next_obs (terminated envs
        # mask next_q in the TD target; live envs' obs equals observing
        # y1).
        env_state1, next_obs, reward, terminated, _, _ = env._step_impl(
            env_state, action
        )
        replay = _insert_batch(replay, obs, action, reward, next_obs,
                               terminated)

        idx = jax.random.randint(
            skey, (config.batch_size,), 0, jnp.maximum(replay.size, 1)
        )
        b_obs, b_a = replay.obs[idx], replay.action[idx]
        b_r, b_next = replay.reward[idx], replay.next_obs[idx]
        b_d = replay.done[idx].astype(jnp.float32)
        next_a = agent.target_actor(b_next)
        target_q = b_r + config.gamma * (1.0 - b_d) * jax.lax.stop_gradient(
            agent.target_critic(b_next, next_a)
        )

        learn = step >= config.learn_start
        do_learn = learn.astype(jnp.float32)

        # Keep PRE-warmup optimizer states until learning starts (zeroing
        # only the updates would still advance Adam's moments/count on
        # gradients from a nearly-empty replay).
        def gate_opt(new, old):
            return jax.tree_util.tree_map(
                lambda n, o: jnp.where(learn, n, o) if hasattr(n, "dtype")
                else n,
                new, old,
            )

        c_loss, c_grads = jax.value_and_grad(critic_loss)(
            agent.critic, target_q, b_obs, b_a
        )
        c_updates, critic_opt = critic_optimizer.update(
            c_grads, agent.critic_opt, agent.critic
        )
        critic_opt = gate_opt(critic_opt, agent.critic_opt)
        c_updates = jax.tree_util.tree_map(lambda u: do_learn * u, c_updates)
        critic = optax.apply_updates(agent.critic, c_updates)

        a_loss, a_grads = jax.value_and_grad(actor_loss)(
            agent.actor, critic, b_obs
        )
        a_updates, actor_opt = actor_optimizer.update(
            a_grads, agent.actor_opt, agent.actor
        )
        actor_opt = gate_opt(actor_opt, agent.actor_opt)
        a_updates = jax.tree_util.tree_map(lambda u: do_learn * u, a_updates)
        actor = optax.apply_updates(agent.actor, a_updates)

        polyak = lambda t, o: jax.tree_util.tree_map(
            lambda tt, oo: tt + config.tau * (oo - tt), t, o
        )
        agent = DDPGState(
            actor=actor, critic=critic,
            target_actor=polyak(agent.target_actor, actor),
            target_critic=polyak(agent.target_critic, critic),
            actor_opt=actor_opt, critic_opt=critic_opt,
        )
        metrics = {"critic_loss": c_loss, "actor_loss": a_loss,
                   "reward_mean": reward.mean()}
        return agent, replay, env_state1, next_obs, key, metrics

    return train_step, (actor_optimizer, critic_optimizer)


def ddpg_train(env, actor, critic, config: DDPGConfig, num_updates: int,
               key=None, log_fn=None, metrics_every: int = 1):
    """Host convenience loop: returns ``(DDPGState, metrics_history)``.

    ``metrics_every``: fetch the metrics dict every N updates (and the
    last) — see :func:`ppo_train` for the round-trip rationale.
    """
    if key is None:
        key = jax.random.PRNGKey(0)
    train_step, (a_opt, c_opt) = make_ddpg_train_step(env, config)
    agent = DDPGState(
        actor=actor, critic=critic, target_actor=actor, target_critic=critic,
        actor_opt=a_opt.init(actor), critic_opt=c_opt.init(critic),
    )
    key, rkey = jax.random.split(key)
    env_state, obs = env.reset(rkey)
    replay = init_replay(config, obs.shape[1:], obs.dtype,
                         action_shape=tuple(env.action_shape),
                         action_dtype=jnp.float32)
    history = []
    for step in range(num_updates):
        agent, replay, env_state, obs, key, metrics = train_step(
            agent, replay, env_state, obs, jnp.asarray(step), key
        )
        # ONE device->host transfer for the whole dict (per-key float()
        # would pay one host round-trip per metric).
        if (step + 1) % metrics_every == 0 or step == num_updates - 1:
            metrics = {k: float(v) for k, v in
                       jax.device_get(metrics).items()}
            history.append(metrics)
            if log_fn is not None:
                log_fn(step, metrics)
    return agent, history
