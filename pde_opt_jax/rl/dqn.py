"""Co-located DQN for discrete-action PDE control envs — fully on-device.

Capability parity with the reference's SB3 ``DQN("CnnPolicy", env)`` workflow
(``/root/reference/notebooks/test_pde_RL.ipynb`` cell 5), rebuilt on device:
the replay buffer is a device-resident ring of arrays (uint8 observations),
and one jitted ``train_step`` = act epsilon-greedily with the whole env
batch, insert the batch transition, sample a minibatch, take a double-DQN
TD step, and Polyak-update the target network.  No host round-trips.

Reference algorithm: Mnih et al., Nature 518 (2015); double-DQN target from
van Hasselt et al., arXiv:1509.06461.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import optax

__all__ = ["DQNConfig", "ReplayState", "init_replay", "make_dqn_train_step",
           "dqn_train"]


@dataclass(frozen=True)
class DQNConfig:
    capacity: int = 10_000          # transitions (flattened over envs)
    batch_size: int = 256
    gamma: float = 0.99
    lr: float = 1e-3
    eps_start: float = 1.0
    eps_end: float = 0.05
    eps_decay_steps: int = 500
    tau: float = 0.01               # Polyak target update
    learn_start: int = 1            # updates before learning begins


class ReplayState(NamedTuple):
    obs: jax.Array        # (capacity, *obs_shape) uint8
    action: jax.Array     # (capacity,) int32
    reward: jax.Array     # (capacity,) f32
    next_obs: jax.Array   # (capacity, *obs_shape) uint8
    done: jax.Array       # (capacity,) bool
    ptr: jax.Array        # ()
    size: jax.Array       # ()


def init_replay(config, obs_shape, obs_dtype=jnp.uint8,
                action_shape=(), action_dtype=jnp.int32):
    """Device-resident ring replay; shared by DQN (int actions) and DDPG
    (float action vectors)."""
    cap = config.capacity
    return ReplayState(
        obs=jnp.zeros((cap, *obs_shape), obs_dtype),
        action=jnp.zeros((cap, *action_shape), action_dtype),
        reward=jnp.zeros((cap,), jnp.float32),
        next_obs=jnp.zeros((cap, *obs_shape), obs_dtype),
        done=jnp.zeros((cap,), bool),
        ptr=jnp.zeros((), jnp.int32),
        size=jnp.zeros((), jnp.int32),
    )


def _insert_batch(replay: ReplayState, obs, action, reward, next_obs, done):
    """Ring-insert a whole env batch of transitions (B consecutive slots)."""
    B = obs.shape[0]
    cap = replay.obs.shape[0]
    # contiguous wrap-around via modular scatter indices
    idx = (replay.ptr + jnp.arange(B)) % cap
    return replay._replace(
        obs=replay.obs.at[idx].set(obs),
        action=replay.action.at[idx].set(action.astype(replay.action.dtype)),
        reward=replay.reward.at[idx].set(reward.astype(jnp.float32)),
        next_obs=replay.next_obs.at[idx].set(next_obs),
        done=replay.done.at[idx].set(done),
        ptr=(replay.ptr + B) % cap,
        size=jnp.minimum(replay.size + B, cap),
    )


def make_dqn_train_step(env, config: DQNConfig, optimizer=None):
    """Build ``train_step(qnet, target, opt_state, replay, env_state, step, key)``.

    ``qnet(obs) -> (B, num_actions)``.  Returns the jitted step and the
    optimizer.  Epsilon anneals linearly over ``eps_decay_steps`` updates.
    """
    if env.action_type != "discrete":
        raise ValueError("DQN requires a discrete-action env")
    if not env.auto_reset:
        raise ValueError(
            "make_dqn_train_step requires an auto_reset=True env: without "
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
    num_actions = env.num_actions
    if optimizer is None:
        optimizer = optax.adam(config.lr)

    def epsilon(step):
        frac = jnp.clip(step / config.eps_decay_steps, 0.0, 1.0)
        return config.eps_start + frac * (config.eps_end - config.eps_start)

    def td_loss(qnet, target, batch_obs, batch_a, batch_r, batch_next, batch_d):
        q = qnet(batch_obs)
        q_a = jnp.take_along_axis(q, batch_a[:, None], axis=1)[:, 0]
        # double DQN: argmax under online net, value under target net
        next_a = jnp.argmax(qnet(batch_next), axis=1)
        next_q = jnp.take_along_axis(
            target(batch_next), next_a[:, None], axis=1
        )[:, 0]
        tgt = batch_r + config.gamma * next_q * (1.0 - batch_d.astype(jnp.float32))
        return jnp.mean(optax.huber_loss(q_a, jax.lax.stop_gradient(tgt)))

    @partial(jax.jit, donate_argnums=(2, 3, 4, 5))
    def train_step(qnet, target, opt_state, replay, env_state, obs, step,
                   key):
        # Distinct keys for the random-action draw and the explore coin:
        # reusing one key correlates WHETHER an env explores with WHICH
        # action it explores (same threefry bits feed both draws).
        key, akey, ekey, skey = jax.random.split(key, 4)
        q = qnet(obs)
        greedy = jnp.argmax(q, axis=1)
        rand = jax.random.randint(akey, greedy.shape, 0, num_actions)
        explore = (
            jax.random.uniform(ekey, greedy.shape) < epsilon(step)
        )
        actions = jnp.where(explore, rand, greedy)
        # Obs-carry discipline (CLAUDE.md): the step's returned obs IS the
        # next state's observation — with the fused epilogue it comes from
        # the Pallas kernel itself; re-observing here would pay an extra
        # full-field pass.  As the replay's next_obs it is also correct:
        # on terminated envs the TD target masks next_q anyway, and on
        # live envs it equals observing y1.
        env_state1, next_obs, reward, terminated, _, _ = env._step_impl(
            env_state, actions
        )
        replay = _insert_batch(replay, obs, actions, reward, next_obs,
                               terminated)

        idx = jax.random.randint(
            skey, (config.batch_size,), 0, jnp.maximum(replay.size, 1)
        )
        loss, grads = jax.value_and_grad(td_loss)(
            qnet, target,
            replay.obs[idx], replay.action[idx], replay.reward[idx],
            replay.next_obs[idx], replay.done[idx],
        )
        do_learn = step >= config.learn_start
        updates, new_opt_state = optimizer.update(grads, opt_state, qnet)
        updates = jax.tree_util.tree_map(
            lambda u: jnp.where(do_learn, u, jnp.zeros_like(u)), updates
        )
        # Keep the PRE-warmup optimizer state until learning starts:
        # zeroing only the updates would still advance Adam's moments and
        # bias-correction count on gradients from a nearly-empty replay.
        opt_state = jax.tree_util.tree_map(
            lambda n, o: jnp.where(do_learn, n, o) if hasattr(n, "dtype")
            else n,
            new_opt_state, opt_state,
        )
        qnet = optax.apply_updates(qnet, updates)
        target = jax.tree_util.tree_map(
            lambda t, o: t + config.tau * (o - t), target, qnet
        )
        metrics = {"loss": loss, "reward_mean": reward.mean(),
                   "epsilon": epsilon(step), "q_mean": q.mean()}
        return (qnet, target, opt_state, replay, env_state1, next_obs, key,
                metrics)

    return train_step, optimizer


def dqn_train(env, qnet, config: DQNConfig, num_updates: int, key=None,
              log_fn=None, metrics_every: int = 1):
    """Host convenience loop: returns ``(qnet, metrics_history)``.

    ``metrics_every``: fetch the metrics dict every N updates (and the
    last) — each device_get is a host round-trip, so per-update fetches
    serialize back-to-back train steps (same pattern
    as :func:`ppo_train`).
    """
    if key is None:
        key = jax.random.PRNGKey(0)
    train_step, optimizer = make_dqn_train_step(env, config)
    opt_state = optimizer.init(qnet)
    target = qnet
    key, rkey = jax.random.split(key)
    env_state, obs = env.reset(rkey)
    replay = init_replay(config, obs.shape[1:], obs.dtype)
    history = []
    for step in range(num_updates):
        (qnet, target, opt_state, replay, env_state, obs, key,
         metrics) = train_step(
            qnet, target, opt_state, replay, env_state, obs,
            jnp.asarray(step), key,
        )
        # ONE device->host transfer for the whole dict (per-key float()
        # would pay one host round-trip per metric).
        if (step + 1) % metrics_every == 0 or step == num_updates - 1:
            metrics = {k: float(v) for k, v in
                       jax.device_get(metrics).items()}
            history.append(metrics)
            if log_fn is not None:
                log_fn(step, metrics)
    return qnet, history
