"""On-device RL learners: GAE oracle, PPO and DQN train steps end-to-end."""

import jax
import jax.numpy as jnp
import numpy as np

import pde_opt_jax as p
from pde_opt_jax.envs import make_cahn_hilliard_control_env
from pde_opt_jax.envs.vector_env import VectorPDEEnv
from pde_opt_jax.rl import (
    ActorCriticConv,
    DQNConfig,
    PPOConfig,
    QNetConv,
    dqn_train,
    gae,
    init_replay,
    ppo_train,
)
from pde_opt_jax.rl.dqn import _insert_batch


def _gae_numpy(rewards, values, dones, last_value, gamma, lam):
    T, B = rewards.shape
    adv = np.zeros((T, B))
    next_adv = np.zeros(B)
    next_val = np.asarray(last_value)
    for t in reversed(range(T)):
        nonterm = 1.0 - dones[t].astype(float)
        delta = rewards[t] + gamma * next_val * nonterm - values[t]
        next_adv = delta + gamma * lam * nonterm * next_adv
        adv[t] = next_adv
        next_val = values[t]
    return adv, adv + values


def test_gae_matches_numpy_reference():
    rng = np.random.default_rng(0)
    T, B = 7, 3
    rewards = rng.normal(size=(T, B)).astype(np.float32)
    values = rng.normal(size=(T, B)).astype(np.float32)
    dones = rng.random((T, B)) < 0.25
    last_value = rng.normal(size=(B,)).astype(np.float32)
    adv, ret = gae(jnp.asarray(rewards), jnp.asarray(values),
                   jnp.asarray(dones), jnp.asarray(last_value), 0.97, 0.9)
    adv_np, ret_np = _gae_numpy(rewards, values, dones, last_value, 0.97, 0.9)
    np.testing.assert_allclose(np.asarray(adv), adv_np, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(ret), ret_np, rtol=1e-5, atol=1e-5)


def test_ppo_trains_on_ch_control_env():
    env = make_cahn_hilliard_control_env(
        num_envs=8, grid_size=16, substeps=2, vectorized_control=True,
    )
    net = ActorCriticConv(action_dim=1, channels=(4,), features=16,
                          key=jax.random.PRNGKey(0))
    cfg = PPOConfig(rollout_steps=4, epochs=1, minibatches=2, lr=1e-3)
    params, history = ppo_train(env, net, cfg, num_updates=3,
                                key=jax.random.PRNGKey(1))
    for m in history:
        assert np.isfinite(m["loss"]) and np.isfinite(m["reward_mean"])
    # parameters must have moved
    delta = sum(
        float(jnp.sum(jnp.abs(a - b)))
        for a, b in zip(jax.tree_util.tree_leaves(params),
                        jax.tree_util.tree_leaves(net))
    )
    assert delta > 0.0


def _discrete_env(num_envs=6, N=16):
    L = 0.01 * N
    domain = p.Domain((N, N), ((-L / 2, L / 2), (-L / 2, L / 2)))
    return VectorPDEEnv(
        equation_type=p.CahnHilliard2DPeriodic,
        domain=domain,
        solver_type=p.SemiImplicitFourierSpectral,
        end_time=0.04, step_dt=0.01, numeric_dt=0.005,
        state_to_observation_func=lambda y: jnp.clip(y * 255.0, 0, 255)
        .astype(jnp.uint8)[..., None, :, :],
        reward_function=lambda y: -jnp.var(y),
        reset_func=lambda domain, key: jnp.clip(
            0.5 + 0.01 * jax.random.normal(key, domain.points), 0.0, 1.0
        ),
        reset_control_value=jnp.float32(0.004),
        update_control_value=lambda off, old: jnp.clip(
            old + off[..., 0], 0.002, 0.01
        ),
        update_control_parameter=lambda old, new: new,
        action_space_config={
            "type": "discrete",
            "num_actions": 3,
            "action_mapping": {0: [0.0], 1: [0.0005], 2: [-0.0005]},
        },
        static_equation_parameters={
            "mu": lambda c: c**3 - c,
            "D": lambda c: jnp.ones_like(c),
            "derivs": "fd",
        },
        control_equation_parameter_name="kappa",
        solver_parameters={"A": 0.5},
        num_envs=num_envs,
    )


def test_ppo_discrete_actions():
    env = _discrete_env()
    net = ActorCriticConv(action_dim=3, channels=(4,), features=16,
                          discrete=True, key=jax.random.PRNGKey(0))
    cfg = PPOConfig(rollout_steps=3, epochs=1, minibatches=2)
    params, history = ppo_train(env, net, cfg, num_updates=2,
                                key=jax.random.PRNGKey(1))
    assert all(np.isfinite(m["loss"]) for m in history)
    assert all(np.isfinite(m["entropy"]) for m in history)


def test_dqn_trains_on_discrete_env():
    env = _discrete_env()
    qnet = QNetConv(num_actions=3, channels=(4,), features=16,
                    key=jax.random.PRNGKey(0))
    cfg = DQNConfig(capacity=64, batch_size=16, eps_decay_steps=5)
    qnet2, history = dqn_train(env, qnet, cfg, num_updates=4,
                               key=jax.random.PRNGKey(1))
    assert all(np.isfinite(m["loss"]) for m in history)
    # epsilon anneals
    assert history[-1]["epsilon"] < history[0]["epsilon"]
    delta = sum(
        float(jnp.sum(jnp.abs(a - b)))
        for a, b in zip(jax.tree_util.tree_leaves(qnet2),
                        jax.tree_util.tree_leaves(qnet))
    )
    assert delta > 0.0


def test_ddpg_trains_on_continuous_env():
    from pde_opt_jax.rl import (
        DDPGConfig,
        DeterministicActorConv,
        QCriticConv,
        ddpg_train,
    )

    env = make_cahn_hilliard_control_env(
        num_envs=6, grid_size=16, substeps=2, vectorized_control=True,
    )
    actor = DeterministicActorConv(action_dim=1, channels=(4,), features=16,
                                   key=jax.random.PRNGKey(0))
    critic = QCriticConv(action_dim=1, channels=(4,), features=16,
                         key=jax.random.PRNGKey(1))
    cfg = DDPGConfig(capacity=48, batch_size=12)
    agent, history = ddpg_train(env, actor, critic, cfg, num_updates=4,
                                key=jax.random.PRNGKey(2))
    assert all(np.isfinite(m["critic_loss"]) for m in history)
    assert all(np.isfinite(m["actor_loss"]) for m in history)
    delta = sum(
        float(jnp.sum(jnp.abs(a - b)))
        for a, b in zip(jax.tree_util.tree_leaves(agent.actor),
                        jax.tree_util.tree_leaves(actor))
    )
    assert delta > 0.0
    # target nets trail the online nets (Polyak, tau < 1)
    tdelta = sum(
        float(jnp.sum(jnp.abs(a - b)))
        for a, b in zip(jax.tree_util.tree_leaves(agent.target_actor),
                        jax.tree_util.tree_leaves(agent.actor))
    )
    assert tdelta > 0.0


def test_replay_ring_wraparound():
    cfg = DQNConfig(capacity=8, batch_size=4)
    replay = init_replay(cfg, (1, 4, 4))
    obs = jnp.ones((6, 1, 4, 4), jnp.uint8)
    a = jnp.arange(6)
    r = jnp.ones((6,))
    d = jnp.zeros((6,), bool)
    replay = _insert_batch(replay, obs, a, r, obs, d)
    assert int(replay.size) == 6 and int(replay.ptr) == 6
    replay = _insert_batch(replay, 2 * obs, a + 10, r, obs, d)
    assert int(replay.size) == 8 and int(replay.ptr) == 4
    # wrapped slots hold the newest data
    assert int(replay.action[0]) == 12  # second batch idx 2 wrapped to slot 0
    assert int(replay.action[4]) == 4   # first batch idx 4 still present


def test_ppo_data_parallel_over_mesh():
    from pde_opt_jax.parallel import make_mesh

    if len(jax.devices()) < 2:
        import pytest
        pytest.skip("needs multi-device platform")
    mesh = make_mesh(jax.devices(), axis_names=("env",))
    env = make_cahn_hilliard_control_env(
        num_envs=16, grid_size=16, substeps=2, vectorized_control=True,
    )
    net = ActorCriticConv(action_dim=1, channels=(4,), features=16,
                          key=jax.random.PRNGKey(0))
    cfg = PPOConfig(rollout_steps=2, epochs=1, minibatches=2)
    params, history = ppo_train(env, net, cfg, num_updates=2,
                                key=jax.random.PRNGKey(1), mesh=mesh)
    assert all(np.isfinite(m["loss"]) for m in history)
    assert all(np.isfinite(m["reward_mean"]) for m in history)
