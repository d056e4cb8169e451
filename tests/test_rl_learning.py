"""RL learners must LEARN, not merely run.

Each of PPO / DQN / DDPG trains on a small controllable Cahn-Hilliard
κ-control fleet where the spinodal instability is gated by the control:
on a dx = 0.05 box the first Fourier mode grows for κ below ~4e-3 and
decays above it, so with reward = −Var(c) the optimal policy pushes κ UP
(returns ~−3e-5) while pushing it down destroys ~0.2 of return and a
random policy loses ~3e-3.  The trained policy's *deterministic* eval
return must beat the random policy's by a fixed margin — a
finite-but-random-gradient bug cannot pass (the zero-gradient
counterfactual below pins that).

Settings (growth rates from r(q) = 0.25 q² − κ q⁴ at q₁ = 2π/0.8):
Init seeds are chosen so the UNTRAINED deterministic policy sits in the
bad basin (mean action < 0 -> return ~ -0.24): learning requires escaping
it, and the lr=0 counterfactual stays there.  Seeds fixed, ~5-10 s per
learner on CPU.
"""

import pytest
import jax
import jax.numpy as jnp
import numpy as np

import pde_opt_jax as p
from pde_opt_jax.envs.vector_env import VectorPDEEnv

B, N, T = 32, 16, 8
MARGIN = 3e-3        # random ≈ −8e-3; untrained(init) ≈ −0.24
NEAR_OPT = -1e-3     # absolute quality gate: optimal return is ~−3e-5
DX = 0.05


def _make_env(discrete=False, num_envs=B):
    L = DX * N
    domain = p.Domain((N, N), ((-L / 2, L / 2), (-L / 2, L / 2)))
    if discrete:
        asc = {"type": "discrete", "num_actions": 3,
               "action_mapping": {0: [0.0], 1: [1.0], 2: [-1.0]}}
    else:
        asc = {"type": "continuous", "shape": (1,)}
    return VectorPDEEnv(
        equation_type=p.CahnHilliard2DPeriodic,
        domain=domain,
        solver_type=p.SemiImplicitFourierSpectral,
        end_time=0.32, step_dt=0.04, numeric_dt=0.002,
        state_to_observation_func=lambda y: jnp.clip(y * 255.0, 0, 255)
        .astype(jnp.uint8)[..., None, :, :],
        reward_function=lambda y: -jnp.var(y),
        reset_func=lambda domain, key: jnp.clip(
            0.5 + 0.05 * jax.random.normal(key, domain.points), 0.0, 1.0
        ),
        reset_control_value=jnp.float32(0.002),
        update_control_value=lambda off, old: jnp.clip(
            old + 0.003 * off[..., 0], 0.002, 0.012
        ),
        update_control_parameter=lambda old, new: new[..., None, None],
        action_space_config=asc,
        static_equation_parameters={
            "mu": lambda c: c**3 - c,
            "D": lambda c: jnp.ones_like(c),
            "derivs": "fd",
        },
        control_equation_parameter_name="kappa",
        solver_parameters={"A": 0.5},
        num_envs=num_envs,
        auto_reset=True,
        vectorized_control=True,
    )


def _ep_return(env, policy, seed=5):
    """Mean per-env episode return of ``policy`` on a fresh fixed-seed fleet."""
    state, _ = env.reset(jax.random.PRNGKey(seed))
    _, rewards, _ = env.rollout(state, policy, T,
                                key=jax.random.PRNGKey(seed + 100))
    return float(rewards.sum(axis=0).mean())


def _random_continuous(env):
    return lambda o, k: jax.random.uniform(
        k, (env.num_envs, 1), minval=-1.0, maxval=1.0)


@pytest.mark.slow
def test_ppo_learns_kappa_control():
    from pde_opt_jax.rl import ActorCriticConv, PPOConfig, ppo_train

    env = _make_env()
    net = ActorCriticConv(action_dim=1, channels=(4,), features=16,
                          key=jax.random.PRNGKey(1))
    cfg = PPOConfig(rollout_steps=T, epochs=2, minibatches=2, lr=3e-3,
                    ent_coef=0.0)
    params, _ = ppo_train(env, net, cfg, num_updates=30,
                          key=jax.random.PRNGKey(1))

    def det_policy(obs, k):
        (mean, _), _ = params(obs)
        return mean

    def untrained(obs, k):
        (mean, _), _ = net(obs)
        return mean

    trained = _ep_return(env, det_policy)
    random_ = _ep_return(env, _random_continuous(env))
    init_ = _ep_return(env, untrained)
    assert trained > random_ + MARGIN, (trained, random_)
    assert trained > init_ + 0.05, (trained, init_)
    assert trained > NEAR_OPT, trained


@pytest.mark.slow
def test_ppo_zero_gradient_counterfactual_fails_the_margin():
    """lr = 0 (the no-gradient mutation): the SAME training protocol must
    NOT pass the learning assertion — proves the margin is sensitive to
    gradients actually flowing, not to liveness/param-noise."""
    from pde_opt_jax.rl import ActorCriticConv, PPOConfig, ppo_train

    env = _make_env()
    net = ActorCriticConv(action_dim=1, channels=(4,), features=16,
                          key=jax.random.PRNGKey(1))
    cfg = PPOConfig(rollout_steps=T, epochs=2, minibatches=2, lr=0.0,
                    ent_coef=0.0)
    params, _ = ppo_train(env, net, cfg, num_updates=5,
                          key=jax.random.PRNGKey(1))

    def det_policy(obs, k):
        (mean, _), _ = params(obs)
        return mean

    trained = _ep_return(env, det_policy)
    random_ = _ep_return(env, _random_continuous(env))
    assert not (trained > random_ + MARGIN), (trained, random_)


@pytest.mark.slow
def test_dqn_learns_kappa_control():
    from pde_opt_jax.rl import DQNConfig, QNetConv, dqn_train

    env = _make_env(discrete=True)
    qnet = QNetConv(num_actions=3, channels=(4,), features=16,
                    key=jax.random.PRNGKey(0))
    cfg = DQNConfig(capacity=4096, batch_size=256, eps_decay_steps=120,
                    lr=3e-3, gamma=0.8, tau=0.02)
    q2, _ = dqn_train(env, qnet, cfg, num_updates=300,
                      key=jax.random.PRNGKey(1))

    greedy = lambda o, k: jnp.argmax(q2(o), axis=-1)
    untrained = lambda o, k: jnp.argmax(qnet(o), axis=-1)
    rand_d = lambda o, k: jax.random.randint(k, (env.num_envs,), 0, 3)
    trained = _ep_return(env, greedy)
    random_ = _ep_return(env, rand_d)
    init_ = _ep_return(env, untrained)
    assert trained > random_ + MARGIN, (trained, random_)
    assert trained > init_ + 0.05, (trained, init_)
    assert trained > NEAR_OPT, trained


@pytest.mark.slow
def test_ddpg_learns_kappa_control():
    from pde_opt_jax.rl import (
        DDPGConfig,
        DeterministicActorConv,
        QCriticConv,
        ddpg_train,
    )

    env = _make_env()
    actor = DeterministicActorConv(action_dim=1, channels=(4,), features=16,
                                   key=jax.random.PRNGKey(1))
    critic = QCriticConv(action_dim=1, channels=(4,), features=16,
                         key=jax.random.PRNGKey(2))
    cfg = DDPGConfig(capacity=4096, batch_size=128, noise_std=0.5,
                     actor_lr=1e-3, critic_lr=2e-3, gamma=0.9, tau=0.02)
    agent, _ = ddpg_train(env, actor, critic, cfg, num_updates=250,
                          key=jax.random.PRNGKey(2))

    act_p = lambda o, k: agent.actor(o)
    untrained = lambda o, k: actor(o)
    trained = _ep_return(env, act_p)
    random_ = _ep_return(env, _random_continuous(env))
    init_ = _ep_return(env, untrained)
    assert trained > random_ + MARGIN, (trained, random_)
    assert trained > init_ + 0.05, (trained, init_)
    assert trained > NEAR_OPT, trained


@pytest.mark.slow
def test_ppo_mlp_torso_learns_kappa_control():
    """The flattened-MLP policy (dense matmul torso, the
    PPO bench's fast learner) must clear the same learning gate as the
    conv policy."""
    from pde_opt_jax.rl import ActorCriticMLP, PPOConfig, ppo_train

    env = _make_env()
    net = ActorCriticMLP(action_dim=1, in_features=N * N, widths=(64,),
                         features=32, key=jax.random.PRNGKey(1))
    cfg = PPOConfig(rollout_steps=T, epochs=2, minibatches=2, lr=3e-3,
                    ent_coef=0.0)
    params, _ = ppo_train(env, net, cfg, num_updates=30,
                          key=jax.random.PRNGKey(1))

    def det_policy(obs, k):
        (mean, _), _ = params(obs)
        return mean

    trained = _ep_return(env, det_policy)
    random_ = _ep_return(env, _random_continuous(env))
    assert trained > random_ + MARGIN, (trained, random_)
    assert trained > NEAR_OPT, trained


@pytest.mark.slow
def test_ppo_chunked_shuffle_learns():
    """The chunked minibatch shuffle (permute
    contiguous same-timestep env blocks instead of samples) must clear
    the same learning gate — proves decorrelation is preserved.  At this
    scale N=256, minibatches=2, mb=128, chunk=64 => chunking ACTIVE."""
    from pde_opt_jax.rl import ActorCriticMLP, PPOConfig, ppo_train

    env = _make_env()
    net = ActorCriticMLP(action_dim=1, in_features=N * N, widths=(64,),
                         features=32, key=jax.random.PRNGKey(1))
    cfg = PPOConfig(rollout_steps=T, epochs=2, minibatches=2, lr=3e-3,
                    ent_coef=0.0, shuffle_chunk=64)
    params, _ = ppo_train(env, net, cfg, num_updates=30,
                          key=jax.random.PRNGKey(1))

    def det_policy(obs, k):
        (mean, _), _ = params(obs)
        return mean

    trained = _ep_return(env, det_policy)
    random_ = _ep_return(env, _random_continuous(env))
    assert trained > random_ + MARGIN, (trained, random_)
    assert trained > NEAR_OPT, trained
