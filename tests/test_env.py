"""RL environment tests: batched core semantics, auto-reset, gym adapters."""

import gymnasium as gym
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import pde_opt_jax as p
from pde_opt_jax.envs import AdvectionDiffusionEnv, PDEEnv, VectorPDEEnv


def _ch_env(num_envs=8, end_time=0.05, step_dt=0.01, auto_reset=True):
    N = 16
    L = 0.01 * N
    domain = p.Domain((N, N), ((-L / 2, L / 2), (-L / 2, L / 2)))
    return VectorPDEEnv(
        equation_type=p.CahnHilliard2DPeriodic,
        domain=domain,
        solver_type=p.SemiImplicitFourierSpectral,
        end_time=end_time,
        step_dt=step_dt,
        numeric_dt=0.001,
        state_to_observation_func=lambda y: jnp.clip(y * 255, 0, 255).astype(
            jnp.uint8
        )[..., None, :, :],
        reward_function=lambda y: -jnp.var(y),
        reset_func=lambda domain, key: jnp.clip(
            0.5 + 0.01 * jax.random.normal(key, domain.points), 0.0, 1.0
        ),
        reset_control_value=jnp.float32(0.002),
        update_control_value=lambda off, old: jnp.clip(
            old + 0.0005 * off[..., 0], 1e-4, 0.01
        ),
        update_control_parameter=lambda old, new: new,
        action_space_config={"type": "continuous", "shape": (1,)},
        static_equation_parameters={
            "mu": lambda c: c**3 - c,
            "D": lambda c: jnp.ones_like(c),
            "derivs": "fd",
        },
        control_equation_parameter_name="kappa",
        solver_parameters={"A": 0.5},
        num_envs=num_envs,
        auto_reset=auto_reset,
    )


def test_vector_env_shapes_and_determinism():
    env = _ch_env(num_envs=4)
    state, obs = env.reset(jax.random.PRNGKey(0))
    assert obs.shape == (4, 1, 16, 16) and obs.dtype == jnp.uint8
    acts = jnp.zeros((4, 1))
    s1, o1, r1, te1, tr1, _ = env.step(state, acts)
    # Same key → same trajectory.
    state2, _ = env.reset(jax.random.PRNGKey(0))
    s2, o2, r2, te2, tr2, _ = env.step(state2, acts)
    np.testing.assert_array_equal(np.asarray(o1), np.asarray(o2))
    np.testing.assert_array_equal(np.asarray(r1), np.asarray(r2))


def test_vector_env_independent_envs():
    """Different PRNG keys produce different per-env initial states."""
    env = _ch_env(num_envs=4)
    state, obs = env.reset(jax.random.PRNGKey(0))
    assert not np.array_equal(np.asarray(state.y[0]), np.asarray(state.y[1]))


def test_control_affects_dynamics():
    env = _ch_env(num_envs=2)
    state, _ = env.reset(jax.random.PRNGKey(0))
    # Make both envs identical, then apply different actions.
    y = state.y.at[1].set(state.y[0])
    state = state._replace(y=y, control_value=state.control_value.at[1].set(
        state.control_value[0]))
    acts = jnp.array([[1.0], [-1.0]])
    s1, *_ = env.step(state, acts)
    assert not np.array_equal(np.asarray(s1.y[0]), np.asarray(s1.y[1]))


def test_auto_reset():
    env = _ch_env(num_envs=3, end_time=0.02, step_dt=0.01)  # 2 steps/episode
    state, _ = env.reset(jax.random.PRNGKey(0))
    acts = jnp.zeros((3, 1))
    state, o, r, te, tr, info = env.step(state, acts)
    assert not bool(te.any())
    state, o, r, te, tr, info = env.step(state, acts)
    assert bool(te.all())
    # After auto-reset the clock is back at zero and state is fresh.
    np.testing.assert_array_equal(np.asarray(state.t), np.zeros(3, np.float32))
    assert "final_observation" in info


def test_no_auto_reset_done_flag():
    env = _ch_env(num_envs=2, end_time=0.02, step_dt=0.01, auto_reset=False)
    state, _ = env.reset(jax.random.PRNGKey(0))
    acts = jnp.zeros((2, 1))
    state, *_ = env.step(state, acts)
    state, o, r, te, tr, _ = env.step(state, acts)
    assert bool(te.all())
    assert np.allclose(np.asarray(state.t), 0.02)


def test_rollout_matches_stepping():
    env = _ch_env(num_envs=2)
    state, _ = env.reset(jax.random.PRNGKey(0))
    zero_policy = lambda obs, k: jnp.zeros((2, 1))
    final, rewards, terms = env.rollout(state, zero_policy, 3,
                                        key=jax.random.PRNGKey(5))
    state2, _ = env.reset(jax.random.PRNGKey(0))
    rs = []
    for _ in range(3):
        state2, o, r, te, tr, _ = env.step(state2, jnp.zeros((2, 1)))
        rs.append(np.asarray(r))
    np.testing.assert_allclose(np.asarray(rewards), np.stack(rs), rtol=1e-6)


def test_gym_pde_env_api():
    N = 16
    L = 0.01 * N
    domain = p.Domain((N, N), ((-L / 2, L / 2), (-L / 2, L / 2)))
    env = PDEEnv(
        equation_type=p.CahnHilliard2DPeriodic,
        domain=domain,
        solver_type=p.SemiImplicitFourierSpectral,
        end_time=0.03,
        step_dt=0.01,
        numeric_dt=0.001,
        state_to_observation_func=lambda y: np.clip(
            np.asarray(y) * 255, 0, 255
        ).astype(np.uint8)[None],
        reward_function=lambda y: float(-jnp.var(y)),
        reset_func=lambda domain, seed=0: jnp.clip(
            0.5 + 0.01 * jax.random.normal(jax.random.PRNGKey(seed), domain.points),
            0.0, 1.0,
        ),
        reset_control_value=0.002,
        update_control_value=lambda off, old: float(
            np.clip(old + 0.0005 * np.asarray(off)[0], 1e-4, 0.01)
        ),
        update_control_parameter=lambda old, new: new,
        action_space_config={"type": "continuous", "shape": (1,)},
        static_equation_parameters={
            "mu": lambda c: c**3 - c,
            "D": lambda c: jnp.ones_like(c),
            "derivs": "fd",
        },
        control_equation_parameter_name="kappa",
        solver_parameters={"A": 0.5},
    )
    obs, info = env.reset(seed=0)
    assert obs.shape == (1, N, N) and obs.dtype == np.uint8
    assert env.observation_space.contains(obs)
    done = False
    steps = 0
    while not done:
        obs, reward, done, truncated, info = env.step(env.action_space.sample())
        steps += 1
        assert isinstance(reward, float)
    assert steps == 3  # end_time / step_dt


def test_gym_registration_and_advection_diffusion_env():
    N = 16
    L = 0.02 * N
    domain = p.Domain((N, N), ((-L / 2, L / 2), (-L / 2, L / 2)))
    env = gym.make(
        "AdvectionDiffusion-v0",
        reset_func=lambda domain, seed=0: 0.5 * jnp.ones(domain.points)
        + 0.01 * jax.random.normal(jax.random.PRNGKey(seed), domain.points),
        diffusion_coefficient=0.1,
        max_control_step=0.1,
        end_time=0.1,
        step_dt=0.05,
        numeric_dt=0.01,
        domain=domain,
        field_dim=1,
        reward_function=lambda x: float(np.var(np.asarray(x))),
        discrete_action_space=True,
    )
    obs, info = env.reset(seed=0)
    assert obs.shape == (1, N, N)
    obs, reward, terminated, truncated, info = env.step(1)
    assert obs.shape == (1, N, N)
    assert np.isfinite(reward)
    obs, reward, terminated, truncated, info = env.step(3)
    assert terminated


def test_discrete_action_vector_env():
    N = 16
    L = 0.01 * N
    domain = p.Domain((N, N), ((-L / 2, L / 2), (-L / 2, L / 2)))
    env = VectorPDEEnv(
        equation_type=p.CahnHilliard2DPeriodic,
        domain=domain,
        solver_type=p.SemiImplicitFourierSpectral,
        end_time=0.02, step_dt=0.01, numeric_dt=0.001,
        state_to_observation_func=lambda y: y,
        reward_function=lambda y: -jnp.var(y),
        reset_func=lambda domain, key: jnp.clip(
            0.5 + 0.01 * jax.random.normal(key, domain.points), 0.0, 1.0
        ),
        reset_control_value=jnp.float32(0.002),
        update_control_value=lambda off, old: jnp.clip(
            old + off[..., 0], 1e-4, 0.01
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
        num_envs=4,
    )
    state, obs = env.reset(jax.random.PRNGKey(0))
    acts = jnp.array([0, 1, 2, 1])
    state, obs, r, te, tr, _ = env.step(state, acts)
    cv = np.asarray(state.control_value)
    np.testing.assert_allclose(cv[0], 0.002, rtol=1e-6)
    np.testing.assert_allclose(cv[1], 0.0025, rtol=1e-6)
    np.testing.assert_allclose(cv[2], 0.0015, rtol=1e-6)


def test_divergence_detection_and_reset():
    """A non-finite env terminates, resets, and never leaks NaN (SURVEY §5)."""
    env = _ch_env(num_envs=3)
    state, _ = env.reset(jax.random.PRNGKey(0))
    state = state._replace(y=state.y.at[1].set(jnp.nan))
    state2, obs, r, te, tr, info = env.step(state, jnp.zeros((3, 1)))
    assert bool(te[1]) and bool(info["diverged"][1])
    assert float(r[1]) == 0.0
    assert bool(jnp.isfinite(state2.y).all())
    assert not bool(te[0]) and not bool(te[2])
    assert bool(jnp.isfinite(jnp.asarray(obs, jnp.float32)).all())


def test_flagship_preset_long_rollout_stays_finite():
    """The bench preset must be numerically stable under random actions."""
    from pde_opt_jax.envs import make_cahn_hilliard_control_env

    env = make_cahn_hilliard_control_env(
        num_envs=8, grid_size=32, substeps=10, end_time=10.0
    )
    state, _ = env.reset(jax.random.PRNGKey(0))
    state, rewards, dones = env.rollout(
        state, lambda o, k: env.sample_actions(k), 100
    )
    assert bool(jnp.isfinite(rewards).all())
