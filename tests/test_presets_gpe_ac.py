"""AC and GPE control-fleet presets: physics sanity + RL smoke.

The GPE fleet demonstrates that the batched env layer generalizes beyond
Cahn-Hilliard: complex-as-real state, Strang
split-stepping with per-step renormalization, and a control field (the
optical spot) entering the Hamiltonian as a traced closure — the
reference's GPE-control capability
(``/root/reference/pde_opt/pde_env.py:43-138`` with GPE2DTSControl).
"""

import pytest
import jax
import jax.numpy as jnp
import numpy as np

from pde_opt_jax.envs.presets import (
    make_allen_cahn_control_env,
    make_gpe_control_env,
)
from pde_opt_jax.rl import ActorCriticConv, PPOConfig, ppo_train


def test_ac_env_step_finite_and_moves():
    env = make_allen_cahn_control_env(num_envs=4, grid_size=16, substeps=2)
    state, obs = env.reset(jax.random.PRNGKey(0))
    assert obs.shape == (4, 1, 16, 16) and obs.dtype == jnp.uint8
    actions = jnp.zeros((4, 1), jnp.float32)
    state2, obs2, reward, term, trunc, info = env._step_impl(state, actions)
    assert bool(jnp.isfinite(state2.y).all())
    assert reward.shape == (4,)
    assert float(jnp.max(jnp.abs(state2.y - state.y))) > 0.0
    assert not bool(info["diverged"].any())


def test_ac_env_fft_solver_variant():
    env = make_allen_cahn_control_env(
        num_envs=4, grid_size=16, substeps=2, spectral_solve="fft"
    )
    state, _ = env.reset(jax.random.PRNGKey(1))
    actions = jnp.zeros((4, 1), jnp.float32)
    state2, *_ = env._step_impl(state, actions)
    assert bool(jnp.isfinite(state2.y).all())


def test_gpe_env_norm_preserved_and_control_matters():
    env = make_gpe_control_env(num_envs=4, grid_size=32, substeps=3)
    state, obs = env.reset(jax.random.PRNGKey(2))
    assert state.y.shape == (4, 32, 32, 2)
    assert obs.shape == (4, 1, 32, 32)
    dx = float(env.domain.dx[0])

    def norms(y):
        rho = y[..., 0] ** 2 + y[..., 1] ** 2
        return jnp.sum(rho, axis=(-2, -1)) * dx * dx

    np.testing.assert_allclose(np.asarray(norms(state.y)), 1.0, rtol=1e-5)

    # Zero action: free evolution; strong action: light spot on.
    a0 = jnp.zeros((4, 1), jnp.float32)
    a1 = jnp.ones((4, 1), jnp.float32)
    s_off, *_ = env._step_impl(state, a0)
    state_b, _ = env.reset(jax.random.PRNGKey(2))
    s_on, *_ = env._step_impl(state_b, a1)
    assert bool(jnp.isfinite(s_off.y).all()) and bool(jnp.isfinite(s_on.y).all())
    # Per-step renormalization keeps every env on the unit-norm manifold.
    np.testing.assert_allclose(np.asarray(norms(s_off.y)), 1.0, rtol=1e-4)
    # The control field must actually change the dynamics.
    assert float(jnp.max(jnp.abs(s_on.y - s_off.y))) > 1e-6


def test_gpe_env_rollout_and_reward_signal():
    env = make_gpe_control_env(num_envs=4, grid_size=32, substeps=2)
    state, _ = env.reset(jax.random.PRNGKey(3))

    def policy(obs, key):
        return jax.random.uniform(key, (4, 1), minval=-1.0, maxval=1.0)

    state, rewards, terms = env.rollout(state, policy, 10)
    assert rewards.shape == (10, 4)
    assert bool(jnp.isfinite(rewards).all())
    # reward = -density inside the spot: strictly negative for a centered
    # condensate overlapping the spot.
    assert float(rewards.max()) < 0.0


@pytest.mark.slow
def test_ppo_trains_on_gpe_control_env():
    env = make_gpe_control_env(num_envs=6, grid_size=16, substeps=2)
    net = ActorCriticConv(action_dim=1, channels=(4,), features=16,
                          key=jax.random.PRNGKey(4))
    cfg = PPOConfig(rollout_steps=4, epochs=1, minibatches=2, lr=1e-3)
    params, history = ppo_train(env, net, cfg, num_updates=2,
                                key=jax.random.PRNGKey(5))
    for m in history:
        assert np.isfinite(m["loss"]) and np.isfinite(m["reward_mean"])
    delta = sum(
        float(jnp.sum(jnp.abs(a - b)))
        for a, b in zip(jax.tree_util.tree_leaves(params),
                        jax.tree_util.tree_leaves(net))
    )
    assert delta > 0.0


def test_strang_fast_evolve_matches_per_step_physics():
    """Midpoint (merged-halves) Strang vs per-step reference semantics:
    both integrate the same PDE; at small dt they agree to O(dt^2)."""
    from pde_opt_jax.grid import Domain
    from pde_opt_jax.models.gross_pitaevskii import GPE2DTSControl
    from pde_opt_jax.ops.steppers import StrangSplitting
    from pde_opt_jax.utils.compat import prepare_solver_params

    N, L = 32, 16.0
    domain = Domain((N, N), ((-L / 2, L / 2), (-L / 2, L / 2)))
    eq = GPE2DTSControl(domain, k=50.0, e=0.0,
                        lights=lambda t, x, y: 0.0 * x, kinetic=True)
    base = prepare_solver_params(StrangSplitting, {"time_scale": 1.0}, eq)
    slow = StrangSplitting(**base)
    fast = StrangSplitting(**{**base, "fast_evolve": True})

    X, Y = (jnp.asarray(m) for m in domain.mesh())
    psi = jnp.exp(-(X**2 + Y**2) / 4.0)
    dx = float(domain.dx[0])
    psi = psi / jnp.sqrt(jnp.sum(psi**2) * dx * dx)
    y0 = jnp.stack([psi, jnp.zeros_like(psi)], axis=-1).astype(jnp.float32)

    n, dt = 20, 5e-4
    y_slow = slow.evolve(eq.rhs, y0, 0.0, dt, n)
    y_fast = fast.evolve(eq.rhs, y0, 0.0, dt, n)
    # Same norm manifold...
    for y in (y_slow, y_fast):
        norm = float(jnp.sum(y[..., 0] ** 2 + y[..., 1] ** 2) * dx * dx)
        np.testing.assert_allclose(norm, 1.0, rtol=1e-4)
    # ...and the same trajectory to splitting-error order.
    err = float(jnp.max(jnp.abs(y_fast - y_slow)))
    scale = float(jnp.max(jnp.abs(y_slow)))
    assert err < 0.02 * scale, (err, scale)


@pytest.mark.slow
def test_gpe_fused_env_grad_flows_to_control():
    """Pathwise gradient through the GPE Strang step reaches the action."""
    env = make_gpe_control_env(num_envs=2, grid_size=16, substeps=2)
    state, _ = env.reset(jax.random.PRNGKey(10))

    def loss(actions):
        s2, _, reward, *_ = env._step_impl(state, actions)
        return -jnp.sum(reward)

    g = jax.grad(loss)(jnp.full((2, 1), 0.5, jnp.float32))
    assert bool(jnp.isfinite(g).all())
    assert float(jnp.max(jnp.abs(g))) > 0.0


class TestButlerVolmerPreset:
    def _env(self, num_envs=4, **kw):
        from pde_opt_jax.envs import make_butler_volmer_control_env

        return make_butler_volmer_control_env(
            num_envs=num_envs, grid_size=16, substeps=4, **kw)

    def test_rollout_finite_and_charging(self):
        env = self._env()
        state, obs = env.reset(jax.random.PRNGKey(0))
        assert obs.shape == (4, 1, 16, 16) and obs.dtype == jnp.uint8
        fill0 = float(state.y.mean())
        policy = lambda o, k: jnp.zeros((4, 1))
        state, rewards, terms = env.rollout(state, policy, 10,
                                            key=jax.random.PRNGKey(1))
        assert bool(jnp.isfinite(rewards).all())
        # Constant current at Crate=1 charges the particle.
        assert float(state.y.mean()) > fill0

    def test_crate_control_affects_charging_rate(self):
        env = self._env(num_envs=2, auto_reset=False)
        state, _ = env.reset(jax.random.PRNGKey(0))
        y = state.y.at[1].set(state.y[0])
        state = state._replace(
            y=y, control_value=state.control_value.at[1].set(
                state.control_value[0]))
        # Env 0 pushes Crate up, env 1 pushes it down -> env 0 fills faster.
        acts = jnp.array([[1.0], [-1.0]])
        for _ in range(4):
            state, *_ = env.step(state, acts)
        assert float(state.y[0].mean()) > float(state.y[1].mean())

    def test_per_env_global_integrals_stay_per_env(self):
        """The constant-current closure must not couple envs: two envs with
        different states must each satisfy their own d<c>/dt = Crate/area."""
        env = self._env(num_envs=2, auto_reset=False)
        state, _ = env.reset(jax.random.PRNGKey(2))
        m0 = np.asarray(state.y.mean(axis=(-2, -1)))
        state, *_ = env.step(state, jnp.zeros((2, 1)))
        m1 = np.asarray(state.y.mean(axis=(-2, -1)))
        # Crate=1, area=1 -> d<c>/dt = 1 per env over step_dt.
        np.testing.assert_allclose((m1 - m0) / env.step_dt, 1.0, rtol=0.05)


@pytest.mark.parametrize("make, kw", [
    ("make_allen_cahn_control_env", {"spectral_solve": "fused"}),
    ("make_gpe_control_env", {"spectral_solve": "fused"}),
    ("make_butler_volmer_control_env", {"method": "fused"}),
    ("make_sbm_butler_volmer_control_env", {"method": "fused"}),
])
def test_presets_reject_unknown_solver(make, kw):
    """These fleets have one (XLA) solve path; any other name raises."""
    from pde_opt_jax import envs

    with pytest.raises(ValueError, match="unknown"):
        getattr(envs, make)(num_envs=2, grid_size=16, substeps=2, **kw)
