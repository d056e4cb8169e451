"""Rotating-GPE stirring control env: fused/FFT parity + RL learning gate.

The reference can wrap ANY equation —
including ``GPE2DTSRot`` — in its env (``pde_env.py:43-138``) but ships no
solver for the rotating frame; this preset is the 6th env family, driven
by :class:`~pde_opt_jax.ops.steppers.FusedRotatingSplitting`.

Reward calibration at 16 envs / 32² / T=8 / action_gain=2.5 (fixed
seeds, x64): always-stir ≈ +0.198, random ≈ +0.043, trained PPO ≥ +0.147
across seeds — the learning gate requires the trained deterministic
policy to close most of that gap.
"""

import pytest
import jax
import jax.numpy as jnp
import numpy as np

from pde_opt_jax.envs import make_gpe_rot_control_env

B, N, T = 16, 32, 8
MARGIN = 0.05      # random ≈ 0.043, always-stir ≈ 0.198


def _env(solve="fused", num_envs=B):
    return make_gpe_rot_control_env(
        num_envs=num_envs, grid_size=N, substeps=4, end_time=0.32,
        step_dt=0.04, spectral_solve=solve, action_gain=2.5,
    )


def _ep_return(env, policy, seed=5):
    state, _ = env.reset(jax.random.PRNGKey(seed))
    _, rewards, _ = env.rollout(state, policy, T,
                                key=jax.random.PRNGKey(seed + 100))
    return float(rewards.sum(axis=0).mean())


def _up(o, k):
    return jnp.ones((B, 1))


def _random(o, k):
    return jax.random.uniform(k, (B, 1), minval=-1.0, maxval=1.0)


def test_fused_and_fft_paths_agree():
    """Same seeds + same action stream: the matmul ADI stepper and the FFT
    DirectionalSplitting stepper must produce matching fleets."""
    outs = {}
    for solve in ("fused", "fft"):
        env = _env(solve)
        state, _ = env.reset(jax.random.PRNGKey(3))
        run = env.make_rollout(_up, 5)
        state, rewards, _ = run(state, jax.random.PRNGKey(4))
        outs[solve] = (np.asarray(jnp.abs(state.y) ** 2),
                       np.asarray(rewards))
    np.testing.assert_allclose(outs["fused"][0], outs["fft"][0],
                               rtol=0, atol=5e-5)
    np.testing.assert_allclose(outs["fused"][1], outs["fft"][1],
                               rtol=0, atol=1e-4)


def test_stirring_is_the_good_policy():
    env = _env()
    up = _ep_return(env, _up)
    rnd = _ep_return(env, _random)
    assert up > rnd + MARGIN, (up, rnd)


def test_vortex_census_rewards_vortices():
    """A seeded vortex state scores higher than the vortex-free reset
    through the census term (not just L_z shaping)."""
    from pde_opt_jax.utils import initialize_Psi
    from pde_opt_jax.utils.rl import vortex_winding

    env = make_gpe_rot_control_env(
        num_envs=B, grid_size=N, substeps=4, end_time=0.32, step_dt=0.04,
        lz_weight=0.0,  # isolate the census term
    )
    psi_v = initialize_Psi(N, width=10, vortexnumber=1).astype(jnp.complex64)
    dx = float(env.domain.dx[0])
    psi_v = psi_v / jnp.sqrt(jnp.sum(jnp.abs(psi_v) ** 2) * dx * dx)
    rho = jnp.abs(psi_v) ** 2
    w = vortex_winding(psi_v * jax.lax.rsqrt(jnp.max(rho)), amp_thresh=0.05)
    assert int(jnp.sum(jnp.abs(w))) >= 1
    r_vortex = float(env.reward_function(psi_v))
    psi_0 = env.reset_func(env.domain, jax.random.PRNGKey(0))
    r_flat = float(env.reward_function(psi_0))
    assert r_vortex > r_flat + 0.5  # the census term is worth ≥ +1 - noise


@pytest.mark.slow
def test_ppo_learns_to_stir():
    from pde_opt_jax.rl import ActorCriticConv, PPOConfig, ppo_train

    env = _env()
    net = ActorCriticConv(action_dim=1, channels=(4,), features=16,
                          key=jax.random.PRNGKey(1))
    cfg = PPOConfig(rollout_steps=T, epochs=2, minibatches=2, lr=1e-2,
                    ent_coef=0.0)
    params, _ = ppo_train(env, net, cfg, num_updates=40,
                          key=jax.random.PRNGKey(1))

    def det_policy(obs, k):
        (mean, _), _ = params(obs)
        return mean

    trained = _ep_return(env, det_policy)
    rnd = _ep_return(env, _random)
    assert trained > rnd + MARGIN, (trained, rnd)
