"""Fused env-epilogue path: kernel stats/obs + env-step parity.

The epilogue contract (``ops/cas_spectral.make_ch_cas_fused_macro`` with
``epilogue=``) replaces the XLA env step's separate reward/isfinite/obs
full-field passes (reference per-step obs/reward: ``pde_env.py:305-317``)
with outputs of the SAME kernel.  These tests gate:

* stats = centered moments + finite count of the advanced field;
* obs bitwise-equals the preset's XLA observation (ds=1 and pooled);
* env-step parity: fused-epilogue env == plain fused env (fields bitwise,
  reward to f32 rounding, terminated/diverged exact);
* gradients through (u1, stats) equal the plain macro's custom VJP;
* divergence: a NaN env flags diverged and auto-resets.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pde_opt_jax.envs.presets import make_cahn_hilliard_control_env
from pde_opt_jax.ops.cas_spectral import make_ch_cas_fused_macro

MU = lambda c: c**3 - c  # noqa: E731


def _ep_macro(H, hx, hy, A, dt, n, obs_downsample=1, stats_center=0.0,
              **kw):
    return make_ch_cas_fused_macro(
        MU, H, H, hx, hy, A, dt, n,
        epilogue={"obs_downsample": obs_downsample,
                  "stats_center": stats_center}, **kw,
    )


def _setup(B=8, H=16, seed=0):
    u = 0.5 + 0.05 * jax.random.normal(
        jax.random.PRNGKey(seed), (B, H, H), jnp.float32
    )
    kap = jnp.linspace(2e-3, 8e-3, B).astype(jnp.float32)
    return u, kap


def test_epilogue_stats_and_obs_match_plain_macro():
    B, H = 8, 16
    u, kap = _setup(B, H)
    m0 = make_ch_cas_fused_macro(
        MU, H, H, 0.01, 0.01, 1.0, 1e-4, 5, mats_dtype=jnp.float32
    )
    mep = _ep_macro(H, 0.01, 0.01, 1.0, 1e-4, 5, stats_center=0.5,
                    mats_dtype=jnp.float32)
    u1 = m0(u, kap)
    u1e, stats, obs = mep(u, kap)
    assert jnp.array_equal(u1, u1e)
    np.testing.assert_allclose(
        np.asarray(stats[:, 0]), np.asarray((u1 - 0.5).sum((-2, -1))),
        atol=1e-4,
    )
    np.testing.assert_allclose(
        np.asarray(stats[:, 1]), np.asarray(((u1 - 0.5) ** 2).sum((-2, -1))),
        atol=1e-4,
    )
    np.testing.assert_array_equal(np.asarray(stats[:, 2]), H * H)
    obs_ref = jnp.clip(u1 * 255.0, 0, 255).astype(jnp.uint8)
    assert obs.dtype == jnp.uint8
    assert jnp.array_equal(obs, obs_ref)


def test_epilogue_pooled_obs_matches_mean_pool():
    B, H, ds = 8, 32, 2
    u, kap = _setup(B, H, seed=3)
    mep = _ep_macro(H, 0.01, 0.01, 1.0, 1e-4, 5, obs_downsample=ds,
                    mats_dtype=jnp.float32)
    m0 = make_ch_cas_fused_macro(
        MU, H, H, 0.01, 0.01, 1.0, 1e-4, 5, mats_dtype=jnp.float32
    )
    u1 = m0(u, kap)
    _, _, obs = mep(u, kap)
    pooled = u1.reshape(B, H // ds, ds, H // ds, ds).mean(axis=(-3, -1))
    obs_ref = jnp.clip(pooled * 255.0, 0, 255).astype(jnp.uint8)
    diff = jnp.abs(obs.astype(jnp.int32) - obs_ref.astype(jnp.int32))
    # matmul-pooling vs reshape-mean: at most 1 uint8 LSB of rounding skew
    assert int(diff.max()) <= 1


def test_epilogue_gradients_equal_plain_macro():
    B, H = 8, 16
    u, kap = _setup(B, H, seed=5)
    m0 = make_ch_cas_fused_macro(
        MU, H, H, 0.01, 0.01, 1.0, 1e-4, 5, mats_dtype=jnp.float32
    )
    mep = _ep_macro(H, 0.01, 0.01, 1.0, 1e-4, 5, stats_center=0.5,
                    mats_dtype=jnp.float32)

    def loss_ep(kk, uu):
        y, s, _ = mep(uu, kk)
        return jnp.sum(y**2) + 1.5 * jnp.sum(s[:, 0]) + 0.5 * jnp.sum(s[:, 1])

    def loss_pl(kk, uu):
        y = m0(uu, kk)
        return (jnp.sum(y**2) + 1.5 * jnp.sum(y - 0.5)
                + 0.5 * jnp.sum((y - 0.5) ** 2))

    g1k, g1u = jax.grad(loss_ep, argnums=(0, 1))(kap, u)
    g2k, g2u = jax.grad(loss_pl, argnums=(0, 1))(kap, u)
    np.testing.assert_array_equal(np.asarray(g1k), np.asarray(g2k))
    np.testing.assert_array_equal(np.asarray(g1u), np.asarray(g2u))


@pytest.mark.parametrize("ds", [1, 4])
def test_env_step_parity(ds):
    # 64²: the preset's own grid, where the low modes are spinodally
    # unstable and the field keeps a real variance.  (At 16² every mode
    # decays within one step and -var sits at the f32 rounding floor of
    # the centered moments, ~1e-12.)  It also keeps the pooled obs >= 16.
    kw = dict(num_envs=16, grid_size=64, substeps=5,
              vectorized_control=True, spectral_solve="fused",
              obs_downsample=ds)
    env_e = make_cahn_hilliard_control_env(**kw, fused_epilogue=True)
    env_0 = make_cahn_hilliard_control_env(**kw, fused_epilogue=False)
    key = jax.random.PRNGKey(1)
    se, oe = env_e.reset(key)
    s0, o0 = env_0.reset(key)
    assert jnp.array_equal(oe, o0)
    for i in range(4):
        a = env_e.sample_actions(jax.random.PRNGKey(100 + i))
        se, oe, re, te, _, ie = env_e.step(se, a)
        s0, o0, r0, t0, _, i0 = env_0.step(s0, a)
        assert jnp.array_equal(se.y, s0.y)
        if ds == 1:
            assert jnp.array_equal(oe, o0)
        else:
            # pooled path: matmul pool of the centered field vs XLA
            # reshape-mean — up to 1 uint8 LSB of rounding skew
            d = jnp.abs(oe.astype(jnp.int32) - o0.astype(jnp.int32))
            assert int(d.max()) <= 1
        assert jnp.array_equal(te, t0)
        assert jnp.array_equal(ie["diverged"], i0["diverged"])
        rel = jnp.max(jnp.abs(re - r0) / (jnp.abs(r0) + 1e-12))
        assert float(rel) < 1e-5


def test_env_rollout_parity():
    kw = dict(num_envs=16, grid_size=16, substeps=5, end_time=0.05,
              vectorized_control=True, spectral_solve="fused")
    env_e = make_cahn_hilliard_control_env(**kw, fused_epilogue=True)
    env_0 = make_cahn_hilliard_control_env(**kw, fused_epilogue=False)

    def policy(obs, key):
        return jax.random.uniform(key, (16, 1), minval=-1.0, maxval=1.0)

    # 8 steps crosses the end_time=0.05/step_dt=0.01 auto-reset boundary.
    se, _ = env_e.reset(jax.random.PRNGKey(2))
    s0, _ = env_0.reset(jax.random.PRNGKey(2))
    se, rew_e, term_e = env_e.rollout(se, policy, 8, key=jax.random.PRNGKey(3))
    s0, rew_0, term_0 = env_0.rollout(s0, policy, 8, key=jax.random.PRNGKey(3))
    assert jnp.array_equal(term_e, term_0)
    assert jnp.array_equal(se.y, s0.y)
    np.testing.assert_allclose(np.asarray(rew_e), np.asarray(rew_0),
                               atol=1e-7)


def test_env_divergence_autoreset():
    kw = dict(num_envs=8, grid_size=16, substeps=5,
              vectorized_control=True, spectral_solve="fused")
    env = make_cahn_hilliard_control_env(**kw, fused_epilogue=True)
    state, _ = env.reset(jax.random.PRNGKey(4))
    # Poison one env: its NaNs propagate through its own matmuls
    # (0*NaN=NaN), so the poisoned env must flag.
    y_bad = state.y.at[3].set(jnp.nan)
    state = state._replace(y=y_bad)
    a = env.sample_actions(jax.random.PRNGKey(5))
    state, obs, reward, terminated, _, info = env.step(state, a)
    assert bool(info["diverged"][3])
    assert float(reward[3]) == 0.0
    # auto-reset replaced every terminated env's field with a fresh IC
    assert bool(jnp.isfinite(state.y).all())
    assert bool((obs[3] <= 255).all())


def test_env_divergence_no_autoreset_scrubs():
    kw = dict(num_envs=8, grid_size=16, substeps=5, auto_reset=False,
              vectorized_control=True, spectral_solve="fused")
    env = make_cahn_hilliard_control_env(**kw, fused_epilogue=True)
    state, _ = env.reset(jax.random.PRNGKey(6))
    state = state._replace(y=state.y.at[2].set(jnp.inf))
    a = env.sample_actions(jax.random.PRNGKey(7))
    state, obs, reward, terminated, _, info = env.step(state, a)
    assert bool(info["diverged"][2])
    assert bool(terminated[2])
    # without auto-reset the NaN fields are scrubbed to zero
    assert bool(jnp.isfinite(state.y).all())


def test_fused_epilogue_requires_vectorized_control():
    with pytest.raises(ValueError, match="vectorized_control"):
        make_cahn_hilliard_control_env(
            num_envs=4, grid_size=16, substeps=2,
            vectorized_control=False, spectral_solve="fused",
            fused_epilogue=True,
        )


# ---------------------------------------------------------------------------
# Multi-dim leading batch axes through the epilogue custom VJPs: the
# forwards flatten (*batch, ...) internally, so the backward passes must
# index the stats cotangent with [..., i] (a flat-batch [:, i] selects a
# batch axis instead and crashes or mis-broadcasts at grad time).
# ---------------------------------------------------------------------------


def test_ch_epilogue_multidim_batch_grads_match_flat():
    H = 16
    mep = _ep_macro(H, 0.01, 0.01, 1.0, 1e-4, 3, stats_center=0.5,
                    mats_dtype=jnp.float32)
    u_flat, kap_flat = _setup(6, H, seed=9)

    def loss(uu):
        y, s, _ = mep(uu, kap_flat.reshape(uu.shape[:-2]))
        return jnp.sum(y**2) + 1.5 * jnp.sum(s[..., 0]) + 0.5 * jnp.sum(
            s[..., 1])

    g_flat = jax.grad(loss)(u_flat)
    g_shaped = jax.grad(loss)(u_flat.reshape(2, 3, H, H))
    np.testing.assert_array_equal(np.asarray(g_flat),
                                  np.asarray(g_shaped.reshape(6, H, H)))
