"""Multi-device tests on an 8-way virtual CPU mesh.

The standard JAX substitute for a hardware pod: conftest sets
``xla_force_host_platform_device_count=8`` so ``shard_map`` collectives and
sharded env fleets are exercised for real (SURVEY.md §4 implication b).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import pde_opt_jax as p
from pde_opt_jax.envs import VectorPDEEnv
from pde_opt_jax.parallel import ShardedVectorPDEEnv, env_sharding, make_mesh

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 2, reason="needs multi-device (virtual) platform"
)


def _ch_env(num_envs):
    N = 16
    L = 0.01 * N
    domain = p.Domain((N, N), ((-L / 2, L / 2), (-L / 2, L / 2)))
    return VectorPDEEnv(
        equation_type=p.CahnHilliard2DPeriodic,
        domain=domain,
        solver_type=p.SemiImplicitFourierSpectral,
        end_time=0.05, step_dt=0.01, numeric_dt=0.002,
        state_to_observation_func=lambda y: y,
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
    )


def test_mesh_construction():
    mesh = make_mesh()
    assert mesh.shape["env"] == len(jax.devices())


def test_sharded_env_matches_single_device():
    """Sharded fleet must produce exactly the per-env results of the local fleet."""
    n_dev = len(jax.devices())
    num_envs = 2 * n_dev
    env = _ch_env(num_envs)
    mesh = make_mesh()
    senv = ShardedVectorPDEEnv(env, mesh)

    key = jax.random.PRNGKey(0)
    state_l, obs_l = env.reset(key)
    state_s, obs_s = senv.reset(key)
    np.testing.assert_allclose(np.asarray(obs_l), np.asarray(obs_s), atol=0)

    acts = jnp.zeros((num_envs, 1))
    sl, ol, rl, tl, _, _ = env.step(state_l, acts)
    ss, os_, rs, ts_, _, _ = senv.step(state_s, acts)
    np.testing.assert_allclose(np.asarray(rl), np.asarray(rs), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(sl.y), np.asarray(ss.y), rtol=1e-6)


def test_sharded_state_device_placement():
    n_dev = len(jax.devices())
    env = _ch_env(2 * n_dev)
    mesh = make_mesh()
    senv = ShardedVectorPDEEnv(env, mesh)
    state, obs = senv.reset(jax.random.PRNGKey(1))
    # The field buffer must actually live sharded across all devices.
    assert len(state.y.sharding.device_set) == n_dev


def test_sharded_rollout_runs():
    n_dev = len(jax.devices())
    env = _ch_env(2 * n_dev)
    mesh = make_mesh()
    senv = ShardedVectorPDEEnv(env, mesh)
    state, _ = senv.reset(jax.random.PRNGKey(2))
    policy = lambda obs, k: jnp.zeros((env.num_envs, 1))
    state, rewards, terms = senv.rollout(state, policy, 4)
    assert rewards.shape == (4, env.num_envs)
    assert bool(jnp.isfinite(rewards).all())


def _fused_flagship_env(num_envs):
    """The SAME configuration bench.py measures: vectorized_control fused
    cas-kernel CH fleet (grid 16 here for CPU speed; the kernel runs in
    interpret mode on CPU)."""
    from pde_opt_jax.envs.presets import make_cahn_hilliard_control_env

    return make_cahn_hilliard_control_env(
        num_envs=num_envs, grid_size=16, substeps=4,
        spectral_solve="fused", vectorized_control=True,
    )


def test_sharded_fused_flagship_matches_single_device():
    """The cas kernel macro under shard_map must produce exactly the
    per-env results of the single-device fused fleet — the multi-device
    witness for the code path the flagship bench measures."""
    n_dev = len(jax.devices())
    num_envs = 2 * n_dev
    env = _fused_flagship_env(num_envs)
    mesh = make_mesh()
    senv = ShardedVectorPDEEnv(env, mesh)

    key = jax.random.PRNGKey(7)
    state_l, obs_l = env.reset(key)
    state_s, obs_s = senv.reset(key)
    np.testing.assert_array_equal(np.asarray(obs_l), np.asarray(obs_s))

    acts = jnp.linspace(-1.0, 1.0, num_envs)[:, None]
    for _ in range(3):
        state_l, obs_l, rl, *_ = env.step(state_l, acts)
        state_s, obs_s, rs, *_ = senv.step(state_s, acts)
    np.testing.assert_array_equal(np.asarray(state_l.y),
                                  np.asarray(state_s.y))
    # Fields are bitwise; the fused-epilogue reward is a per-env quadrant
    # sum whose accumulation order depends on the kernel block size (which
    # differs between the 2-env shards and the full fleet) — exact to f32
    # summation-order rounding only.
    np.testing.assert_allclose(np.asarray(rl), np.asarray(rs),
                               rtol=1e-5, atol=1e-10)
    assert len(state_s.y.sharding.device_set) == n_dev


def test_sharded_fused_flagship_rollout_and_grad():
    """Pathwise gradient THROUGH the sharded fused kernel (its custom VJP
    under shard_map): finite, nonzero, and equal to the single-device grad."""
    n_dev = len(jax.devices())
    num_envs = 2 * n_dev
    env = _fused_flagship_env(num_envs)
    mesh = make_mesh()
    from jax.sharding import PartitionSpec as P
    from pde_opt_jax.parallel.mesh import shard_map

    state, _ = env.reset(jax.random.PRNGKey(8))

    def loss_local(y, cv, acts):
        y1, _ = env._advance_batched(y, cv, acts)
        return jnp.mean(jnp.var(y1, axis=(-2, -1)))

    def loss_shard(y, cv, acts):
        y1, _ = env._advance_batched(y, cv, acts)
        return jax.lax.psum(jnp.sum(jnp.var(y1, axis=(-2, -1))), "env")

    acts = jnp.linspace(-1.0, 1.0, num_envs)[:, None]
    g_local = jax.grad(loss_local, argnums=2)(state.y, state.control_value,
                                              acts)
    sharded = jax.jit(
        shard_map(
            lambda y, cv, a: jax.grad(
                lambda aa: loss_shard(y, cv, aa) / num_envs)(a),
            mesh=mesh, in_specs=(P("env"), P("env"), P("env")),
            out_specs=P("env"), check_vma=False,
        )
    )
    g_sharded = sharded(state.y, state.control_value, acts)
    assert bool(jnp.isfinite(g_sharded).all())
    assert float(jnp.max(jnp.abs(g_sharded))) > 0.0
    np.testing.assert_allclose(np.asarray(g_sharded), np.asarray(g_local),
                               rtol=1e-5, atol=1e-8)


def test_learner_psum_gradients():
    """Co-located learner pattern: per-shard data, replicated params.

    The ``psum`` lives INSIDE the differentiated loss — the idiomatic
    pattern under jax's varying-manual-axes semantics: AD transposes the
    psum so the gradient w.r.t. the replicated parameter comes out globally
    reduced exactly once.  (An explicit psum of an already-unvarying
    gradient would double-count by the axis size under ``check_vma=True``.)
    This runs with the VMA checker ON (the default of our wrapper; only
    rfft-gradient regions opt out, see ``parallel/mesh.py``).
    """
    mesh = make_mesh()
    n_dev = len(jax.devices())
    from pde_opt_jax.parallel.mesh import shard_map
    from jax.sharding import PartitionSpec as P

    w = jnp.ones((4,))
    x = jnp.arange(8 * n_dev * 4, dtype=jnp.float32).reshape(8 * n_dev, 4)

    def loss_shard(w, xs):
        def global_loss(w_):
            return jax.lax.psum(jnp.sum((xs @ w_) ** 2), "env") / (8 * n_dev)

        per, g = jax.value_and_grad(global_loss)(w)
        return per, g

    f = jax.jit(
        shard_map(
            loss_shard, mesh=mesh, in_specs=(P(), P("env")), out_specs=(P(), P()),
        )
    )
    loss_sharded, g_sharded = f(w, x)
    loss_ref, g_ref = jax.value_and_grad(
        lambda w_: jnp.sum((x @ w_) ** 2) / (8 * n_dev)
    )(w)
    np.testing.assert_allclose(float(loss_sharded), float(loss_ref), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(g_sharded), np.asarray(g_ref), rtol=1e-6)


def test_sharded_gpe_strang_env_matches_single_device():
    """The GPE Strang fleet (BASELINE config 5: split-step spectral steps
    + env sharding) under shard_map: per-env results match local."""
    from pde_opt_jax.envs import make_gpe_control_env

    n_dev = len(jax.devices())
    num_envs = 2 * n_dev
    env = make_gpe_control_env(num_envs=num_envs, grid_size=16,
                               substeps=2, end_time=0.2, step_dt=0.02)
    mesh = make_mesh()
    senv = ShardedVectorPDEEnv(env, mesh)

    key = jax.random.PRNGKey(5)
    state_l, obs_l = env.reset(key)
    state_s, obs_s = senv.reset(key)
    np.testing.assert_array_equal(np.asarray(obs_l), np.asarray(obs_s))

    acts = jnp.full((num_envs, 1), 0.3)
    for _ in range(2):
        state_l, obs_l, rl, tl, _, _ = env.step(state_l, acts)
        state_s, obs_s, rs, ts_, _, _ = senv.step(state_s, acts)
    np.testing.assert_array_equal(np.asarray(state_l.y),
                                  np.asarray(state_s.y))
    np.testing.assert_array_equal(np.asarray(obs_l), np.asarray(obs_s))
    np.testing.assert_allclose(np.asarray(rl), np.asarray(rs),
                               rtol=1e-5, atol=1e-9)
    assert len(state_s.y.sharding.device_set) == n_dev


def test_sharded_rot_gpe_env_matches_single_device():
    """The 6th env family (complex state, matmul ADI stepper) under
    shard_map: per-env rewards and states match the local fleet — the
    sweep-propagator constants replicate, the complex field shards."""
    from pde_opt_jax.envs import make_gpe_rot_control_env

    n_dev = len(jax.devices())
    num_envs = 2 * n_dev
    env = make_gpe_rot_control_env(num_envs=num_envs, grid_size=16,
                                   substeps=2, end_time=0.32, step_dt=0.04)
    mesh = make_mesh()
    senv = ShardedVectorPDEEnv(env, mesh)

    key = jax.random.PRNGKey(3)
    state_l, obs_l = env.reset(key)
    state_s, obs_s = senv.reset(key)
    np.testing.assert_allclose(np.asarray(obs_l), np.asarray(obs_s), atol=0)
    assert state_s.y.dtype == state_l.y.dtype  # complex64 preserved

    acts = jnp.full((num_envs, 1), 0.7)
    sl, ol, rl, tl, _, _ = env.step(state_l, acts)
    ss, os_, rs, ts_, _, _ = senv.step(state_s, acts)
    np.testing.assert_allclose(np.asarray(rl), np.asarray(rs),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(np.asarray(sl.y.real), np.asarray(ss.y.real),
                               rtol=1e-5, atol=1e-7)
    assert len(ss.y.sharding.device_set) == n_dev

    # Whole rollout on the complex fleet: the sharded rollout is ONE
    # jitted program (incl. the initial observation), so this path never
    # observes outside the trace.
    def const_policy(obs, k):
        return jnp.full((num_envs, 1), 0.5)

    _, rew_l, _ = env.rollout(sl, const_policy, 3, key=jax.random.PRNGKey(5))
    _, rew_s, _ = senv.rollout(ss, const_policy, 3, key=jax.random.PRNGKey(5))
    np.testing.assert_allclose(np.asarray(rew_l), np.asarray(rew_s),
                               rtol=1e-5, atol=1e-7)
