"""Smoke test of the flagship path on an NVIDIA GPU.

Drives the 64² Cahn-Hilliard control fleet (4096 envs, 10 substeps per RL
step) and its PPO trainer once through the user entry points, with the cas
kernel compiled for the card, and checks every result against the repo's
plain XLA references.  One process; any failed phase raises and the script
exits non-zero without printing a result.

    python chip_smoke.py                # phases 1-5 on one GPU
    python chip_smoke.py --four-cards   # the four-GPU phase only

Phases (one GPU):
  1. device: platform, kind, count, and the card's name and power limit;
  2. kernel check: the cas kernel with its env epilogue at 4096×64²×10
     against the f32 oracle (field, rewards, divergence flags, obs);
  3. flagship env: reset + 100-step rollout with random actions on the
     preset's default path (finite rewards, no divergence, per-env mass);
  4. kernel against XLA: env-steps/s of the fleet with
     ``spectral_solve="fused"`` and ``"fft"``;
  5. trainer: 3 PPO updates on the same fleet, and one ``value_and_grad``
     step through the kernel's custom VJP against the oracle's gradient.

With ``--four-cards`` (and nothing else): a 4-GPU ``("env",)`` mesh —
sharded fleet of 4×4096 envs against the same envs on one card, the sharded
pathwise training step of ``__graft_entry__.dryrun_multichip`` against one
card, and the row-sharded 256² spectral macro against the one-card macro.

The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

B, GRID, SUBSTEPS, STEPS = 4096, 64, 10, 100
DX, DT, A = 0.01, 1e-3, 1.0          # the flagship preset's kernel settings

# Tolerances of the on-card comparisons (each against the f32 oracle run at
# HIGHEST matmul precision).  The kernel's transforms are 3-pass bf16
# products with f32 accumulation: every operand keeps ~16 significant bits,
# relative to the field's deviation from its mean (~0.01 here), so a
# substep adds ~1e-8 of error and 10 substeps stay far below FIELD_ATOL.
FIELD_ATOL = 1e-5
# The variance reward is a difference of centered moments: relative error
# ~ (field error / field std); std ~ 1e-4..1e-2 over an episode.
REWARD_RTOL = 1e-3
# uint8 observations: the same field rounds to the same bin except at a
# bin edge, where f32 rounding of either side may differ by one.
OBS_LSB = 1
# Per-env mean concentration between resets.  CH conserves mass exactly in
# exact arithmetic (the DC coefficient's multipliers are zero); f32
# rounding of 4096-pixel sums plus the 3-pass products' residual leave
# ~1e-6 after 100 steps.
MASS_ATOL = 1e-5
# Gradient of the macro against the oracle's: the backward pass IS the
# oracle's VJP; only the loss cotangent, built from the kernel's primal
# output, differs (by FIELD_ATOL-sized field error).
GRAD_RTOL = 1e-3


def _mu(c):
    return c**3 - c


def _card_line() -> str:
    """``name, power.limit`` from nvidia-smi, read by a child process that
    stays off JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def phase_device():
    import jax

    devs = jax.devices()
    d = devs[0]
    print(f"[1 device] platform={d.platform} kind={d.device_kind} "
          f"count={len(devs)}", flush=True)
    _check(d.platform == "gpu", f"JAX runs on {d.platform!r}, not a GPU")
    card = _card_line()
    print(card, flush=True)
    return d, card


def _fleet_inputs(seed=0):
    import jax
    import jax.numpy as jnp

    u = jnp.clip(0.5 + 0.01 * jax.random.normal(
        jax.random.PRNGKey(seed), (B, GRID, GRID), jnp.float32), 0.0, 1.0)
    kap = jax.random.uniform(jax.random.PRNGKey(seed + 1), (B,),
                             jnp.float32, minval=0.002, maxval=0.01)
    return u, kap


def _oracle_field(u, kap):
    import jax

    from pde_opt_jax.ops.spectral_reference import ch_sif_macro_reference

    with jax.default_matmul_precision("highest"):
        ref = jax.jit(ch_sif_macro_reference(_mu, DX, DX, A, DT,
                                             SUBSTEPS))(u, kap)
    return np.asarray(ref, np.float64)


def phase_kernel():
    import jax

    from pde_opt_jax.ops.cas_spectral import make_ch_cas_fused_macro

    u, kap = _fleet_inputs()
    ref = _oracle_field(u, kap)
    n = GRID * GRID
    for ds in (1, 4):
        macro = jax.jit(make_ch_cas_fused_macro(
            _mu, GRID, GRID, DX, DX, A, DT, SUBSTEPS,
            epilogue={"obs_scale": 255.0, "obs_offset": 0.0,
                      "obs_downsample": ds, "stats_center": 0.5}))
        t0 = time.perf_counter()
        compiled = macro.lower(u, kap).compile()
        print(f"[2 kernel] ds={ds} compiled in "
              f"{time.perf_counter() - t0:.2f} s; "
              f"{compiled.memory_analysis()}", flush=True)
        u1, stats, obs = jax.block_until_ready(compiled(u, kap))
        u1, stats, obs = (np.asarray(x) for x in (u1, stats, obs))
        field_err = float(np.abs(u1 - ref).max())
        s1, s2, cnt = stats[:, 0], stats[:, 1], stats[:, 2]
        reward = -(s2 / n - (s1 / n) ** 2)
        reward_ref = -ref.var(axis=(1, 2))
        reward_rel = float(np.max(np.abs(reward - reward_ref)
                                  / np.abs(reward_ref)))
        diverged = cnt < n - 0.5
        diverged_ref = ~np.isfinite(ref).reshape(B, -1).all(axis=1)
        hd = GRID // ds
        pooled = ref.reshape(B, hd, ds, hd, ds).mean(axis=(2, 4))
        obs_ref = np.clip(pooled * 255.0, 0, 255).astype(np.uint8)
        obs_lsb = int(np.abs(obs.astype(np.int32)
                             - obs_ref.astype(np.int32)).max())
        print(f"[2 kernel] ds={ds} field max|err| {field_err:.3e} "
              f"(tol {FIELD_ATOL}), reward max rel err {reward_rel:.3e} "
              f"(tol {REWARD_RTOL}), diverged {int(diverged.sum())} "
              f"(reference {int(diverged_ref.sum())}), obs max LSB diff "
              f"{obs_lsb} (tol {OBS_LSB})", flush=True)
        _check(u1.shape == (B, GRID, GRID) and obs.shape == (B, hd, hd),
               "kernel output shapes")
        _check(field_err <= FIELD_ATOL, "kernel field vs oracle")
        _check(reward_rel <= REWARD_RTOL, "kernel rewards vs oracle")
        _check(np.array_equal(diverged, diverged_ref), "divergence flags")
        _check(obs_lsb <= OBS_LSB, "kernel observation vs oracle")


def _random_policy(env):
    return lambda obs, key: env.sample_actions(key)


def phase_env():
    import jax

    from pde_opt_jax.envs import make_cahn_hilliard_control_env

    env = make_cahn_hilliard_control_env(num_envs=B, grid_size=GRID,
                                         substeps=SUBSTEPS)
    print(f"[3 env] preset default solver: {env.solver_type.__name__}",
          flush=True)
    policy = _random_policy(env)
    # An episode lasts at least env.max_episode_steps (= STEPS) steps: no
    # env may terminate before its last step unless it diverged.
    ep = env.max_episode_steps
    state, _ = env.reset(jax.random.PRNGKey(0))
    state, rewards, terms = env.rollout(state, policy, STEPS,
                                        key=jax.random.PRNGKey(1))
    rewards, terms = np.asarray(rewards), np.asarray(terms)
    early = terms[:ep - 1]
    print(f"[3 env] {STEPS}-step rollout: rewards finite "
          f"{bool(np.isfinite(rewards).all())}, mean reward "
          f"{float(rewards.mean()):.6e}, early terminations "
          f"{int(early.sum())}, terminations on the last step "
          f"{int(terms[ep - 1:].sum())}", flush=True)
    _check(rewards.shape == (STEPS, B), "reward shape")
    _check(bool(np.isfinite(rewards).all()), "non-finite rewards")
    _check(not early.any(), "an env diverged (early termination)")
    # Mass between resets: the same episode up to its last step.
    n_mass = min(STEPS, ep - 1)
    state, _ = env.reset(jax.random.PRNGKey(0))
    m0 = np.asarray(state.y.mean(axis=(1, 2)), np.float64)
    state, _, terms = env.rollout(state, policy, n_mass,
                                  key=jax.random.PRNGKey(1))
    _check(not np.asarray(terms).any(), "termination before episode end")
    drift = float(np.abs(np.asarray(state.y.mean(axis=(1, 2)),
                                    np.float64) - m0).max())
    print(f"[3 env] per-env mean concentration drift over {n_mass} "
          f"steps {drift:.3e} (tol {MASS_ATOL})", flush=True)
    _check(drift <= MASS_ATOL, "mass not conserved between resets")


def phase_rates(card: str):
    import jax

    from pde_opt_jax.envs import make_cahn_hilliard_control_env

    rates = {}
    for solve in ("fused", "fft"):
        env = make_cahn_hilliard_control_env(
            num_envs=B, grid_size=GRID, substeps=SUBSTEPS,
            spectral_solve=solve)
        policy = _random_policy(env)
        state, _ = env.reset(jax.random.PRNGKey(2))
        state, rewards, _ = env.rollout(state, policy, STEPS,
                                        key=jax.random.PRNGKey(3))
        jax.block_until_ready(rewards)                       # warm up
        times = []
        for rep in range(3):
            t0 = time.perf_counter()
            state, rewards, _ = env.rollout(state, policy, STEPS,
                                            key=jax.random.PRNGKey(4 + rep))
            jax.block_until_ready(rewards)
            times.append(time.perf_counter() - t0)
        rates[solve] = B * STEPS / min(times)
        print(f"[4 rates] spectral_solve={solve!r}: "
              f"{rates[solve]:.1f} env-steps/s (best of 3 rollouts of "
              f"{STEPS} steps, {[round(t, 6) for t in times]} s) on {card}",
              flush=True)
    print(f"[4 rates] kernel/XLA: {rates['fused'] / rates['fft']:.2f}x",
          flush=True)


def phase_trainer():
    import jax
    import jax.numpy as jnp

    from pde_opt_jax.envs import make_cahn_hilliard_control_env
    from pde_opt_jax.ops.cas_spectral import make_ch_cas_fused_macro
    from pde_opt_jax.ops.spectral_reference import ch_sif_macro_reference
    from pde_opt_jax.rl import ActorCriticMLP, PPOConfig, make_ppo_train_step

    env = make_cahn_hilliard_control_env(num_envs=B, grid_size=GRID,
                                         substeps=SUBSTEPS, obs_downsample=4)
    net = ActorCriticMLP(action_dim=1, in_features=16 * 16, widths=(256,),
                         features=64, compute_dtype=jnp.bfloat16,
                         key=jax.random.PRNGKey(70))
    cfg = PPOConfig(rollout_steps=64, epochs=2, minibatches=4, lr=3e-4)
    train_step, optimizer = make_ppo_train_step(env, cfg)
    params, opt_state = net, optimizer.init(net)
    key = jax.random.PRNGKey(71)
    env_state, _ = env.reset(jax.random.PRNGKey(72))
    for update in range(3):
        params, opt_state, env_state, key, metrics = train_step(
            params, opt_state, env_state, key)
        metrics = {k: float(v) for k, v in jax.device_get(metrics).items()}
        print(f"[5 trainer] update {update}: " + ", ".join(
            f"{k}={v:.4e}" for k, v in sorted(metrics.items())), flush=True)
        _check(all(np.isfinite(v) for v in metrics.values()),
               "non-finite PPO metrics")
    delta = sum(float(jnp.sum(jnp.abs(a.astype(jnp.float32)
                                      - b.astype(jnp.float32))))
                for a, b in zip(jax.tree_util.tree_leaves(params),
                                jax.tree_util.tree_leaves(net)))
    print(f"[5 trainer] total |Δparams| after 3 updates {delta:.4e}",
          flush=True)
    _check(delta > 0.0, "PPO did not change the parameters")

    u, kap = _fleet_inputs(seed=5)
    macro = make_ch_cas_fused_macro(_mu, GRID, GRID, DX, DX, A, DT, SUBSTEPS)
    oracle = ch_sif_macro_reference(_mu, DX, DX, A, DT, SUBSTEPS)

    def loss(m):
        return lambda uu, kk: jnp.mean((m(uu, kk) - 0.5) ** 2)

    v, (du, dk) = jax.jit(jax.value_and_grad(loss(macro), (0, 1)))(u, kap)
    with jax.default_matmul_precision("highest"):
        v_o, (du_o, dk_o) = jax.jit(
            jax.value_and_grad(loss(oracle), (0, 1)))(u, kap)
    du_rel = float(jnp.abs(du - du_o).max() / jnp.abs(du_o).max())
    dk_rel = float(jnp.abs(dk - dk_o).max() / jnp.abs(dk_o).max())
    print(f"[5 trainer] value_and_grad through the kernel's VJP: loss "
          f"{float(v):.6e} vs {float(v_o):.6e}; du max rel err "
          f"{du_rel:.3e}, dkappa max rel err {dk_rel:.3e} "
          f"(tol {GRAD_RTOL})", flush=True)
    _check(bool(jnp.isfinite(du).all() and jnp.isfinite(dk).all()),
           "non-finite gradient")
    _check(du_rel <= GRAD_RTOL and dk_rel <= GRAD_RTOL,
           "kernel gradient vs oracle gradient")


def phase_four_cards(card: str):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from __graft_entry__ import dryrun_multichip
    from pde_opt_jax.envs import make_cahn_hilliard_control_env
    from pde_opt_jax.ops.spectral_reference import ch_sif_macro_reference
    from pde_opt_jax.parallel import ShardedVectorPDEEnv, make_mesh
    from pde_opt_jax.parallel.halo import make_sharded_sif_ch_macro
    from pde_opt_jax.parallel.mesh import shard_map

    devs = jax.devices()
    _check(len(devs) == 4, f"--four-cards needs 4 GPUs, JAX sees {devs}")
    mesh = make_mesh(devs, axis_names=("env",))

    # (a) The fleet sharded over 4 cards against the same envs on one card.
    n_envs, steps = 4 * B, 20
    env = make_cahn_hilliard_control_env(num_envs=n_envs, grid_size=GRID,
                                         substeps=SUBSTEPS)
    senv = ShardedVectorPDEEnv(env, mesh)
    key = jax.random.PRNGKey(9)
    s_one, _ = env.reset(key)
    s_shd, _ = senv.reset(key)
    r_one, r_shd = [], []
    for i in range(steps):
        a = env.sample_actions(jax.random.PRNGKey(100 + i))
        s_one, _, r1, *_ = env.step(s_one, a)
        s_shd, _, r4, *_ = senv.step(
            s_shd, jax.device_put(a, NamedSharding(mesh, P("env"))))
        r_one.append(np.asarray(r1))
        r_shd.append(np.asarray(r4))
    r_one, r_shd = np.stack(r_one), np.stack(r_shd)
    span = len(s_shd.y.sharding.device_set)
    err = float(np.abs(r_one - r_shd).max())
    print(f"[6 four cards] sharded fleet {n_envs} envs x {steps} steps: "
          f"state spans {span} devices; per-env reward max |diff| vs one card "
          f"{err:.3e}", flush=True)
    _check(span == 4, "sharded state does not span 4 devices")
    _check(bool(np.isfinite(r_shd).all()), "non-finite sharded rewards")
    np.testing.assert_allclose(r_shd, r_one, rtol=1e-6, atol=1e-12)

    # (b) The sharded pathwise training step against one card.
    loss4 = dryrun_multichip(4, num_envs=16)
    loss1 = dryrun_multichip(1, num_envs=16)
    print(f"[6 four cards] sharded training step loss {loss4!r} vs one "
          f"card {loss1!r}", flush=True)
    np.testing.assert_allclose(loss4, loss1, rtol=1e-5)

    # (c) Row-sharded 256² spectral macro against the one-card macro.
    N, nb = 256, 16
    u = 0.5 + 0.05 * jax.random.normal(jax.random.PRNGKey(11),
                                       (nb, N, N), jnp.float32)
    kap = jnp.linspace(0.002, 0.01, nb, dtype=jnp.float32)
    smesh = make_mesh(devs, axis_names=("space",))
    macro = make_sharded_sif_ch_macro(_mu, N, N, DX, DX, A, DT, SUBSTEPS)
    sharded = jax.jit(shard_map(
        lambda ul, kk: macro(ul, kk), mesh=smesh,
        in_specs=(P(None, "space", None), P()),
        out_specs=P(None, "space", None)))
    got = np.asarray(sharded(u, kap))
    want = np.asarray(jax.jit(ch_sif_macro_reference(
        _mu, DX, DX, A, DT, SUBSTEPS))(u, kap))
    herr = float(np.abs(got - want).max())
    print(f"[6 four cards] row-sharded {N}² macro (batch {nb}, 4 shards) "
          f"max |diff| vs one card {herr:.3e} on 4x {card}", flush=True)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-GPU mesh phase")
    args = ap.parse_args()

    from pde_opt_jax.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    dev, card = phase_device()
    if args.four_cards:
        phase_four_cards(card)
    else:
        phase_kernel()
        phase_env()
        phase_rates(card)
        phase_trainer()

    import jax

    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
