"""Benchmark: env-steps/s on the flagship fleet, plus a config matrix.

Primary metric (BASELINE.json): aggregate env-steps/s at 64×64
Cahn-Hilliard, 4096 envs.  One env step = one RL macro-step = ``SUBSTEPS``
semi-implicit spectral substeps (control update, physics, reward,
observation, auto-reset) — all inside one on-device scan with zero host
round-trips, on the preset's default path (the cas kernel).

The top-level process is a jax-free orchestrator that runs every config —
including the flagship — in its own subprocess (``python bench.py --config
NAME``) under a per-config timeout and a global wall-clock budget
(``PDE_OPT_BENCH_BUDGET_S``, default 720 s).  It starts one child at a
time and waits for it to exit before the next (``subprocess.run``), so
exactly one process holds the GPU at any moment: a JAX process reserves
most of the card's memory when it starts, and a second one would fail.

bench.py measures the GPU: a child that finds no GPU exits with an error,
and the run is reported invalid.  It never falls back to the CPU.

Config matrix (recorded under ``"configs"``):
  * flagship model-FLOP and HBM roofline shares against the card's peaks;
  * 128×128 and 256² Cahn-Hilliard fleets (XLA rfft stepper);
  * Allen-Cahn fleet; GPE Strang fleets at 64² and 128² (XLA FFT);
  * Butler-Volmer charging fleet: XLA RK4 at 64² and 48²;
  * smoothed-boundary BV fleet (XLA RK4);
  * rotating-frame GPE via DirectionalSplitting + vortex census;
  * 32³ 3D Cahn-Hilliard batched spectral rollout (XLA rfft vs cas);
  * PPO end-to-end training rate with physics/learner split;
  * training path: value+grad of the cas macro vs per-substep XLA.

Prints exactly ONE JSON line; the leading keys keep the driver contract
(metric/value/unit/vs_baseline), extra keys carry the matrix.
"""

import json
import os
import subprocess
import sys
import time

NUM_ENVS = 4096
GRID = 64
SUBSTEPS = 10
STEPS_PER_RUN = 100
TIMED_RUNS = 3

BUDGET_S = float(os.environ.get("PDE_OPT_BENCH_BUDGET_S", "720"))
GRACE_S = 60.0

# Published peaks per device, keyed by ``jax.devices()[0].device_kind``:
# (dense bf16 FLOP/s, HBM bytes/s).  Source: NVIDIA H100 SXM data sheet
# (989 TFLOP/s dense bf16 tensor core, 3.35 TB/s HBM3), at the full 700 W
# power limit.
PEAKS = {
    "NVIDIA H100 80GB HBM3": (989e12, 3.35e12),
}


# --------------------------------------------------------------------------
# Config workers.  Each runs inside its own subprocess; jax is imported
# lazily so the orchestrator process stays jax-free (it must never touch
# the GPU while a child holds it).
# --------------------------------------------------------------------------


def _device_peaks():
    """``((peak_flops, peak_bw), device_kind)``; an unknown device raises."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise RuntimeError(
            f"bench.py measures the GPU; JAX found {dev.platform!r}"
        )
    if dev.device_kind not in PEAKS:
        raise KeyError(f"no published peaks for device {dev.device_kind!r}")
    return PEAKS[dev.device_kind], dev.device_kind


def _rollout_rate(env, num_envs, steps_per_run, timed_runs=TIMED_RUNS, key0=0):
    """env-steps/s of a random-policy on-device rollout (donated state)."""
    import jax
    import jax.numpy as jnp

    def policy(obs, key):
        return jax.random.uniform(
            key, (num_envs, 1), minval=-1.0, maxval=1.0, dtype=jnp.float32
        )

    run = env.make_rollout(policy, steps_per_run)
    state, _ = env.reset(jax.random.PRNGKey(key0))
    state, rewards, terms = run(state, jax.random.PRNGKey(key0 + 1))
    jax.block_until_ready(rewards)

    t0 = time.perf_counter()
    for i in range(timed_runs):
        state, rewards, terms = run(state, jax.random.PRNGKey(key0 + 2 + i))
    jax.block_until_ready(rewards)
    elapsed = time.perf_counter() - t0
    if not bool(jnp.isfinite(rewards).all()):
        return None, elapsed
    return num_envs * steps_per_run * timed_runs / elapsed, elapsed


def _cas_substep_flops(H, W):
    """Model FLOPs per env per cas substep: 2 separable transforms (fwd of
    mu(u), inverse of the increment), each two matmuls (H×H by H×W, then
    H×W by W×W) -> 2 * 2*H*W*(H+W).  The kernel's 3-pass bf16 products
    issue 3x this on the tensor cores; the model counts the algorithm."""
    return 2 * (2 * H * W * (H + W))


def _mfu_for(rate_substeps_per_s, flops_per_substep):
    """Model-FLOP share of the device's bf16 peak for a per-substep model."""
    (peak_flops, _), _ = _device_peaks()
    return round(rate_substeps_per_s * flops_per_substep / peak_flops, 4)


_STENCIL_NOTE = ("elementwise roll-stencil path (no matmuls): MFU not "
                 "applicable")


def run_flagship():
    import jax

    platform = jax.devices()[0].platform
    (peak_flops, peak_bw), device_kind = _device_peaks()
    from pde_opt_jax.envs.presets import make_cahn_hilliard_control_env

    num_envs = NUM_ENVS
    env = make_cahn_hilliard_control_env(
        num_envs=num_envs, grid_size=GRID, substeps=SUBSTEPS,
    )
    rate, _ = _rollout_rate(env, num_envs, STEPS_PER_RUN)
    return {
        "platform": platform,
        "device": device_kind,
        "rate": rate,
        "num_envs": num_envs,
        "peak_flops": peak_flops,
        "peak_bw": peak_bw,
    }


def run_ch128():
    from pde_opt_jax.envs.presets import make_cahn_hilliard_control_env

    # The cas kernel takes grids up to 64: 128² runs the XLA rfft stepper.
    env = make_cahn_hilliard_control_env(
        num_envs=1024, grid_size=128, substeps=SUBSTEPS,
        spectral_solve="fft",
    )
    rate, _ = _rollout_rate(env, 1024, 35, key0=10)
    if not rate:
        return None
    return {"env_steps_per_s": round(rate, 1), "mfu": None,
            "mfu_note": "XLA rfft path: no matmul FLOP model"}


def run_ch256():
    """256² (the reference's largest exercised rollout) on the XLA rfft
    stepper (the cas kernel takes grids up to 64)."""
    from pde_opt_jax.envs.presets import make_cahn_hilliard_control_env

    env = make_cahn_hilliard_control_env(
        num_envs=256, grid_size=256, substeps=SUBSTEPS, spectral_solve="fft",
    )
    rate, _ = _rollout_rate(env, 256, 20, key0=60)
    if not rate:
        return None
    return {"env_steps_per_s": round(rate, 1), "mfu": None,
            "mfu_note": "XLA rfft path: no matmul FLOP model"}


def run_ac64():
    from pde_opt_jax.envs.presets import make_allen_cahn_control_env

    env = make_allen_cahn_control_env(
        num_envs=NUM_ENVS, grid_size=GRID, substeps=SUBSTEPS,
    )
    rate, _ = _rollout_rate(env, NUM_ENVS, 30, key0=20)
    if not rate:
        return None
    return {"env_steps_per_s": round(rate, 1), "mfu": None,
            "mfu_note": "XLA rfft path: no matmul FLOP model"}


def _bv_rate(method, grid):
    from pde_opt_jax.envs import make_butler_volmer_control_env

    env = make_butler_volmer_control_env(num_envs=2048, grid_size=grid,
                                         substeps=SUBSTEPS, method=method)
    rate, _ = _rollout_rate(env, 2048, 40, key0=80)
    if not rate:
        return None
    return {"env_steps_per_s": round(rate, 1), "mfu": None,
            "mfu_note": _STENCIL_NOTE}


def run_bv_xla_64():
    # Each grid in its own subprocess so a pathological compile cannot
    # sink the rest.
    return _bv_rate("rk4", 64)


def run_bv_xla_48():
    return _bv_rate("rk4", 48)


def run_sbm_bv():
    """Smoothed-boundary galvanostatic BV charging fleet (XLA RK4)."""
    from pde_opt_jax.envs import make_sbm_butler_volmer_control_env

    env = make_sbm_butler_volmer_control_env(num_envs=1024, grid_size=64,
                                             substeps=SUBSTEPS)
    rate, _ = _rollout_rate(env, 1024, 40, key0=90)
    if not rate:
        return None
    return {"env_steps_per_s": round(rate, 1), "mfu": None,
            "mfu_note": _STENCIL_NOTE}


def run_gpe64():
    """GPE Strang fleet on the merged-FFT path."""
    from pde_opt_jax.envs.presets import make_gpe_control_env

    env = make_gpe_control_env(num_envs=1024, grid_size=GRID,
                               substeps=SUBSTEPS)
    rate, _ = _rollout_rate(env, 1024, 30, key0=30)
    if not rate:
        return None
    return {"fft_env_steps_per_s": round(rate, 1), "mfu": None,
            "mfu_note": "XLA FFT path: no matmul FLOP model"}


def run_gpe_rot():
    """Rotating-frame GPE at 64²: batched imaginary-time field-substeps/s
    on the FFT DirectionalSplitting path vs the matmul ADI macro
    (ops/gpe_rot_fast.py — precomputed per-line propagators as matmuls),
    plus a vortex census of the rotating ground state and the stirring
    control-fleet rollout rate (the 6th env family)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from pde_opt_jax.grid import Domain
    from pde_opt_jax.models.gross_pitaevskii import GPE2DTSRot
    from pde_opt_jax.ops.gpe_rot_fast import make_rot_adi_macro
    from pde_opt_jax.ops.integrate import evolve
    from pde_opt_jax.ops.steppers import DirectionalSplitting
    from pde_opt_jax.utils import density, initialize_Psi
    from pde_opt_jax.utils.rl import vortex_winding

    B, N, L, dt, n_sub = 512, GRID, 20.0, 2e-4, 50
    domain = Domain((N, N), ((-L / 2, L / 2), (-L / 2, L / 2)))
    eq = GPE2DTSRot(domain, 500.0, 0.0, 0.9)
    stepper = DirectionalSplitting(eq.A_terms, eq.B_terms, domain.dx[0],
                                   time_scale=-1j)
    macro = make_rot_adi_macro(eq.A_terms, eq.B_terms, float(domain.dx[0]),
                               N, N, dt, n_sub, time_scale=-1j)

    @jax.jit
    def build():
        psi0 = initialize_Psi(N, width=14, vortexnumber=1)
        psi0 = psi0 / jnp.sqrt(jnp.sum(density(psi0)) * domain.dx[0] ** 2)
        return jnp.broadcast_to(psi0, (B, N, N))

    def rate(run, runs):
        y = jax.block_until_ready(run(build()))
        t0 = time.perf_counter()
        for _i in range(runs):
            y = run(y)
        jax.block_until_ready(y)
        elapsed = time.perf_counter() - t0
        if not bool(jax.jit(lambda y: jnp.isfinite(y.real).all())(y)):
            return None, y
        return B * n_sub * runs / elapsed, y

    out = {}
    fft_rate, _ = rate(
        jax.jit(lambda y: evolve(stepper, lambda s, t: s, y, 0.0, dt, n_sub)),
        3)
    if fft_rate:
        out["fft_field_substeps_per_s"] = round(fft_rate, 1)
        _emit_partial(out)
    fast_rate, y = rate(jax.jit(lambda y: macro(y)), 8)
    if fast_rate:
        out["matmul_field_substeps_per_s"] = round(fast_rate, 1)
        # 2 packed-complex ADI sweeps/substep, each a (2N, 2N) contraction
        # over N lines: 2 * 2*(2N)^2*N = 16 N^3 flops per field-substep.
        out["mfu"] = _mfu_for(fast_rate, 16 * N**3)
        out["mfu_model"] = "2 packed-complex (2N,2N) ADI sweeps/substep"
        thresh = 0.05 * float(jax.jit(lambda y: jnp.max(jnp.abs(y[0])))(y))
        n_int = np.asarray(jax.device_get(
            jax.jit(lambda y: vortex_winding(y[0], amp_thresh=thresh))(y)))
        out["num_vortices"] = int((n_int != 0).sum())
        _emit_partial(out)

    # Stirring control fleet (make_gpe_rot_control_env, fused stepper).
    from pde_opt_jax.envs import make_gpe_rot_control_env

    env = make_gpe_rot_control_env(num_envs=1024, grid_size=GRID,
                                   substeps=SUBSTEPS)
    env_rate, _ = _rollout_rate(env, 1024, 25, key0=95)
    if env_rate:
        out["env_steps_per_s"] = round(env_rate, 1)
    return out or None


def run_ch3d():
    """Batched 32³ rollouts: XLA-rfft SIF vs the cas-matmul 3D macro."""
    import jax
    import jax.numpy as jnp

    from pde_opt_jax.grid import Domain
    from pde_opt_jax.models.cahn_hilliard import CahnHilliard3DPeriodic
    from pde_opt_jax.ops.cas3d import make_ch3d_cas_macro
    from pde_opt_jax.ops.integrate import evolve
    from pde_opt_jax.ops.steppers import SemiImplicitFourierSpectral
    from pde_opt_jax.utils.compat import prepare_solver_params

    B, N = 256, 32
    L = 0.01 * N
    domain = Domain((N, N, N), ((-L / 2, L / 2),) * 3, "dimensionless")
    eq = CahnHilliard3DPeriodic(
        domain, 0.002, lambda c: c**3 - c, lambda c: jnp.ones_like(c),
        derivs="fourier",
    )
    solver = SemiImplicitFourierSpectral(
        **prepare_solver_params(SemiImplicitFourierSpectral, {"A": 0.5}, eq)
    )
    n_sub = 50
    h = L / N
    macro = make_ch3d_cas_macro(lambda c: c**3 - c, N, N, N, h, h, h,
                                1.0, 5e-7, n_sub)

    fft_run = jax.jit(lambda y: evolve(solver, eq.rhs, y, 0.0, 5e-7, n_sub))
    cas_run = jax.jit(lambda y: macro(y, 0.002))

    def rate(run, runs):
        y = 0.5 + 0.05 * jax.random.normal(
            jax.random.PRNGKey(40), (B, N, N, N), jnp.float32
        )
        y = jax.block_until_ready(run(y))
        t0 = time.perf_counter()
        for _i in range(runs):
            y = run(y)
        jax.block_until_ready(y)
        dt = time.perf_counter() - t0
        if not bool(jnp.isfinite(y).all()):
            return None
        return B * n_sub * runs / dt

    out = {}
    r = rate(cas_run, 10)
    if r:
        out["cas_field_substeps_per_s"] = round(r, 1)
        # fwd + inv 3D cas transform = 6 axis contractions of depth N:
        # 6 * 2*N^3*N = 12 N^4 flops per field-substep.
        out["mfu"] = _mfu_for(r, 12 * N**4)
        out["mfu_model"] = "6 depth-N axis contractions/substep (3D cas)"
        _emit_partial(out)
    r = rate(fft_run, 3)
    if r:
        out["fft_field_substeps_per_s"] = round(r, 1)
    return out or None


def run_ch3d_mobility():
    """The reference's 3D training workload shape — 32³ CH with Legendre
    chemical potential AND Legendre mobility (D(c) != 1, so none of the
    unit-mobility fused macros apply): XLA-rfft SIF path vs the
    general-mobility cas macro (roll-stencil flux rhs + cas implicit
    solve, ops/cas_mobility.py)."""
    import jax
    import jax.numpy as jnp

    from pde_opt_jax.grid import Domain
    from pde_opt_jax.models.cahn_hilliard import CahnHilliard3DPeriodic
    from pde_opt_jax.models.functions import (
        ChemicalPotentialLegendrePolynomials,
        DiffusionLegendrePolynomials,
    )
    from pde_opt_jax.ops.cas_mobility import make_ch3d_mobility_cas_macro
    from pde_opt_jax.ops.integrate import evolve
    from pde_opt_jax.ops.steppers import SemiImplicitFourierSpectral
    from pde_opt_jax.utils.compat import prepare_solver_params

    B, N = 256, 32
    L = 0.01 * N
    mu_fn = ChemicalPotentialLegendrePolynomials(jnp.array([0.0, 1.0, 0.5]))
    D_fn = DiffusionLegendrePolynomials(jnp.array([0.3, 0.2]))
    domain = Domain((N, N, N), ((-L / 2, L / 2),) * 3, "dimensionless")
    eq = CahnHilliard3DPeriodic(domain, 0.002, mu_fn, D_fn, derivs="fd")
    # A=1.0: the Legendre workload's non-unit mobility needs roughly twice
    # the bare implicit shift for linear stability (dt-independent; see
    # tests/test_cas_mobility.py stab_scale test) — same A on both paths.
    solver = SemiImplicitFourierSpectral(
        **prepare_solver_params(SemiImplicitFourierSpectral, {"A": 1.0}, eq)
    )
    n_sub = 50
    h = L / N
    dt = 2.5e-4
    macro = make_ch3d_mobility_cas_macro(mu_fn, D_fn, N, N, N, h, h, h,
                                         1.0, dt, n_sub, stab_scale=2.0)

    fft_run = jax.jit(lambda y: evolve(solver, eq.rhs, y, 0.0, dt, n_sub))
    cas_run = jax.jit(lambda y: macro(y, 0.002))

    def rate(run, runs):
        y = jnp.clip(
            0.5 + 0.01 * jax.random.normal(jax.random.PRNGKey(41),
                                           (B, N, N, N), jnp.float32),
            0.0, 1.0,
        )
        y = jax.block_until_ready(run(y))
        t0 = time.perf_counter()
        for _i in range(runs):
            y = run(y)
        jax.block_until_ready(y)
        elapsed = time.perf_counter() - t0
        if not bool(jnp.isfinite(y).all()):
            return None
        return B * n_sub * runs / elapsed

    out = {}
    r = rate(cas_run, 10)          # the headline number first
    if r:
        out["cas_field_substeps_per_s"] = round(r, 1)
        # Matmul share only: the cas implicit solve is 6 depth-N axis
        # contractions/substep; the Legendre flux rhs is elementwise
        # stencils and adds no matmul flops (so this understates slightly).
        out["mfu"] = _mfu_for(r, 12 * N**4)
        out["mfu_model"] = ("6 depth-N cas contractions/substep "
                            "(stencil flux rhs not counted)")
        _emit_partial(out)
    r = rate(fft_run, 3)
    if r:
        out["fft_field_substeps_per_s"] = round(r, 1)
    if len(out) == 2:
        out["cas_vs_fft_speedup"] = round(
            out["cas_field_substeps_per_s"] / out["fft_field_substeps_per_s"],
            2)
    return out or None


def run_gpe128():
    """BASELINE config 5 at its stated size: 128x128 GPE split-step fleet
    on the merged-FFT path."""
    from pde_opt_jax.envs.presets import make_gpe_control_env

    env = make_gpe_control_env(num_envs=256, grid_size=128,
                               substeps=SUBSTEPS)
    rate, _ = _rollout_rate(env, 256, 10, key0=36)
    if not rate:
        return None
    return {"fft_env_steps_per_s": round(rate, 1), "mfu": None,
            "mfu_note": "XLA FFT path: no matmul FLOP model"}


def run_train_grad_128():
    """BASELINE config 3 at its stated size: differentiable NN-control
    rollout at 128^2 x 4096 envs — value+grad w.r.t. the parameters of an
    NN that maps per-env field statistics to the kappa control, through
    a 10-substep XLA FFT macro (the cas kernel takes grids up to 64; the
    reference's optimize_nn workload shape,
    ``notebooks/optimize_nn_script.py:15``)."""
    import jax
    import jax.numpy as jnp

    from pde_opt_jax.ops.spectral_reference import ch_sif_macro_reference

    B, N, n_sub = 4096, 128, SUBSTEPS
    mu = lambda c: c**3 - c  # noqa: E731
    u = 0.5 + 0.01 * jax.random.normal(jax.random.PRNGKey(55), (B, N, N),
                                       jnp.float32)
    macro = ch_sif_macro_reference(mu, 0.01, 0.01, 1.0, 1e-3, n_sub,
                                   remat=True)

    k1, k2 = jax.random.split(jax.random.PRNGKey(56))
    params = {
        "w1": 0.5 * jax.random.normal(k1, (2, 32), jnp.float32),
        "b1": jnp.zeros((32,), jnp.float32),
        "w2": 0.5 * jax.random.normal(k2, (32, 1), jnp.float32),
        "b2": jnp.zeros((1,), jnp.float32),
    }

    def loss(p, uu):
        feats = jnp.stack(
            [uu.mean(axis=(-2, -1)) - 0.5, uu.var(axis=(-2, -1))], axis=-1
        )
        h = jnp.tanh(feats @ p["w1"] + p["b1"])
        kap = 0.002 + 0.008 * jax.nn.sigmoid(h @ p["w2"] + p["b2"])[:, 0]
        y1 = macro(uu, kap)
        return jnp.sum((y1 - 0.5) ** 2)

    vg = jax.value_and_grad(loss)

    # The 256 MB field is an ARGUMENT: a closure would bake it into the
    # program as a constant.
    @jax.jit
    def step(p, uu):
        v, g = vg(p, uu)
        return v + sum(jnp.sum(x) for x in jax.tree_util.tree_leaves(g))

    jax.block_until_ready(step(params, u))
    t0 = time.perf_counter()
    runs = 5
    for _i in range(runs):
        out_v = step(params, u)
    jax.block_until_ready(out_v)
    dt = time.perf_counter() - t0
    rate = B * n_sub * runs / dt
    return {"nn_grad_env_substeps_per_s": round(rate, 1), "mfu": None,
            "mfu_note": "XLA FFT path: no matmul FLOP model"}


def run_ppo():
    """End-to-end PPO training rate: one jitted update = 64-step rollout
    over the fused 4096-env fleet + GAE + 2 epochs x 4 minibatches of
    clipped-surrogate policy updates.  Also reports the physics:learner
    time split — the random-policy rollout of the SAME env/obs config is
    the physics+obs floor; everything above it is the learner.

    Policy: ``ActorCriticMLP`` (flattened 16² obs through dense
    matmuls)."""
    import jax
    import jax.numpy as jnp

    from pde_opt_jax.envs import make_cahn_hilliard_control_env
    from pde_opt_jax.rl import ActorCriticMLP, PPOConfig

    B = NUM_ENVS
    T = 64
    env = make_cahn_hilliard_control_env(
        num_envs=B, grid_size=GRID, substeps=SUBSTEPS, obs_downsample=4,
    )
    net = ActorCriticMLP(action_dim=1, in_features=16 * 16, widths=(256,),
                         features=64, compute_dtype=jnp.bfloat16,
                         key=jax.random.PRNGKey(70))
    cfg = PPOConfig(rollout_steps=T, epochs=2, minibatches=4, lr=3e-4)

    # Time the jitted train step directly: back-to-back enqueues, then
    # wait for the last (ppo_train's per-update metric fetch is logging,
    # not training).
    from pde_opt_jax.rl import make_ppo_train_step

    train_step, optimizer = make_ppo_train_step(env, cfg)
    params = net
    opt_state = optimizer.init(params)
    key = jax.random.PRNGKey(71)
    env_state, _ = env.reset(jax.random.PRNGKey(72))
    for _ in range(2):                                # compile + warm
        params, opt_state, env_state, key, metrics = train_step(
            params, opt_state, env_state, key)
    jax.block_until_ready(metrics)

    def _time_updates(n_upd):
        nonlocal params, opt_state, env_state, key, metrics
        t0 = time.perf_counter()
        for _ in range(n_upd):
            params, opt_state, env_state, key, metrics = train_step(
                params, opt_state, env_state, key)
        jax.block_until_ready(metrics)
        return (time.perf_counter() - t0) / n_upd

    dt = _time_updates(8)
    _emit_partial({"trained_env_steps_per_s": round(T * B / dt, 1),
                   "update_ms": round(1e3 * dt, 1),
                   "policy": "mlp256-bf16"})

    # Physics+obs floor: random-policy rollout of the same env, same T,
    # BRACKETED by a second update timing; the split is against the mean
    # and the bracket is reported so drift is visible in the record.
    phys_rate, _ = _rollout_rate(env, B, T, timed_runs=3, key0=72)
    dt2 = _time_updates(4)
    dt_split = 0.5 * (dt + dt2)
    out = {"trained_env_steps_per_s": round(T * B / dt, 1),
           "update_ms": round(1e3 * dt, 1),
           "update_ms_bracket": [round(1e3 * dt, 1), round(1e3 * dt2, 1)],
           "policy": "mlp256-bf16",
           "mfu": None,
           "mfu_note": ("end-to-end training composite (physics + GAE + "
                        "learner); kernel MFU is the flagship's, physics "
                        "share reported below")}
    if phys_rate:
        # The split's basis is the bracket MEAN (reported explicitly as
        # split_update_ms so physics_ms + learner_ms sums to a field in
        # the record); the headline update_ms/rate stay the first, longer
        # timing batch.
        phys_ms = 1e3 * T * B / phys_rate
        out["split_update_ms"] = round(1e3 * dt_split, 1)
        out["physics_ms"] = round(phys_ms, 1)
        out["learner_ms"] = round(max(1e3 * dt_split - phys_ms, 0.0), 1)
        out["physics_share"] = round(min(phys_ms / (1e3 * dt_split), 1.0), 3)
    return out


def run_train_grad():
    """Training-path throughput: value+grad of a 10-substep macro, the cas
    kernel (whose VJP runs the XLA oracle) vs the per-substep XLA rfft
    stepper (grad-env-substeps/s)."""
    import jax
    import jax.numpy as jnp

    from pde_opt_jax.grid import Domain
    from pde_opt_jax.models.cahn_hilliard import CahnHilliard2DPeriodic
    from pde_opt_jax.ops.cas_spectral import make_ch_cas_fused_macro
    from pde_opt_jax.ops.integrate import evolve
    from pde_opt_jax.ops.steppers import SemiImplicitFourierSpectral
    from pde_opt_jax.utils.compat import prepare_solver_params

    B, N, n_sub = 1024, GRID, SUBSTEPS
    mu = lambda c: c**3 - c
    u = 0.5 + 0.01 * jax.random.normal(jax.random.PRNGKey(50), (B, N, N),
                                       jnp.float32)
    kap = jnp.full((B,), 0.004, jnp.float32)
    macro = make_ch_cas_fused_macro(mu, N, N, 0.01, 0.01, 1.0, 1e-3, n_sub)

    # Scalar-only outputs: value + summed grad in ONE jitted function, so
    # the timed loop moves no per-call arrays and a single trailing fetch
    # forces the whole sequence.
    def _scalarize(loss):
        vg = jax.value_and_grad(loss)

        @jax.jit
        def f(kk):
            v, g = vg(kk)
            return v + jnp.sum(g)

        return f

    fused_grad = _scalarize(lambda kk: jnp.sum(macro(u, kk) ** 2))

    L = 0.01 * N
    domain = Domain((N, N), ((-L / 2, L / 2), (-L / 2, L / 2)),
                    "dimensionless")

    def xla_loss(kk):
        eq = CahnHilliard2DPeriodic(
            domain, kk[:, None, None], mu, lambda c: jnp.ones_like(c),
            derivs="fd",
        )
        solver = SemiImplicitFourierSpectral(
            **prepare_solver_params(SemiImplicitFourierSpectral, {"A": 1.0}, eq)
        )
        y1 = evolve(solver, eq.rhs, u, 0.0, 1e-3, n_sub)
        return jnp.sum(y1**2)

    xla_grad = _scalarize(xla_loss)

    def rate(fn):
        jax.block_until_ready(fn(kap))
        t0 = time.perf_counter()
        runs = 10
        out = None
        for _i in range(runs):
            out = fn(kap)
        jax.block_until_ready(out)
        dt = time.perf_counter() - t0
        return B * n_sub * runs / dt

    fused_g = rate(fused_grad)
    if fused_g:
        _emit_partial({"fused_grad_env_substeps_per_s": round(fused_g, 1)})
    xla_g = rate(xla_grad)
    if not (fused_g and xla_g):
        return None
    return {
        "fused_grad_env_substeps_per_s": round(fused_g, 1),
        "xla_grad_env_substeps_per_s": round(xla_g, 1),
        "fused_vs_xla_speedup": round(fused_g / xla_g, 2),
        "mfu": None,
        "mfu_note": "backward pass is the XLA FFT oracle's VJP",
    }


# (worker, per-config timeout seconds), in run order.
CONFIG_REGISTRY = {
    "flagship": (run_flagship, 300),
    "gpe_strang_128x128_256envs": (run_gpe128, 150),
    "train_grad_128x128_4096envs": (run_train_grad_128, 150),
    "ppo_64x64_4096envs": (run_ppo, 280),
    "sbm_bv_64x64_1024envs": (run_sbm_bv, 120),
    "gpe_rot_64x64_512batch": (run_gpe_rot, 220),
    "ch3d_mobility_32cubed_256batch": (run_ch3d_mobility, 180),
    "train_grad_64x64_1024envs": (run_train_grad, 240),
    "ch3d_32cubed_256batch_substeps": (run_ch3d, 180),
    "gpe_strang_64x64_1024envs": (run_gpe64, 180),
    "ac_64x64_4096envs": (run_ac64, 120),
    "ch_128x128_1024envs": (run_ch128, 120),
    "ch_256x256_256envs": (run_ch256, 130),
    "bv_xla_64": (run_bv_xla_64, 140),
    "bv_xla_48": (run_bv_xla_48, 110),
}


_CHILD_CONFIG = [None]


def _emit_partial(data: dict):
    """Flush an interim cumulative fragment from inside a config worker.

    If the orchestrator later kills this child on timeout, the LAST
    parseable fragment on its (captured) stdout still counts as a partial
    capture — long multi-measurement configs call this after each stage so
    a timeout costs only the unfinished tail, not everything.
    """
    if _CHILD_CONFIG[0] is not None and data:
        print(json.dumps({"config": _CHILD_CONFIG[0], "ok": True,
                          "data": data}), flush=True)


def _child_main(name):
    from pde_opt_jax.utils.compile_cache import enable_compile_cache

    # Persistent compilation cache: each config child compiles from scratch
    # otherwise.
    enable_compile_cache()
    _CHILD_CONFIG[0] = name
    fn, _cap = CONFIG_REGISTRY[name]
    data = fn()
    print(json.dumps({"config": name, "ok": data is not None, "data": data}),
          flush=True)


# --------------------------------------------------------------------------
# Orchestrator (jax-free).
# --------------------------------------------------------------------------


def _run_child(name, timeout_s):
    """Run one config subprocess to its end; returns (ok, data_or_reason).

    ``subprocess.run`` waits for the child to exit (or kills it at the
    timeout) before returning, so children never overlap on the GPU."""
    try:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--config", name],
            capture_output=True, text=True, timeout=timeout_s,
            cwd=os.path.dirname(os.path.abspath(__file__)),
        )
    except subprocess.TimeoutExpired as e:
        # The killed child's stdout is attached to the exception: its last
        # interim fragment (see _emit_partial) is still a valid capture.
        out = e.stdout or ""
        if isinstance(out, bytes):
            out = out.decode(errors="replace")
        for line in reversed(out.strip().splitlines()):
            try:
                frag = json.loads(line)
            except (json.JSONDecodeError, ValueError):
                continue
            if (isinstance(frag, dict) and frag.get("config") == name
                    and frag.get("ok") and frag.get("data")):
                return True, {**frag["data"],
                              "partial": f"timeout>{int(timeout_s)}s"}
        return False, {"skipped": f"timeout>{int(timeout_s)}s"}
    for line in reversed(proc.stdout.strip().splitlines()):
        try:
            frag = json.loads(line)
        except (json.JSONDecodeError, ValueError):
            continue
        if isinstance(frag, dict) and frag.get("config") == name:
            if frag.get("ok") and frag.get("data") is not None:
                return True, frag["data"]
            return False, {"skipped": "non-finite-or-empty"}
    err = (proc.stderr or "").strip().splitlines()
    tail = err[-1][:180] if err else f"rc={proc.returncode}"
    return False, {"error": tail}


def main():
    t0 = time.perf_counter()

    def remaining():
        return BUDGET_S + GRACE_S - (time.perf_counter() - t0)

    ok, flag = _run_child("flagship", min(CONFIG_REGISTRY["flagship"][1],
                                          remaining()))
    if not ok or not flag.get("rate"):
        print(json.dumps({
            "metric": "BENCH INVALID: flagship failed",
            "value": 0.0, "unit": "env-steps/s", "vs_baseline": 0.0,
            "detail": flag,
        }))
        sys.exit(1)

    rate = flag["rate"]
    out = {
        "metric": (
            f"env-steps/s, {GRID}x{GRID} Cahn-Hilliard control env "
            f"({flag['num_envs']} envs, {SUBSTEPS} SIF substeps/step, "
            f"{flag['platform']})"
        ),
        "value": round(rate, 1),
        "unit": "env-steps/s",
        "vs_baseline": round(rate / 1e6, 4),
        "device": flag["device"],
    }

    # Model-FLOP and HBM shares of the flagship against the card's peaks.
    peak_flops, peak_bw = flag["peak_flops"], flag["peak_bw"]
    f_sub = _cas_substep_flops(GRID, GRID)
    achieved_flops = rate * SUBSTEPS * f_sub
    # HBM: the macro reads+writes the field once per macro-step; obs /
    # reward / reset add ~2 more field passes.
    bytes_per_step = 4 * GRID * GRID * 4
    achieved_bw = rate * bytes_per_step
    out["flops_model"] = {
        "flops_per_env_substep": f_sub,
        "achieved_tflops": round(achieved_flops / 1e12, 1),
        "mfu": round(achieved_flops / peak_flops, 4),
        "achieved_hbm_gbps": round(achieved_bw / 1e9, 1),
        "hbm_util": round(achieved_bw / peak_bw, 4),
    }

    configs = {}
    for name, (_fn, cap) in CONFIG_REGISTRY.items():
        if name == "flagship":
            continue
        if time.perf_counter() - t0 > BUDGET_S:
            configs[name] = {"skipped": "budget"}
            continue
        tc = time.perf_counter()
        _ok, data = _run_child(name, min(cap, max(10.0, remaining())))
        if isinstance(data, dict):
            data = {**data, "elapsed_s": round(time.perf_counter() - tc, 1)}
            # Every captured record carries an mfu (or an explicit null +
            # reason).
            if "mfu" not in data and not ("skipped" in data
                                          or "error" in data):
                data["mfu"] = None
                data.setdefault(
                    "mfu_note",
                    "partial capture before the config's MFU stage "
                    "(XLA comparison fragment)",
                )
        configs[name] = data

    # Merge the two BV subprocesses into one record.
    bv = {}
    for short, full in (("xla_64", "bv_xla_64"), ("xla_48", "bv_xla_48")):
        frag = configs.pop(full, None)
        if isinstance(frag, dict) and "env_steps_per_s" in frag:
            bv[f"{short}_env_steps_per_s"] = frag["env_steps_per_s"]
        elif frag is not None:
            bv[short] = frag
    if bv:
        configs["bv_2048envs"] = bv
    out["configs"] = configs
    out["bench_wallclock_s"] = round(time.perf_counter() - t0, 1)

    print(json.dumps(out))


if __name__ == "__main__":
    if len(sys.argv) >= 3 and sys.argv[1] == "--config":
        _child_main(sys.argv[2])
    else:
        main()
