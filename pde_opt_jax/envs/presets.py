"""Preset environment configurations.

The flagship benchmark config — the driver north star's "64×64 Cahn-Hilliard
control env, 4096 envs" (BASELINE.json) — lives here so bench.py, the graft
entry point, and tests all build exactly the same environment.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .. import grid as gridmod
from ..models.cahn_hilliard import CahnHilliard2DPeriodic
from ..ops.steppers import RK4, SemiImplicitFourierSpectral
from .vector_env import VectorPDEEnv

__all__ = [
    "make_cahn_hilliard_control_env",
    "make_allen_cahn_control_env",
    "make_gpe_control_env",
    "make_gpe_rot_control_env",
    "make_butler_volmer_control_env",
    "make_sbm_butler_volmer_control_env",
]


def make_cahn_hilliard_control_env(
    num_envs: int = 4096,
    grid_size: int = 64,
    substeps: int = 10,
    end_time: float = 1.0,
    step_dt: float = 0.01,
    dtype=jnp.float32,
    auto_reset: bool = True,
    derivs: str = "fd",
    vectorized_control: bool = True,
    spectral_solve: str = "fused",
    obs_downsample: int = 1,
    fused_epilogue: bool | None = None,
) -> VectorPDEEnv:
    """64×64 Cahn-Hilliard control fleet: the agent drives κ (interface width).

    One RL step = ``substeps`` semi-implicit spectral substeps.  The
    observation is the uint8-scaled concentration field; reward is negative
    variance (drive toward uniformity — fighting the spinodal decomposition
    the PDE wants).

    ``spectral_solve``: ``"fused"`` (default) runs all substeps of a step
    in the cas kernel (:mod:`pde_opt_jax.ops.cas_spectral`; grids of 16, 32
    or 64, A = 1), ``"fft"`` the per-substep XLA rfft stepper (any grid,
    A = 0.5), ``"dense"``/``"dense_bf16"`` the fixed-symbol dense-matmul
    solve.

    ``obs_downsample``: average-pool factor applied to the field before the
    uint8 observation (must divide ``grid_size``).  The physics always runs
    at full resolution; a 4x pool turns the 64² observation into 16² — a
    16x cut in the RL learner's conv/memory cost that preserves the
    variance-control signal (the reward is a global statistic).  This is
    the learner-pipeline knob behind the PPO bench config.
    """
    if grid_size % obs_downsample:
        raise ValueError(
            f"obs_downsample={obs_downsample} must divide grid_size={grid_size}"
        )
    L = 0.01 * grid_size
    domain = gridmod.Domain(
        (grid_size, grid_size), ((-L / 2, L / 2), (-L / 2, L / 2)),
        "dimensionless", dtype=dtype,
    )
    kappa_max = 0.01
    if spectral_solve == "fused":
        # Whole-macro-step cas kernel: field and spectrum stay on chip for
        # all substeps, per-env kappa in the implicit denominator.  A=1
        # gives deadbeat high-k damping of matmul rounding noise.
        from ..ops.steppers import FusedSemiImplicitSpectral

        solver_type = FusedSemiImplicitSpectral
        solver_parameters = {"A": 1.0}
    elif spectral_solve in ("dense", "dense_bf16"):
        # Fixed-symbol semi-implicit step: the implicit damping uses
        # kappa_max (an upper bound of the control range), so the spectral
        # solve is one shared dense matmul for the whole fleet.
        import numpy as np

        from ..ops.steppers import SemiImplicitDenseSolve

        kx, ky = domain.fft_mesh()
        symbol = kappa_max * (
            (2 * np.pi * kx) ** 2 + (2 * np.pi * ky) ** 2
        ) ** 2
        solver_type = SemiImplicitDenseSolve
        solver_parameters = {
            "A": 0.5,
            "dense_symbol": symbol,
            "points": domain.points,
            "dtype": "bf16_sqrt" if spectral_solve == "dense" else "bf16",
        }
    elif spectral_solve == "fft":
        solver_type = SemiImplicitFourierSpectral
        solver_parameters = {"A": 0.5}
    else:
        raise ValueError(f"unknown spectral_solve: {spectral_solve!r}")
    ds = int(obs_downsample)

    def observe(y):
        if ds > 1:
            *b, h, w = y.shape
            y = y.reshape(*b, h // ds, ds, w // ds, ds).mean(axis=(-3, -1))
        return jnp.clip(y * 255.0, 0, 255).astype(jnp.uint8)[..., None, :, :]

    # Fused env epilogue (default ON for the fused kernel): reward
    # (-var), the divergence flag and the uint8 obs all come out of the
    # kernel itself instead of 2-3 extra full-field HBM passes.
    # reward_from_stats MUST stay semantically equal to reward_function
    # (-var = -(E[y^2] - E[y]^2)) and the kernel obs to ``observe`` —
    # reset() and the auto-reset branch still use the XLA versions.
    if fused_epilogue is None:
        fused_epilogue = spectral_solve == "fused" and vectorized_control
    ep_cfg = None
    if fused_epilogue:
        ep_cfg = {
            "obs_scale": 255.0,
            "obs_offset": 0.0,
            "obs_downsample": ds,
            # Centered moments around the 0.5 operating point: the same
            # -var formula, but cancellation-free (see cas_spectral).
            "stats_center": 0.5,
            "reward_from_stats": lambda s1, s2, cnt, n: -(
                s2 / n - (s1 / n) ** 2
            ),
            "obs_transform": lambda o: o[..., None, :, :],
        }

    return VectorPDEEnv(
        equation_type=CahnHilliard2DPeriodic,
        domain=domain,
        solver_type=solver_type,
        end_time=end_time,
        step_dt=step_dt,
        numeric_dt=step_dt / substeps,
        state_to_observation_func=observe,
        reward_function=lambda y: -jnp.var(y),
        reset_func=lambda domain, key: jnp.clip(
            0.5 + 0.01 * jax.random.normal(key, domain.points, dtype=dtype), 0.0, 1.0
        ),
        # Control range chosen inside the numerically stable region of the
        # SIF stepper at numeric_dt = step_dt/substeps: κ below ~2e-3 at
        # dt=1e-3 on a dx=0.01 grid under-damps the explicit spinodal term
        # and blows up (verified empirically; see tests/test_env.py).
        reset_control_value=jnp.asarray(0.004, dtype),
        update_control_value=lambda off, old: jnp.clip(
            old + 0.0005 * off[..., 0], 0.002, 0.01
        ),
        # Shape the per-env κ so it broadcasts against (B, H, W) fields in
        # the vectorized (no-vmap) fast path; a scalar κ under vmap gains the
        # same trailing axes harmlessly.
        update_control_parameter=lambda old, new: new[..., None, None],
        action_space_config={"type": "continuous", "shape": (1,)},
        static_equation_parameters={
            "mu": lambda c: c**3 - c,
            "D": lambda c: jnp.ones_like(c),
            "derivs": derivs,
        },
        control_equation_parameter_name="kappa",
        solver_parameters=solver_parameters,
        num_envs=num_envs,
        auto_reset=auto_reset,
        vectorized_control=vectorized_control,
        fused_epilogue=ep_cfg,
    )


def make_allen_cahn_control_env(
    num_envs: int = 4096,
    grid_size: int = 64,
    substeps: int = 10,
    end_time: float = 1.0,
    step_dt: float = 0.01,
    dtype=jnp.float32,
    auto_reset: bool = True,
    vectorized_control: bool = True,
    spectral_solve: str = "fft",
) -> VectorPDEEnv:
    """Allen-Cahn control fleet: the agent drives κ (interface energy).

    Same control protocol as the Cahn-Hilliard flagship but on the
    2nd-order (nonconserved) dynamics, stepped by the per-substep
    semi-implicit spectral stepper (``spectral_solve="fft"``, the only
    solve).
    """
    from ..models.allen_cahn import AllenCahn2DPeriodic

    L = 0.01 * grid_size
    domain = gridmod.Domain(
        (grid_size, grid_size), ((-L / 2, L / 2), (-L / 2, L / 2)),
        "dimensionless", dtype=dtype,
    )
    if spectral_solve != "fft":
        raise ValueError(f"unknown spectral_solve: {spectral_solve!r}")
    solver_type = SemiImplicitFourierSpectral
    solver_parameters = {"A": 1.0}
    return VectorPDEEnv(
        equation_type=AllenCahn2DPeriodic,
        domain=domain,
        solver_type=solver_type,
        end_time=end_time,
        step_dt=step_dt,
        numeric_dt=step_dt / substeps,
        state_to_observation_func=lambda y: jnp.clip(
            (y + 1.0) * 127.5, 0, 255
        ).astype(jnp.uint8)[..., None, :, :],
        # Drive toward a mixed (interface-rich) state: AC wants to coarsen
        # to ±1 phases; reward the agent for keeping variance DOWN.
        reward_function=lambda y: -jnp.var(y),
        reset_func=lambda domain, key: 0.1 * jax.random.normal(
            key, domain.points, dtype=dtype
        ),
        reset_control_value=jnp.asarray(4e-4, dtype),
        update_control_value=lambda off, old: jnp.clip(
            old + 5e-5 * off[..., 0], 1e-4, 1e-3
        ),
        update_control_parameter=lambda old, new: new[..., None, None],
        action_space_config={"type": "continuous", "shape": (1,)},
        static_equation_parameters={
            "mu": lambda c: c**3 - c,
            "R": lambda c: jnp.ones_like(c),
        },
        control_equation_parameter_name="kappa",
        solver_parameters=solver_parameters,
        num_envs=num_envs,
        auto_reset=auto_reset,
        vectorized_control=vectorized_control,
    )


def make_gpe_control_env(
    num_envs: int = 1024,
    grid_size: int = 64,
    substeps: int = 10,
    end_time: float = 2.0,
    step_dt: float = 0.02,
    dtype=jnp.float32,
    auto_reset: bool = True,
    k_interaction: float = 100.0,
    spot_width: float = 1.0,
    box_size: float = 16.0,
    spectral_solve: str = "fft",
) -> VectorPDEEnv:
    """Gross-Pitaevskii control fleet: the agent drives an optical spot.

    The control value is the per-env intensity of a Gaussian light spot at
    the trap center, entering the GPE Hamiltonian through the ``lights``
    potential (the reference's GPE-control capability,
    ``/root/reference/pde_opt/pde_env.py:43-138`` with GPE2DTSControl).
    State is the real-stacked (..., H, W, 2) wavefunction; one RL step is
    ``substeps`` Strang split-step substeps (per-step L2 renormalization,
    reference ``solvers.py:99-122``).  Reward: condensate density pushed
    OUT of the spot region (the agent learns to stir with the light).
    """
    from ..models.gross_pitaevskii import GPE2DTSControl
    from ..ops.steppers import StrangSplitting

    L = box_size
    domain = gridmod.Domain(
        (grid_size, grid_size), ((-L / 2, L / 2), (-L / 2, L / 2)),
        "dimensionless", dtype=dtype,
    )
    X, Y = (jnp.asarray(m, dtype) for m in domain.mesh())
    spot = jnp.exp(-(X**2 + Y**2) / (spot_width**2))       # (H, W)
    dx = float(domain.dx[0])

    def reset_func(domain_, key):
        psi = jnp.exp(-(X**2 + Y**2) / 4.0).astype(dtype)
        noise = 0.02 * jax.random.normal(key, domain_.points, dtype=dtype)
        psi = psi * (1.0 + noise)
        norm = jnp.sqrt(jnp.sum(psi**2) * dx * dx)
        psi = psi / norm
        return jnp.stack([psi, jnp.zeros_like(psi)], axis=-1)

    def make_lights(intensity):
        # intensity: (B,) traced control -> lights(t, x, y) closure whose
        # output broadcasts (B, 1, 1)*(H, W) against (B, H, W) fields.
        def lights(t, x, y):
            return intensity[..., None, None] * spot

        return lights

    def density_in_spot(y):
        rho = y[..., 0] ** 2 + y[..., 1] ** 2               # (H, W)
        return jnp.sum(rho * spot) * dx * dx

    if spectral_solve != "fft":
        raise ValueError(f"unknown spectral_solve: {spectral_solve!r}")
    # fast_evolve merges consecutive A half-steps (midpoint Strang):
    # 2 FFT pairs per substep instead of 4.
    solver_type = StrangSplitting
    solver_parameters = {"time_scale": 1.0, "fast_evolve": True}
    return VectorPDEEnv(
        equation_type=GPE2DTSControl,
        domain=domain,
        solver_type=solver_type,
        end_time=end_time,
        step_dt=step_dt,
        numeric_dt=step_dt / substeps,
        state_to_observation_func=lambda y: jnp.clip(
            (y[..., 0] ** 2 + y[..., 1] ** 2) * 2550.0, 0, 255
        ).astype(jnp.uint8)[..., None, :, :],
        reward_function=lambda y: -density_in_spot(y),
        reset_func=reset_func,
        reset_control_value=jnp.asarray(0.0, dtype),
        update_control_value=lambda off, old: jnp.clip(
            old + 2.0 * off[..., 0], 0.0, 50.0
        ),
        update_control_parameter=lambda old, new: make_lights(new),
        action_space_config={"type": "continuous", "shape": (1,)},
        static_equation_parameters={
            "k": k_interaction,
            "e": 0.0,
            "trap_factor": 1.0,
            "kinetic": True,
        },
        control_equation_parameter_name="lights",
        solver_parameters=solver_parameters,
        num_envs=num_envs,
        auto_reset=auto_reset,
        vectorized_control=True,
    )


def make_gpe_rot_control_env(
    num_envs: int = 512,
    grid_size: int = 64,
    substeps: int = 10,
    end_time: float = 1.0,
    step_dt: float = 0.01,
    dtype=jnp.float32,
    auto_reset: bool = True,
    k_interaction: float = 500.0,
    omega: float = 0.8,
    box_size: float = 20.0,
    stir_radius: float = 2.5,
    stir_width: float = 1.0,
    amp_max: float = 10.0,
    action_gain: float = 1.0,
    vortex_weight: float = 1.0,
    lz_weight: float = 10.0,
    spectral_solve: str = "fused",
) -> VectorPDEEnv:
    """Rotating-frame GPE stirring fleet: the agent nucleates vortices.

    The 6th env family — the reference defines the rotating-frame equation
    (``/root/reference/pde_opt/numerics/equations/gross_pitaevskii.py:84-131``)
    and a generic env wrapper able to hold it (``pde_env.py:43-138``) but
    ships no solver for it; here :class:`~pde_opt_jax.ops.steppers.FusedRotatingSplitting`
    integrates the ADI split with precomputed matmul sweeps
    (``spectral_solve="fft"`` selects the FFT
    :class:`~pde_opt_jax.ops.steppers.DirectionalSplitting` path).

    The control is the per-env intensity of an off-center Gaussian stirring
    beam (a static spot in the rotating frame = a co-rotating stirrer),
    entering the Hamiltonian through the ``lights`` potential.  Reward =
    ``vortex_weight``·(amplitude-gated plaquette vortex census, the
    jit-safe :func:`pde_opt_jax.utils.rl.vortex_winding`) +
    ``lz_weight``·⟨L_z⟩ (smooth shaping signal: stirring spins the
    condensate up before the first vortex enters).  One RL step =
    ``substeps`` ADI substeps with per-substep L² renormalization.
    """
    from ..models.gross_pitaevskii import GPE2DTSRot
    from ..ops.steppers import DirectionalSplitting, FusedRotatingSplitting
    from ..utils.rl import vortex_winding

    L = box_size
    domain = gridmod.Domain(
        (grid_size, grid_size), ((-L / 2, L / 2), (-L / 2, L / 2)),
        "dimensionless", dtype=dtype,
    )
    X, Y = (jnp.asarray(m, dtype) for m in domain.mesh())
    spot = jnp.exp(
        -((X - stir_radius) ** 2 + Y**2) / (stir_width**2)
    )                                                     # (H, W)
    dx = float(domain.dx[0])
    cdtype = jnp.complex64 if dtype == jnp.float32 else jnp.complex128

    def reset_func(domain_, key):
        psi = jnp.exp(-(X**2 + Y**2) / 16.0)
        noise = 0.05 * jax.random.normal(key, domain_.points, dtype=dtype)
        psi = (psi * (1.0 + noise)).astype(cdtype)
        norm = jnp.sqrt(jnp.sum(jnp.abs(psi) ** 2) * dx * dx)
        return psi / norm

    def make_lights(amp):
        def lights(t, x, y):
            return amp[..., None, None] * spot

        return lights

    def reward_fn(psi):
        # Per-env (vmapped): gated vortex census + angular momentum.
        rho = jnp.abs(psi) ** 2
        scale = jax.lax.rsqrt(jnp.max(rho) + 1e-12)
        w = vortex_winding(psi * scale, amp_thresh=0.05)
        n_vortices = jnp.sum(jnp.abs(w)).astype(dtype)
        dpsi_dx = (jnp.roll(psi, -1, -2) - jnp.roll(psi, 1, -2)) / (2 * dx)
        dpsi_dy = (jnp.roll(psi, -1, -1) - jnp.roll(psi, 1, -1)) / (2 * dx)
        lz = jnp.sum(
            jnp.imag(jnp.conj(psi) * (X * dpsi_dy - Y * dpsi_dx))
        ) * dx * dx
        return vortex_weight * n_vortices + lz_weight * lz.astype(dtype)

    if spectral_solve == "fused":
        solver_type = FusedRotatingSplitting
    elif spectral_solve == "fft":
        solver_type = DirectionalSplitting
    else:
        raise ValueError(f"unknown spectral_solve: {spectral_solve!r}")
    return VectorPDEEnv(
        equation_type=GPE2DTSRot,
        domain=domain,
        solver_type=solver_type,
        end_time=end_time,
        step_dt=step_dt,
        numeric_dt=step_dt / substeps,
        state_to_observation_func=lambda y: jnp.clip(
            (jnp.abs(y) ** 2) * 2550.0, 0, 255
        ).astype(jnp.uint8)[..., None, :, :],
        reward_function=reward_fn,
        reset_func=reset_func,
        reset_control_value=jnp.asarray(0.0, dtype),
        update_control_value=lambda off, old: jnp.clip(
            old + action_gain * off[..., 0], 0.0, amp_max
        ),
        update_control_parameter=lambda old, new: make_lights(new),
        action_space_config={"type": "continuous", "shape": (1,)},
        static_equation_parameters={
            "k": k_interaction,
            "e": 0.0,
            "omega": omega,
        },
        control_equation_parameter_name="lights",
        solver_parameters={"time_scale": 1.0, "normalize": True},
        num_envs=num_envs,
        auto_reset=auto_reset,
        vectorized_control=True,
    )


def make_butler_volmer_control_env(
    num_envs: int = 1024,
    grid_size: int = 64,
    substeps: int = 10,
    end_time: float = 0.2,
    step_dt: float = 5e-3,
    dtype=jnp.float32,
    auto_reset: bool = True,
    kappa: float = 5e-4,
    method: str = "rk4",
) -> VectorPDEEnv:
    """Galvanostatic Butler-Volmer charging fleet: the agent drives the C-rate.

    Each env is a phase-separating electrode particle lithiating under the
    constant-current closure (per-env global integrals stay per-env under
    the leading batch axis); the action nudges the applied C-rate.  Reward
    trades charging progress against non-uniformity — the agent learns a
    charging protocol that fills the particle while suppressing phase
    separation, the classic electrochemistry control problem the reference's
    BV family exists for (``/root/reference/pde_opt/numerics/equations/
    allen_cahn.py:213-281``).  One RL step = ``substeps`` RK4 substeps.
    """
    from ..models.allen_cahn import (
        AllenCahn2DPeriodicButlerVolmerConstantCurrent,
    )

    if method != "rk4":
        raise ValueError(f"unknown method: {method!r}")
    domain = gridmod.Domain(
        (grid_size, grid_size), ((-0.5, 0.5), (-0.5, 0.5)),
        "dimensionless", dtype=dtype,
    )
    clip = lambda c: jnp.clip(c, 1e-4, 1 - 1e-4)

    return VectorPDEEnv(
        equation_type=AllenCahn2DPeriodicButlerVolmerConstantCurrent,
        domain=domain,
        solver_type=RK4,
        end_time=end_time,
        step_dt=step_dt,
        numeric_dt=step_dt / substeps,
        state_to_observation_func=lambda y: jnp.clip(y * 255.0, 0, 255).astype(
            jnp.uint8
        )[..., None, :, :],
        # Charge fast, stay uniform: filling progress minus a phase-
        # separation penalty.
        reward_function=lambda y: jnp.mean(y) - 10.0 * jnp.var(y),
        reset_func=lambda domain_, key: jnp.clip(
            0.05 + 0.005 * jax.random.normal(key, domain_.points, dtype=dtype),
            0.01, 0.99,
        ),
        reset_control_value=jnp.asarray(1.0, dtype),
        update_control_value=lambda off, old: jnp.clip(
            old + 0.2 * off[..., 0], 0.2, 3.0
        ),
        update_control_parameter=lambda old, new: new[..., None, None],
        action_space_config={"type": "continuous", "shape": (1,)},
        static_equation_parameters={
            "kappa": kappa,
            "mu": lambda c: jnp.log(clip(c) / (1 - clip(c)))
            + 3.0 * (1.0 - 2.0 * c),
            "j0": lambda c: jnp.sqrt(jnp.clip(c * (1 - c), 1e-6, None)),
            "alpha": 0.5,
        },
        control_equation_parameter_name="Crate",
        solver_parameters={},
        num_envs=num_envs,
        auto_reset=auto_reset,
        vectorized_control=True,
    )


def make_sbm_butler_volmer_control_env(
    num_envs: int = 1024,
    grid_size: int = 64,
    substeps: int = 10,
    end_time: float = 0.2,
    step_dt: float = 5e-3,
    dtype=jnp.float32,
    auto_reset: bool = True,
    kappa: float = 5e-4,
    particle_radius: float = 0.35,
    interface_width: float = 0.04,
    smooth_geometry: bool = False,
    method: str = "rk4",
) -> VectorPDEEnv:
    """Smoothed-boundary galvanostatic charging fleet (irregular particle).

    The reference's flagship physics workload
    (``/root/reference/pde_opt/numerics/equations/allen_cahn.py:284-383``,
    vmapped in ``notebooks/run_butler_volmer_sbm.ipynb``): each env is a
    DISK-shaped electrode particle embedded in the periodic box via the
    smoothed-boundary level set ψ — the SBM chemical potential uses
    ψ-weighted fluxes and the galvanostatic closure integrates over ψ, so
    the charge balance holds on the particle, not the box.  The agent
    drives the applied C-rate; reward trades ψ-weighted charging progress
    against ψ-weighted non-uniformity.  One RL step = ``substeps`` RK4
    substeps of the XLA roll-stencil path (``method="rk4"``, the only
    method).

    ``smooth_geometry=True`` derives ψ by running the Shape smoothing flow
    on the binary disk mask (the reference pipeline, one-time cost at
    construction); the default analytic tanh profile is equivalent for a
    disk and loads instantly (golden-gated in ``tests/test_sbm_bv.py``).
    """
    from ..models.allen_cahn import (
        AllenCahn2DSmoothedBoundaryButlerVolmerConstantCurrent,
    )

    if method != "rk4":
        raise ValueError(f"unknown method: {method!r}")
    domain = gridmod.Domain(
        (grid_size, grid_size), ((-0.5, 0.5), (-0.5, 0.5)),
        "dimensionless", dtype=dtype,
    )
    X, Y = (jnp.asarray(m, dtype) for m in domain.mesh())
    r = jnp.sqrt(X**2 + Y**2)
    if smooth_geometry:
        from ..geometry import Shape

        shape = Shape(
            (r < particle_radius).astype(dtype), dx=domain.dx,
            smooth_epsilon=4.0 * float(domain.dx[0]),
        )
        psi = shape.smooth.astype(dtype)
    else:
        psi = 0.5 * (1.0 + jnp.tanh((particle_radius - r) / interface_width))
        psi = jnp.where(psi < 0.001, 0.001, psi)
        psi = jnp.where(psi > 0.99, 1.0, psi).astype(dtype)
    psi_sum = jnp.sum(psi)
    clip = lambda c: jnp.clip(c, 1e-4, 1 - 1e-4)

    def psi_mean(y):
        return jnp.sum(psi * y, axis=(-2, -1)) / psi_sum

    def psi_var(y):
        m = psi_mean(y)[..., None, None]
        return jnp.sum(psi * (y - m) ** 2, axis=(-2, -1)) / psi_sum

    return VectorPDEEnv(
        equation_type=AllenCahn2DSmoothedBoundaryButlerVolmerConstantCurrent,
        domain=domain,
        solver_type=RK4,
        end_time=end_time,
        step_dt=step_dt,
        numeric_dt=step_dt / substeps,
        # Observe the particle only: psi-masked concentration.
        state_to_observation_func=lambda y: jnp.clip(
            y * psi * 255.0, 0, 255
        ).astype(jnp.uint8)[..., None, :, :],
        # Charge the PARTICLE fast, keep the PARTICLE uniform.
        reward_function=lambda y: psi_mean(y) - 10.0 * psi_var(y),
        reset_func=lambda domain_, key: jnp.clip(
            0.05 + 0.005 * jax.random.normal(key, domain_.points, dtype=dtype),
            0.01, 0.99,
        ),
        reset_control_value=jnp.asarray(1.0, dtype),
        update_control_value=lambda off, old: jnp.clip(
            old + 0.2 * off[..., 0], 0.2, 3.0
        ),
        update_control_parameter=lambda old, new: new[..., None, None],
        action_space_config={"type": "continuous", "shape": (1,)},
        static_equation_parameters={
            "kappa": kappa,
            "f": lambda c: 3.0 * c * (1.0 - c),
            "mu": lambda c: jnp.log(clip(c) / (1 - clip(c)))
            + 3.0 * (1.0 - 2.0 * c),
            "j0": lambda c: jnp.sqrt(jnp.clip(c * (1 - c), 1e-6, None)),
            "alpha": 0.5,
            "psi": psi,
        },
        control_equation_parameter_name="Crate",
        solver_parameters={},
        num_envs=num_envs,
        auto_reset=auto_reset,
        vectorized_control=True,
    )
