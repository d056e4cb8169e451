"""Fixed-trajectory parity against committed golden fixtures.

The goldens (``tests/goldens/*.npz``, generated once by
``scripts/gen_goldens.py``) are pure-numpy float64 re-derivations of the
reference solver semantics — the semi-implicit Fourier-spectral step
(``/root/reference/pde_opt/numerics/solvers.py:56-70``) over the reference's
spectral and conservative-FD Cahn-Hilliard RHS forms
(``cahn_hilliard.py:82-109``), and the Strang split step with per-step L2
renormalization (``solvers.py:99-122``) — advanced from committed initial
conditions.  These tests integrate the SAME initial conditions through this
framework's steppers at float64 and assert array-level agreement at every
save point, making BASELINE's "exact fixed-seed trajectory match at matched
grid/dt" an executable gate rather than a design claim.

(The reference's own runtime stack is not installed in this image, so the
oracle is an independent numpy implementation of its cited update formulas
rather than a literal diffrax run.)
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pde_opt_jax.grid import Domain
from pde_opt_jax.models.cahn_hilliard import CahnHilliard2DPeriodic
from pde_opt_jax.ops.integrate import evolve
from pde_opt_jax.ops.steppers import SemiImplicitFourierSpectral, StrangSplitting
from pde_opt_jax.utils.compat import prepare_solver_params

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")


def mu(c):
    return c**3 - c


def D(c):
    return 1.0 + 0.1 * c**2


@pytest.mark.parametrize("fname,derivs", [
    ("ch2d_sif_fourier.npz", "fourier"),
    ("ch2d_sif_fd.npz", "fd"),
])
def test_ch2d_sif_trajectory_matches_golden(fname, derivs):
    z = np.load(os.path.join(GOLDENS, fname))
    N, dx = int(z["N"]), float(z["dx"])
    dt, A = float(z["dt"]), float(z["A"])
    n_steps, save_every = int(z["n_steps"]), int(z["save_every"])

    L = N * dx
    domain = Domain((N, N), ((-L / 2, L / 2), (-L / 2, L / 2)),
                    "dimensionless", dtype=jnp.float64)
    # use_rfft=False reproduces the reference's full-fftn semantics exactly.
    eq = CahnHilliard2DPeriodic(domain, float(z["kappa"]), mu, D,
                                derivs=derivs, use_rfft=False)
    solver = SemiImplicitFourierSpectral(
        **prepare_solver_params(SemiImplicitFourierSpectral, {"A": A}, eq)
    )

    u = jnp.asarray(z["u0"], jnp.float64)
    traj = [np.asarray(u)]
    for _ in range(n_steps // save_every):
        u = evolve(solver, eq.rhs, u, 0.0, dt, save_every)
        traj.append(np.asarray(u))

    np.testing.assert_allclose(np.stack(traj), z["traj"], rtol=0, atol=1e-10)


def test_strang_imaginary_time_trajectory_matches_golden():
    z = np.load(os.path.join(GOLDENS, "gpe_strang_imag.npz"))
    dx, dt = float(z["dx"]), float(z["dt"])
    n_steps, save_every = int(z["n_steps"]), int(z["save_every"])
    V = jnp.asarray(z["V"], jnp.float64)
    g = float(z["g"])

    solver = StrangSplitting(
        A_term=jnp.asarray(z["A_term"]),
        dx=dx,
        fft=lambda a: jnp.fft.fftn(a, axes=(-2, -1)),
        ifft=lambda a: jnp.fft.ifftn(a, axes=(-2, -1)),
        time_scale=-1j,
    )

    def rhs(y, t):
        # B term, stacked (Re, Im) as the stepper contract requires;
        # evaluated at the pre-step state (matching the reference).
        psi2 = y[..., 0] ** 2 + y[..., 1] ** 2
        b = -1j * (V + g * psi2)
        return jnp.stack([b.real, b.imag], axis=-1)

    psi0 = np.asarray(z["psi0"])
    y = jnp.stack(
        [jnp.asarray(psi0.real, jnp.float64), jnp.asarray(psi0.imag, jnp.float64)],
        axis=-1,
    )
    traj = [psi0]
    for _ in range(n_steps // save_every):
        y = evolve(solver, rhs, y, 0.0, dt, save_every)
        traj.append(np.asarray(y[..., 0] + 1j * y[..., 1]))

    np.testing.assert_allclose(np.stack(traj), z["traj"], rtol=0, atol=1e-10)


def test_ac2d_tsit5_trajectory_matches_golden():
    """Allen-Cahn FD rhs + fixed-dt Tsit5 vs the numpy golden (the
    reference's Tsit5 Allen-Cahn path, tests/test_solvers.py:81)."""
    from pde_opt_jax.models.allen_cahn import AllenCahn2DPeriodic
    from pde_opt_jax.ops.steppers import Tsit5

    z = np.load(os.path.join(GOLDENS, "ac2d_tsit5_fd.npz"))
    N, dx = int(z["N"]), float(z["dx"])
    dt = float(z["dt"])
    n_steps, save_every = int(z["n_steps"]), int(z["save_every"])

    L = N * dx
    domain = Domain((N, N), ((-L / 2, L / 2), (-L / 2, L / 2)),
                    "dimensionless", dtype=jnp.float64)
    eq = AllenCahn2DPeriodic(domain, float(z["kappa"]), mu,
                             R=lambda c: 1.0 + 0.1 * c**2, derivs="fd")
    u = jnp.asarray(z["u0"], jnp.float64)
    got = [np.asarray(u)]
    for _ in range(n_steps // save_every):
        u = evolve(Tsit5(), eq.rhs, u, 0.0, dt, save_every)
        got.append(np.asarray(u))
    np.testing.assert_allclose(np.stack(got), z["traj"], rtol=0, atol=1e-12)


def test_bv_constant_current_trajectory_and_voltage_match_golden():
    """Galvanostatic Butler-Volmer Allen-Cahn (the closed-form constant-
    current closure + get_voltage, reference allen_cahn.py:213-281) vs the
    numpy golden, field AND voltage trace, classical RK4."""
    from pde_opt_jax.models.allen_cahn import (
        AllenCahn2DPeriodicButlerVolmerConstantCurrent,
    )
    from pde_opt_jax.ops.steppers import RK4

    z = np.load(os.path.join(GOLDENS, "bv_cc_rk4.npz"))
    N, dx = int(z["N"]), float(z["dx"])
    dt = float(z["dt"])
    n_steps, save_every = int(z["n_steps"]), int(z["save_every"])

    L = N * dx
    domain = Domain((N, N), ((-L / 2, L / 2), (-L / 2, L / 2)),
                    "dimensionless", dtype=jnp.float64)
    clip = lambda c: jnp.clip(c, 1e-4, 1 - 1e-4)
    eq = AllenCahn2DPeriodicButlerVolmerConstantCurrent(
        domain, float(z["kappa"]),
        mu=lambda c: jnp.log(clip(c) / (1 - clip(c))) + 3.0 * (1.0 - 2.0 * c),
        j0=lambda c: jnp.sqrt(jnp.clip(c * (1 - c), 1e-6, None)),
        alpha=float(z["alpha"]), Crate=float(z["Crate"]),
    )
    u = jnp.asarray(z["u0"], jnp.float64)
    got_traj = [np.asarray(u)]
    got_volts = [float(eq.get_voltage(u))]
    for k in range(n_steps // save_every):
        u = evolve(RK4(), eq.rhs, u, k * save_every * dt, dt, save_every)
        got_traj.append(np.asarray(u))
        got_volts.append(float(eq.get_voltage(u)))
    np.testing.assert_allclose(np.stack(got_traj), z["traj"],
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(np.asarray(got_volts), z["volts"],
                               rtol=0, atol=1e-12)


def test_gpe_rot_directional_split_trajectory_matches_golden():
    """Rotating-frame GPE (reference gross_pitaevskii.py:84-131 A/B terms)
    integrated by DirectionalSplitting in imaginary time vs the numpy
    golden, at every save point."""
    from pde_opt_jax.models.gross_pitaevskii import GPE2DTSRot
    from pde_opt_jax.ops.steppers import DirectionalSplitting

    z = np.load(os.path.join(GOLDENS, "gpe_rot_dirsplit.npz"))
    N, L = int(z["N"]), float(z["L"])
    dt = float(z["dt"])
    n_steps, save_every = int(z["n_steps"]), int(z["save_every"])

    domain = Domain((N, N), ((-L / 2, L / 2), (-L / 2, L / 2)),
                    "dimensionless", dtype=jnp.float64)
    eq = GPE2DTSRot(domain, float(z["k"]), float(z["e"]), float(z["omega"]))
    stepper = DirectionalSplitting(eq.A_terms, eq.B_terms, domain.dx[0],
                                   time_scale=-1j)
    psi = jnp.asarray(z["psi0"], jnp.complex128)
    got = [np.asarray(psi)]
    for _ in range(n_steps // save_every):
        psi = evolve(stepper, lambda y, t: y, psi, 0.0, dt, save_every)
        got.append(np.asarray(psi))
    np.testing.assert_allclose(np.stack(got), z["traj"], rtol=0, atol=1e-10)
