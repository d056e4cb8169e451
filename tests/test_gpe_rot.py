"""Rotating-frame GPE via directional split-step (the solver the reference lacks)."""

import jax
import jax.numpy as jnp
import numpy as np

import pde_opt_jax as p
from pde_opt_jax.ops.steppers import DirectionalSplitting
from pde_opt_jax.utils import density, initialize_Psi

N = 64


def _setup(omega):
    Lx = 20.0
    domain = p.Domain((N, N), ((-Lx / 2, Lx / 2), (-Lx / 2, Lx / 2)),
                      dtype=jnp.float64)
    k = 500.0
    eq = p.GPE2DTSRot(domain, k, 0.0, omega)
    psi0 = initialize_Psi(N, width=14, vortexnumber=0).astype(jnp.complex128)
    psi0 = psi0 / jnp.sqrt(jnp.sum(density(psi0)) * domain.dx[0] ** 2)
    return domain, eq, psi0


def _imaginary_time(domain, eq, psi0, n_steps=4000, dt=2e-4):
    stepper = DirectionalSplitting(eq.A_terms, eq.B_terms, domain.dx[0],
                                   time_scale=-1j)
    return p.evolve(stepper, lambda y, t: y, psi0, 0.0, dt, n_steps)


def test_nonrotating_ground_state_matches_isotropic_strang():
    """Ω=0: x/y-sweep splitting must agree with the isotropic kinetic split."""
    domain, eq, psi0 = _setup(omega=0.0)
    psi_dir = _imaginary_time(domain, eq, psi0)

    ctrl = p.GPE2DTSControl(domain, eq.k, 0.0, lambda t, x, y: 0.0,
                            trap_factor=1.0, kinetic=True)
    strang = p.StrangSplitting(ctrl.A_term, domain.dx[0], ctrl.fft, ctrl.ifft, -1j)
    y0 = jnp.stack([psi0.real, psi0.imag], axis=-1)
    yT = p.evolve(strang, ctrl.B_terms, y0, 0.0, 2e-4, 4000)
    psi_strang = yT[..., 0] + 1j * yT[..., 1]

    np.testing.assert_allclose(
        np.asarray(density(psi_dir)), np.asarray(density(psi_strang)),
        rtol=1e-3, atol=1e-5,
    )


def test_rotating_ground_state_normalized_and_finite():
    domain, eq, psi0 = _setup(omega=0.3)
    psi = _imaginary_time(domain, eq, psi0, n_steps=2000)
    assert bool(jnp.isfinite(psi.real).all() and jnp.isfinite(psi.imag).all())
    norm = float(jnp.sum(density(psi)) * domain.dx[0] ** 2)
    # The trailing imaginary-time half-sweeps after the mid-step
    # renormalization damp the norm slightly; it re-projects next step.
    np.testing.assert_allclose(norm, 1.0, rtol=1e-3)
    # Rotation must actually change the state vs Ω=0.
    _, eq0, _ = _setup(omega=0.0)
    psi0_gs = _imaginary_time(domain, eq0, psi0, n_steps=2000)
    assert float(jnp.max(jnp.abs(density(psi) - density(psi0_gs)))) > 1e-6


def test_directional_split_batched():
    domain, eq, psi0 = _setup(omega=0.2)
    batch = jnp.stack([psi0, psi0 * jnp.exp(0.3j)])
    stepper = DirectionalSplitting(eq.A_terms, eq.B_terms, domain.dx[0],
                                   time_scale=-1j)
    out = p.evolve(stepper, lambda y, t: y, batch, 0.0, 2e-4, 50)
    assert out.shape == (2, N, N)
    single = p.evolve(stepper, lambda y, t: y, psi0, 0.0, 2e-4, 50)
    np.testing.assert_allclose(np.asarray(density(out[0])),
                               np.asarray(density(single)), rtol=1e-8, atol=1e-12)


def test_no_complex_constants_on_equation_or_stepper():
    """The rotating-frame equation/stepper must not hold complex ndarray
    attributes (they would be embedded as jit constants, requiring a
    host->device complex transfer) and DirectionalSplitting construction
    must not execute eager device ops.  Complex values are formed in-trace
    from real constants."""
    domain, eq, _ = _setup(0.9)
    for name, val in vars(eq).items():
        if isinstance(val, (np.ndarray, jnp.ndarray)):
            assert not np.iscomplexobj(val), (
                f"GPE2DTSRot.{name} is a complex array attribute")
    stepper = DirectionalSplitting(eq.A_terms, eq.B_terms, domain.dx[0],
                                   time_scale=-1j)
    assert stepper.normalize is True   # host-side imag check, no jnp call
    for name, val in vars(stepper).items():
        assert not (isinstance(val, jnp.ndarray)), (
            f"DirectionalSplitting.{name} is a device array (eager op at "
            f"construction)")
