"""Matmul ADI rotating-GPE macro vs the FFT DirectionalSplitting oracle."""

import jax
import jax.numpy as jnp
import numpy as np

import pde_opt_jax as p
from pde_opt_jax.ops.gpe_rot_fast import make_rot_adi_macro
from pde_opt_jax.ops.steppers import DirectionalSplitting
from pde_opt_jax.utils import density, initialize_Psi

N = 32


def _setup(omega, vortexnumber=1):
    L = 16.0
    domain = p.Domain((N, N), ((-L / 2, L / 2), (-L / 2, L / 2)),
                      dtype=jnp.float64)
    eq = p.GPE2DTSRot(domain, 200.0, 0.05, omega)
    psi0 = initialize_Psi(N, width=10,
                          vortexnumber=vortexnumber).astype(jnp.complex64)
    psi0 = psi0 / jnp.sqrt(jnp.sum(density(psi0)) * domain.dx[0] ** 2)
    return domain, eq, psi0


def _both(omega, time_scale, n_steps, dt=1e-3, batch=False):
    domain, eq, psi0 = _setup(omega)
    if batch:
        psi0 = jnp.stack([psi0, 1j * psi0, psi0[::-1]], axis=0)
    stepper = DirectionalSplitting(eq.A_terms, eq.B_terms, domain.dx[0],
                                   time_scale=time_scale)
    ref = p.evolve(stepper, lambda y, t: y, psi0, 0.0, dt, n_steps)
    macro = make_rot_adi_macro(eq.A_terms, eq.B_terms, domain.dx[0], N, N,
                               dt, n_steps, time_scale=time_scale,
                               mats_dtype=jnp.float32)
    fast = macro(psi0)
    return ref, fast


def test_real_time_matches_fft_oracle():
    ref, fast = _both(omega=0.7, time_scale=1.0, n_steps=6)
    np.testing.assert_allclose(np.asarray(fast.real), np.asarray(ref.real),
                               rtol=0, atol=2e-5)
    np.testing.assert_allclose(np.asarray(fast.imag), np.asarray(ref.imag),
                               rtol=0, atol=2e-5)


def test_imaginary_time_matches_fft_oracle_with_renorm():
    ref, fast = _both(omega=0.5, time_scale=-1j, n_steps=8)
    np.testing.assert_allclose(np.asarray(density(fast)),
                               np.asarray(density(ref)),
                               rtol=0, atol=2e-5)


def test_batched_matches_per_element():
    ref, fast = _both(omega=0.6, time_scale=1.0, n_steps=4, batch=True)
    assert fast.shape == ref.shape == (3, N, N)
    np.testing.assert_allclose(np.asarray(fast.real), np.asarray(ref.real),
                               rtol=0, atol=2e-5)


def test_single_step_no_scan_path():
    """n_steps=1 skips the merged inner scan entirely."""
    ref, fast = _both(omega=0.4, time_scale=1.0, n_steps=1)
    np.testing.assert_allclose(np.asarray(fast.real), np.asarray(ref.real),
                               rtol=0, atol=2e-5)


def test_phase_poly_matches_hardware_transcendentals():
    """Degree-7 Taylor B-phase vs hardware exp/cos/sin: sub-f32-ulp on the
    splitting's own |z| << 1 domain (both real and imaginary time)."""
    domain, eq, psi0 = _setup(omega=0.6)
    for ts in (1.0, -1j):
        outs = []
        for poly in (True, False):
            macro = make_rot_adi_macro(eq.A_terms, eq.B_terms, domain.dx[0],
                                       N, N, 1e-3, 5, time_scale=ts,
                                       mats_dtype=jnp.float32,
                                       phase_poly=poly)
            outs.append(macro(psi0))
        np.testing.assert_allclose(np.asarray(outs[0].real),
                                   np.asarray(outs[1].real),
                                   rtol=0, atol=5e-7)
        np.testing.assert_allclose(np.asarray(outs[0].imag),
                                   np.asarray(outs[1].imag),
                                   rtol=0, atol=5e-7)


def test_traced_control_in_B_terms():
    """B may close over a traced per-env control (the env hook)."""
    domain, eq, psi0 = _setup(omega=0.3)
    psi0 = jnp.stack([psi0, psi0], axis=0)
    X, Y = (jnp.asarray(m) for m in domain.mesh())
    spot = jnp.exp(-(X**2 + Y**2))

    def run(amp):
        def B_ctrl(psi, t):
            return eq.B_terms(psi, t) - 1j * amp[:, None, None] * spot

        macro = make_rot_adi_macro(eq.A_terms, B_ctrl, domain.dx[0], N, N,
                                   1e-3, 3, time_scale=1.0,
                                   mats_dtype=jnp.float32)
        return macro(psi0)

    out = jax.jit(run)(jnp.asarray([0.0, 5.0]))
    assert bool(jnp.isfinite(out.real).all())
    # Different controls must produce different states.
    assert float(jnp.max(jnp.abs(out[0] - out[1]))) > 1e-6
