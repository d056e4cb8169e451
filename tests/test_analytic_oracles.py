"""Independent analytic oracles for the golden-gated families.

The golden fixtures (``tests/goldens``) are numpy transcriptions of the
reference update formulas — a shared-author transcription error (e.g. a
flipped sign copied into both generator and stepper) would pass the 1e-12
parity gate.  These tests close that hole with oracles *derived from the
continuum equations*, not transcribed from any implementation:

* **Butler-Volmer linear response.**  Around a uniform base state ``c0`` at
  ``Crate = 0`` the galvanostatic BV Allen-Cahn (reference
  ``allen_cahn.py:213-281``) has an exactly stationary point (``eta = 0``
  everywhere), and a zero-mean Fourier perturbation ``eps*sin(k.x)`` evolves
  with the closed-form rate

      d(delta)/dt = -j0(c0) * (mu'(c0) + kappa * k2_disc) * delta,

  where ``k2_disc = (4/h^2) sin^2(pi m / N)`` is the roll-stencil Laplacian
  symbol.  (The voltage response vanishes to first order because the
  constraint integrals only see the spatial mean.)  Any sign or coefficient
  error in mu-coupling, ``kappa``, ``j0``, or the BV exponentials breaks
  this rate.

* **SBM == periodic at psi == 1.**  With a uniform level set the
  smoothed-boundary galvanostatic equation (reference
  ``allen_cahn.py:284-383``) must reduce to the periodic one: the psi-
  weighted flux divergence collapses to the plain Laplacian and the
  psi-weighted constraint integrals to the plain ones.  Two independent
  code paths, one equation.

* **Rotating-GPE spectral splitting.**  For ``g = 0``, symmetric trap
  (``e = 0``, omega_trap = 1), the rotating-frame Hamiltonian
  ``H = -nabla^2/2 + r^2/2 - Omega*L_z`` has exact eigenmodes
  ``(x ± i y) exp(-r^2/2)`` with ``L_z = ±1`` and energies ``2 ∓ Omega``.
  Un-normalized imaginary time must decay their L2 norm at exactly that
  rate, so the measured splitting ``E(m=-1) - E(m=+1) = 2*Omega`` pins the
  rotation term's sign and magnitude (reference
  ``gross_pitaevskii.py:84-131``) independently of the golden fixture.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from pde_opt_jax.grid import Domain
from pde_opt_jax.models.allen_cahn import (
    AllenCahn2DPeriodicButlerVolmerConstantCurrent,
    AllenCahn2DSmoothedBoundaryButlerVolmerConstantCurrent,
)
from pde_opt_jax.models.gross_pitaevskii import GPE2DTSRot
from pde_opt_jax.ops.bv_reference import bv_cc_reference
from pde_opt_jax.ops.steppers import DirectionalSplitting

# The BV charging preset's coefficient functions.
CLIP = lambda c: jnp.clip(c, 1e-4, 1 - 1e-4)  # noqa: E731
MU = lambda c: jnp.log(CLIP(c) / (1 - CLIP(c))) + 3.0 * (1.0 - 2.0 * c)  # noqa: E731
J0 = lambda c: jnp.sqrt(jnp.clip(c * (1 - c), 1e-6, None))  # noqa: E731


def _mu_prime(c):
    return 1.0 / (c * (1.0 - c)) - 6.0


def _bv_setup(N=32, kappa=5e-4):
    L = 1.0
    h = L / N
    domain = Domain((N, N), ((0.0, L), (0.0, L)), "dimensionless",
                    dtype=jnp.float64)
    return domain, L, h


def _sine_mode(domain, m, axis):
    """Zero-mean single Fourier mode along one axis, constant along the other."""
    x, y = domain.mesh()
    L = 1.0
    coord = x if axis == 0 else y
    return jnp.sin(2.0 * np.pi * m * coord / L)


def _lap_symbol(m, N, h):
    return (4.0 / h**2) * np.sin(np.pi * m / N) ** 2


@pytest.mark.parametrize("c0,m,axis", [(0.1, 1, 0), (0.1, 5, 1), (0.3, 3, 0)])
def test_bv_cc_rhs_linear_response_matches_analytic(c0, m, axis):
    """rhs linearization around the Crate=0 stationary state: central
    difference of ``rhs`` along a sine mode must equal the closed-form rate
    (c0=0.3 sits inside the spinodal: mu'(c0) < 0, a *growing* long-wave
    mode — the sign of the rate is part of the check)."""
    N = 32
    kappa = 5e-4
    domain, L, h = _bv_setup(N, kappa)
    eq = AllenCahn2DPeriodicButlerVolmerConstantCurrent(
        domain, kappa, MU, J0, alpha=0.5, Crate=0.0)

    s = _sine_mode(domain, m, axis)
    base = jnp.full((N, N), c0, jnp.float64)

    # Stationarity of the base state (eta == 0 exactly at Crate=0).
    np.testing.assert_allclose(np.asarray(eq.rhs_fd(base, 0.0)), 0.0,
                               atol=1e-12)

    eps = 1e-5
    dplus = eq.rhs_fd(base + eps * s, 0.0)
    dminus = eq.rhs_fd(base - eps * s, 0.0)
    measured = np.asarray((dplus - dminus) / (2.0 * eps))

    lam = float(J0(jnp.float64(c0))) * (_mu_prime(c0)
                                        + kappa * _lap_symbol(m, N, h))
    np.testing.assert_allclose(measured, -lam * np.asarray(s),
                               rtol=0, atol=3e-6 * max(1.0, abs(lam)))


def test_bv_cc_rk4_oracle_amplification_matches_analytic():
    """The RK4 macro's per-mode amplification over n steps must equal the
    RK4 stability polynomial of the analytic rate: r(-lam*dt)^n."""
    N, m = 32, 2
    kappa, dt, n = 5e-4, 2e-3, 25
    c0 = 0.1
    domain, L, h = _bv_setup(N, kappa)
    macro = bv_cc_reference(MU, J0, kappa, h, h, dt, n)

    s = _sine_mode(domain, m, axis=0)
    eps = 1e-5
    u0 = jnp.full((N, N), c0, jnp.float64) + eps * s
    u1 = macro(u0, 0.0)

    proj = lambda u: float(jnp.sum((u - u.mean()) * s) * 2.0 / (N * N))  # noqa: E731
    gain = proj(u1) / proj(u0)

    lam = float(J0(jnp.float64(c0))) * (_mu_prime(c0)
                                        + kappa * _lap_symbol(m, N, h))
    z = -lam * dt
    r = 1.0 + z + z**2 / 2 + z**3 / 6 + z**4 / 24
    np.testing.assert_allclose(gain, r**n, rtol=5e-6)


def test_sbm_bv_psi_one_reduces_to_periodic():
    """psi == 1 collapses the SBM flux form to the periodic Laplacian and
    the psi-weighted constraint to the plain one — rhs and voltage from the
    two independent code paths must agree to rounding."""
    N = 24
    kappa = 2e-3
    domain, L, h = _bv_setup(N, kappa)
    crate = 0.7
    periodic = AllenCahn2DPeriodicButlerVolmerConstantCurrent(
        domain, kappa, MU, J0, alpha=0.5, Crate=crate)
    sbm = AllenCahn2DSmoothedBoundaryButlerVolmerConstantCurrent(
        domain, kappa, f=lambda c: 0.0, mu=MU, j0=J0, alpha=0.5,
        Crate=crate, psi=jnp.ones((N, N), jnp.float64))

    rng = np.random.default_rng(7)
    u = jnp.asarray(np.clip(0.3 + 0.05 * rng.standard_normal((N, N)),
                            0.05, 0.95), jnp.float64)
    np.testing.assert_allclose(np.asarray(sbm.rhs_fd(u, 0.0)),
                               np.asarray(periodic.rhs_fd(u, 0.0)),
                               rtol=0, atol=1e-11)
    np.testing.assert_allclose(float(sbm.get_voltage(u)),
                               float(periodic.get_voltage(u)),
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize("derivs,c0,mode", [
    ("fourier", 0.4, (5, 0)),   # spinodal: low-k growth, sign is checked
    ("fourier", 0.8, (3, 7)),
    ("fd", 0.4, (5, 0)),
    ("fd", 0.8, (3, 7)),
])
def test_ch_sif_mode_amplification_matches_closed_form(derivs, c0, mode):
    """One SIF step on a plane-wave perturbation of a uniform state must
    amplify it by the closed-form semi-implicit gain

        g = 1 + dt * D(c0) * L * (mu'(c0) - kappa*L) / (1 + A*dt*kappa*K2^2)

    with L the (spectral or roll-stencil) Laplacian symbol of the mode and
    K2 the continuum symbol in the stabilization denominator (reference
    update ``solvers.py:56-70``, flagship CH family).  dt is chosen so the
    denominator deviates from 1 by ~50%, pinning the stabilization term's
    sign and magnitude, not just the explicit rhs."""
    from pde_opt_jax.models.cahn_hilliard import CahnHilliard2DPeriodic
    from pde_opt_jax.ops.steppers import SemiImplicitFourierSpectral

    N, kappa, A, dt = 64, 5e-4, 1.0, 1e-3
    L = 1.0
    h = L / N
    m, n = mode
    domain = Domain((N, N), ((0.0, L), (0.0, L)), "dimensionless",
                    dtype=jnp.float64)
    mu = lambda c: c**3 - c                     # noqa: E731
    D = lambda c: 1.0 + 0.1 * c**2              # noqa: E731
    eq = CahnHilliard2DPeriodic(domain, kappa, mu, D, derivs=derivs)
    stepper = SemiImplicitFourierSpectral(A, eq.fourier_symbol, eq.fft,
                                          eq.ifft)

    x, y = domain.mesh()
    s = jnp.sin(2.0 * np.pi * (m * x + n * y) / L)
    eps = 1e-5
    base = jnp.full((N, N), c0, jnp.float64)
    y1p, _ = stepper.step(eq.rhs, base + eps * s, 0.0, dt)
    y1m, _ = stepper.step(eq.rhs, base - eps * s, 0.0, dt)
    measured = np.asarray((y1p - y1m) / (2.0 * eps))

    K2 = (2.0 * np.pi / L) ** 2 * (m**2 + n**2)
    if derivs == "fourier":
        lap_sym = -K2
    else:
        lap_sym = -(_lap_symbol(m, N, h) + _lap_symbol(n, N, h))
    mu_p = 3.0 * c0**2 - 1.0
    D0 = 1.0 + 0.1 * c0**2
    lam = D0 * lap_sym * (mu_p - kappa * lap_sym)
    denom = 1.0 + A * dt * kappa * K2**2
    assert abs(denom - 1.0) > 0.2   # the stabilization term is exercised
    gain = 1.0 + dt * lam / denom
    np.testing.assert_allclose(measured, gain * np.asarray(s),
                               rtol=0, atol=1e-8)


@pytest.mark.parametrize("derivs", ["fourier", "fd"])
def test_ch3d_sif_mode_amplification_matches_closed_form(derivs):
    """Same closed-form semi-implicit gain as the 2D case, for the 3D family
    (reference ``cahn_hilliard.py:112-200``) on a mixed (m,n,p) plane wave."""
    from pde_opt_jax.models.cahn_hilliard import CahnHilliard3DPeriodic
    from pde_opt_jax.ops.steppers import SemiImplicitFourierSpectral

    N, kappa, A, dt = 24, 1e-3, 1.0, 2e-3
    L = 1.0
    h = L / N
    m, n, p = 2, 3, 1
    c0 = 0.5
    domain = Domain((N, N, N), ((0.0, L),) * 3, "dimensionless",
                    dtype=jnp.float64)
    mu = lambda c: c**3 - c                     # noqa: E731
    D = lambda c: 1.0 + 0.1 * c**2              # noqa: E731
    eq = CahnHilliard3DPeriodic(domain, kappa, mu, D, derivs=derivs)
    stepper = SemiImplicitFourierSpectral(A, eq.fourier_symbol, eq.fft,
                                          eq.ifft)

    x, y, z = domain.mesh()
    s = jnp.sin(2.0 * np.pi * (m * x + n * y + p * z) / L)
    eps = 1e-5
    base = jnp.full((N, N, N), c0, jnp.float64)
    y1p, _ = stepper.step(eq.rhs, base + eps * s, 0.0, dt)
    y1m, _ = stepper.step(eq.rhs, base - eps * s, 0.0, dt)
    measured = np.asarray((y1p - y1m) / (2.0 * eps))

    K2 = (2.0 * np.pi / L) ** 2 * (m**2 + n**2 + p**2)
    if derivs == "fourier":
        lap_sym = -K2
    else:
        lap_sym = -sum(_lap_symbol(q, N, h) for q in (m, n, p))
    mu_p = 3.0 * c0**2 - 1.0
    D0 = 1.0 + 0.1 * c0**2
    lam = D0 * lap_sym * (mu_p - kappa * lap_sym)
    gain = 1.0 + dt * lam / (1.0 + A * dt * kappa * K2**2)
    np.testing.assert_allclose(measured, gain * np.asarray(s),
                               rtol=0, atol=1e-8)


@pytest.mark.parametrize("derivs", ["fourier", "fd"])
def test_ac_rhs_linear_response_matches_analytic(derivs):
    """Allen-Cahn linear response around the stable well c0=1 (mu(c0)=0, so
    the R'(c0) term drops): d(delta)/dt = -R(c0)*(mu'(c0) - kappa*L)*delta,
    checking the R-mobility coupling the tanh-interface oracle is blind to."""
    from pde_opt_jax.models.allen_cahn import AllenCahn2DPeriodic

    N, kappa, m = 64, 5e-4, 4
    L = 1.0
    h = L / N
    domain = Domain((N, N), ((0.0, L), (0.0, L)), "dimensionless",
                    dtype=jnp.float64)
    mu = lambda c: c**3 - c                     # noqa: E731
    R = lambda c: 1.0 + 0.1 * c**2              # noqa: E731
    eq = AllenCahn2DPeriodic(domain, kappa, mu, R, derivs=derivs)

    x, _ = domain.mesh()
    s = jnp.sin(2.0 * np.pi * m * x / L)
    eps = 1e-5
    base = jnp.ones((N, N), jnp.float64)
    rhs = eq.rhs_fourier if derivs == "fourier" else eq.rhs_fd
    measured = np.asarray((rhs(base + eps * s, 0.0)
                           - rhs(base - eps * s, 0.0)) / (2.0 * eps))

    if derivs == "fourier":
        lap_sym = -(2.0 * np.pi * m / L) ** 2
    else:
        lap_sym = -_lap_symbol(m, N, h)
    lam = -1.1 * (2.0 - kappa * lap_sym)        # -R(1)*(mu'(1) - kappa*L)
    np.testing.assert_allclose(measured, lam * np.asarray(s),
                               rtol=0, atol=1e-8)


def _gpe_eigenmode_energy(omega, m_charge, dt=2e-3, n_steps=30):
    N, half = 64, 6.0
    domain = Domain((N, N), ((-half, half), (-half, half)), "dimensionless",
                    dtype=jnp.float64)
    eq = GPE2DTSRot(domain, k=0.0, e=0.0, omega=omega)
    stepper = DirectionalSplitting(eq.A_terms, eq.B_terms,
                                   dx=float(domain.dx[0]),
                                   time_scale=-1j, normalize=False)
    x, y = domain.mesh()
    psi = ((x + 1j * m_charge * y)
           * jnp.exp(-0.5 * (x**2 + y**2))).astype(jnp.complex128)

    cell = float(domain.dx[0]) * float(domain.dx[1])
    norm2 = lambda p: float(jnp.sum(jnp.abs(p) ** 2) * cell)  # noqa: E731
    n0 = norm2(psi)
    for i in range(n_steps):
        psi, _ = stepper.step(None, psi, i * dt, dt)
    return -np.log(norm2(psi) / n0) / (2.0 * dt * n_steps)


@pytest.mark.parametrize("omega", [0.0, 0.4])
def test_rotating_gpe_eigenmode_energies_split_by_omega(omega):
    e_plus = _gpe_eigenmode_energy(omega, +1)
    e_minus = _gpe_eigenmode_energy(omega, -1)
    np.testing.assert_allclose(e_plus, 2.0 - omega, rtol=2e-3)
    np.testing.assert_allclose(e_minus, 2.0 + omega, rtol=2e-3)
    np.testing.assert_allclose(e_minus - e_plus, 2.0 * omega, atol=2e-3)
