"""Integration tests against closed-form physics.

Same three analytic oracles as the reference (``tests/test_solvers.py``):
1D Cahn-Hilliard interface → tanh profile (:21-61), 1D Allen-Cahn interface
via adaptive Tsit5 (:64-104), 2D GPE imaginary-time ground state →
Thomas-Fermi density (:107-205) — each through both the raw integrate path
and the ``PDEModel.solve`` API (:208-392), plus design extras: batched
lockstep consistency and the implicit stepper.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import pde_opt_jax as p
from pde_opt_jax.ops.integrate import PIDController
from pde_opt_jax.utils import density, initialize_Psi

KAPPA = 0.002


def _interface_domain():
    Nx, Ny = 256, 1
    Lx, Ly = 0.01 * Nx, 0.01 * Ny
    return Nx, p.Domain(
        (Nx, Ny), ((-Lx / 2, Lx / 2), (-Ly / 2, Ly / 2)), "dimensionless",
        dtype=jnp.float64,
    )


def _step_ic(Nx, Ny=1):
    return jnp.ones((Nx, Ny), jnp.float64).at[: Nx // 2, :].set(-1.0)


def _check_interface(final, domain, Nx):
    analytic = np.tanh(np.asarray(domain.axes()[0]) / np.sqrt(2 * KAPPA))
    np.testing.assert_allclose(
        np.asarray(final).squeeze()[Nx // 4 : 3 * Nx // 4],
        analytic[Nx // 4 : 3 * Nx // 4],
        rtol=1e-3, atol=1e-3,
    )


def test_1d_cahn_hilliard():
    Nx, domain = _interface_domain()
    eq = p.CahnHilliard2DPeriodic(
        domain, KAPPA, lambda c: c**3 - c, lambda c: jnp.ones_like(c), derivs="fd"
    )
    solver = p.SemiImplicitFourierSpectral(0.5, eq.fourier_symbol, eq.fft, eq.ifft)
    ts = np.linspace(0.0, 10.0, 200)
    ys = p.integrate(solver, eq.rhs, _step_ic(Nx), ts, 0.00005)
    _check_interface(ys[-1], domain, Nx)


def test_1d_allen_cahn_adaptive_tsit5():
    Nx, domain = _interface_domain()
    eq = p.AllenCahn2DPeriodic(
        domain, KAPPA, lambda c: c**3 - c, lambda c: jnp.ones_like(c), derivs="fd"
    )
    ts = jnp.linspace(0.0, 10.0, 200)
    ys = p.integrate_adaptive(
        p.Tsit5(), eq.rhs, _step_ic(Nx), ts, 0.00005, rtol=1e-4, atol=1e-6
    )
    _check_interface(ys[-1], domain, Nx)


@pytest.mark.slow
def test_2d_gross_pitaevskii_thomas_fermi():
    atoms = 5e5
    hbar = 1.05e-34
    omega = 2 * np.pi * 10
    omega_z = np.sqrt(8) * omega
    mass = 3.8175406e-26
    a0 = 5.29177210903e-11
    a_s = 100 * a0
    N = 128
    x_s = np.sqrt(hbar / (mass * omega))
    t_s = 1 / omega
    Lx_ = 150e-6 / x_s
    Ly_ = 150e-6 / x_s
    k = 4 * np.pi * a_s * atoms * np.sqrt((mass * omega_z) / (2 * np.pi * hbar))

    domain = p.Domain(
        (N, N), ((-Lx_ / 2, Lx_ / 2), (-Ly_ / 2, Ly_ / 2)), dtype=jnp.float64
    )
    Psi0 = initialize_Psi(N, width=100, vortexnumber=0).astype(jnp.complex128) * x_s
    Psi0 /= jnp.sqrt(jnp.sum(density(Psi0)) * domain.dx[0] ** 2)

    eq = p.GPE2DTSControl(domain, k, 0.0, lambda a, b, c: 0.0, trap_factor=1.0)
    solver = p.StrangSplitting(eq.A_term, eq.domain.dx[0], eq.fft, eq.ifft, -1j)
    y0 = jnp.stack([Psi0.real, Psi0.imag], axis=-1)
    ts = np.linspace(0.0, 0.1 / t_s, 100)
    ys = p.integrate(solver, eq.B_terms, y0, ts, 1e-5 / t_s)

    X, Y = domain.mesh()
    wx2 = wy2 = 0.5
    mu = np.sqrt((1.0 * k * np.sqrt(wx2) * np.sqrt(wy2)) / (2 * np.pi))
    V = 0.5 * (wx2 * X**2 + wy2 * Y**2)
    n = np.clip((mu - V) / k, 0, None)
    dx = float(X[1, 0] - X[0, 0])
    n *= 1.0 / (n.sum() * dx * dx + 1e-12)

    got = np.asarray(density(ys[-1][..., 0] + 1j * ys[-1][..., 1]))
    np.testing.assert_allclose(n, got, rtol=1e-3, atol=1e-3)


# ---- same oracles through the PDEModel API (reference :208-392) --------


def test_1d_cahn_hilliard_pde_model():
    Nx, domain = _interface_domain()
    model = p.PDEModel(
        equation_type=p.CahnHilliard2DPeriodic,
        domain=domain,
        solver_type=p.SemiImplicitFourierSpectral,
    )
    ts = np.linspace(0.0, 10.0, 200)
    sol = model.solve(
        parameters={
            "kappa": KAPPA,
            "mu": lambda c: c**3 - c,
            "D": lambda c: jnp.ones_like(c),
            "derivs": "fd",
        },
        y0=_step_ic(Nx),
        ts=ts,
        solver_parameters={"A": 0.5},
        dt0=0.00005,
    )
    assert sol.shape == (200, Nx, 1)
    _check_interface(sol[-1], domain, Nx)


def test_1d_allen_cahn_pde_model_adaptive():
    Nx, domain = _interface_domain()
    model = p.PDEModel(
        equation_type=p.AllenCahn2DPeriodic,
        domain=domain,
        solver_type=p.Tsit5,
    )
    sol = model.solve(
        parameters={
            "kappa": KAPPA,
            "mu": lambda c: c**3 - c,
            "R": lambda c: jnp.ones_like(c),
            "derivs": "fd",
        },
        y0=_step_ic(Nx),
        ts=np.linspace(0.0, 10.0, 200),
        dt0=0.00005,
        stepsize_controller=PIDController(rtol=1e-4, atol=1e-6),
    )
    _check_interface(sol[-1], domain, Nx)


# ---- design specifics --------------------------------------------------


def test_batched_rollout_matches_single():
    """A lockstep batch of identical ICs must match the single-instance run."""
    Nx, domain = _interface_domain()
    eq = p.CahnHilliard2DPeriodic(
        domain, KAPPA, lambda c: c**3 - c, lambda c: jnp.ones_like(c), derivs="fd"
    )
    solver = p.SemiImplicitFourierSpectral(0.5, eq.fourier_symbol, eq.fft, eq.ifft)
    u0 = _step_ic(Nx)
    ts = np.linspace(0.0, 0.1, 5)
    single = p.integrate(solver, eq.rhs, u0, ts, 0.00005)
    batched = p.integrate(solver, eq.rhs, jnp.stack([u0, u0, u0]), ts, 0.00005)
    assert batched.shape == (5, 3, Nx, 1)
    # Identical envs in a batch agree bitwise with each other; vs the
    # unbatched run they agree to machine precision (the batched FFT reduces
    # in a different order).
    np.testing.assert_array_equal(np.asarray(batched[:, 0]), np.asarray(batched[:, 1]))
    for b in range(3):
        np.testing.assert_allclose(
            np.asarray(batched[:, b]), np.asarray(single), rtol=0, atol=1e-12
        )


def test_forward_and_checkpoint_adjoints_agree():
    Nx, domain = _interface_domain()
    model = p.PDEModel(p.CahnHilliard2DPeriodic, domain, p.SemiImplicitFourierSpectral)
    u0 = _step_ic(Nx)
    ts = np.linspace(0.0, 0.01, 3)

    def loss(kappa, adjoint):
        sol = model.solve(
            {"kappa": kappa, "mu": lambda c: c**3 - c,
             "D": lambda c: jnp.ones_like(c), "derivs": "fd"},
            u0, ts, {"A": 0.5}, adjoint=adjoint, dt0=0.0005,
        )
        return jnp.sum(sol[-1] ** 2)

    g_fwd = jax.jacfwd(lambda k: loss(k, "forward"))(KAPPA)
    g_rev = jax.grad(lambda k: loss(k, "checkpoint"))(KAPPA)
    np.testing.assert_allclose(g_fwd, g_rev, rtol=1e-6)


def test_implicit_euler_dahlquist():
    """Backward Euler on y' = -50y: stable at dt where explicit Euler blows up."""
    rhs = lambda y, t: -50.0 * y
    stepper = p.ImplicitEuler()
    y = jnp.array([1.0])
    dt = 0.1  # explicit Euler factor |1-5| = 4 -> divergent
    for i in range(10):
        y, _ = stepper.step(rhs, y, i * dt, dt)
    exact_factor = 1.0 / (1 + 50 * dt) ** 10
    np.testing.assert_allclose(float(y[0]), exact_factor, rtol=1e-5)
    assert float(y[0]) < 1.0


@pytest.mark.slow
def test_implicit_euler_stiff_diffusion():
    """Implicit Euler integrates 1D diffusion far beyond the explicit limit."""
    N = 64
    domain = p.Domain((N, 1), ((-1, 1), (-0.01, 0.01)), dtype=jnp.float64)
    hx = domain.dx[0]
    from pde_opt_jax.ops import stencils as st

    rhs = lambda y, t: st.grad2_c(y, hx, -2)
    x = domain.axes()[0]
    y0 = jnp.asarray(np.sin(np.pi * x)[:, None])
    dt = 10 * hx**2  # ~40x the explicit stability limit
    stepper = p.ImplicitEuler(newton_iters=3, gmres_iters=40)
    y = y0
    for i in range(20):
        y, _ = stepper.step(rhs, y, i * dt, dt)
    assert np.all(np.isfinite(np.asarray(y)))
    # Decay factor per step for mode k=pi/2 (domain [-1,1] cell-centered):
    lam = 4 / hx**2 * np.sin(np.pi * hx / 2 / 2) ** 2 * 4  # approx pi^2/4... just check decay
    assert float(jnp.max(jnp.abs(y))) < float(jnp.max(jnp.abs(y0)))


def test_integrate_adaptive_batched_per_instance_error_control():
    """batch_ndim: the strictest instance governs the shared lockstep dt,
    so each batched instance is as accurate as solving it alone."""
    import jax.numpy as jnp
    import numpy as np

    from pde_opt_jax.ops.integrate import integrate_adaptive
    from pde_opt_jax.ops.steppers import Heun

    # Two exponential decays with very different stiffness.
    lam = jnp.array([-1.0, -40.0])

    def rhs(y, t):
        return lam.reshape(-1, *([1] * (y.ndim - 1))) * y

    y0 = jnp.ones((2, 4))
    ts = jnp.linspace(0.0, 1.0, 5)
    ys, stats = integrate_adaptive(
        Heun(), rhs, y0, ts, dt0=0.1, rtol=1e-6, atol=1e-9,
        batch_ndim=1, return_stats=True,
    )
    exact = jnp.exp(lam[None, :, None] * ts[:, None, None]) * y0[None]
    np.testing.assert_allclose(np.asarray(ys), np.asarray(exact),
                               rtol=1e-4, atol=1e-7)
    assert int(stats["accepted_steps"]) > 10  # the stiff row forced small dt


def test_implicit_euler_convergence_diagnostics():
    """Residual-based Newton: a well-posed stiff solve
    reports converged=True in few iterations; an absurd dt reports
    converged=False instead of silently returning garbage; the masked
    differentiable variant matches the while_loop variant."""
    from pde_opt_jax.ops.steppers import ImplicitEuler

    lam = 50.0
    rhs = lambda y, t: -lam * y
    y0 = jnp.ones((8, 8))

    st = ImplicitEuler()
    y1, stats = st.solve_step(rhs, y0, 0.0, 0.1)
    exact = y0 / (1.0 + lam * 0.1)   # backward Euler on linear decay
    np.testing.assert_allclose(np.asarray(y1), np.asarray(exact), rtol=1e-6)
    assert bool(stats["converged"])
    assert int(stats["iterations"]) <= 3

    # Nonlinear + huge dt: Newton stalls; the flag must say so.
    hard_rhs = lambda y, t: -jnp.exp(5.0 * y) * y + 10.0 * jnp.sin(y)
    st_small = ImplicitEuler(newton_iters=2, gmres_iters=2)
    _, stats_bad = st_small.solve_step(hard_rhs, 3.0 * y0, 0.0, 50.0)
    assert not bool(stats_bad["converged"])

    st_diff = ImplicitEuler(differentiable=True)
    y1d, stats_d = st_diff.solve_step(rhs, y0, 0.0, 0.1)
    np.testing.assert_allclose(np.asarray(y1d), np.asarray(y1), rtol=1e-10)
    assert bool(stats_d["converged"])
    # and it is reverse-differentiable
    gr = jax.grad(lambda z: jnp.sum(st_diff.solve_step(rhs, z, 0.0, 0.1)[0] ** 2))(y0)
    assert bool(jnp.isfinite(gr).all())
