"""Generate golden-trajectory fixtures for fixed-seed parity tests.

Pure **numpy float64** re-derivations of the reference solver semantics —
independent of jax and of the pde_opt_jax package — rolled forward from
committed initial conditions and saved to ``tests/goldens/*.npz``.  The
parity tests (``tests/test_golden_parity.py``) then integrate the SAME
initial conditions through this framework's steppers and assert array-level
agreement, making BASELINE's "exact fixed-seed trajectory match at matched
grid/dt" an executable gate.

Why numpy and not the reference itself: the reference's runtime stack
(diffrax/equinox/optimistix) is not installed in this image, so its solvers
cannot execute here.  The update formulas below are transcribed from the
reference source and cited line-by-line:

* semi-implicit Fourier-spectral step
  ``y1 = y0 + dt * Re ifft( fft(rhs(y0)) / (1 + A*dt*symbol) )``
  — /root/reference/pde_opt/numerics/solvers.py:56-70
* Cahn-Hilliard spectral rhs (variable mobility)
  — /root/reference/pde_opt/numerics/equations/cahn_hilliard.py:82-87
* Cahn-Hilliard conservative FD rhs (face fluxes)
  — /root/reference/pde_opt/numerics/equations/cahn_hilliard.py:89-109
* Strang split step with per-step L2 renormalization, B evaluated at y0
  — /root/reference/pde_opt/numerics/solvers.py:99-122

Run from the repo root: ``python scripts/gen_goldens.py``.
"""

import os

import numpy as np

OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "tests", "goldens")


def mu(c):
    return c**3 - c


def D(c):
    return 1.0 + 0.1 * c**2


# ---------------------------------------------------------------------------
# Cahn-Hilliard, 64x64, semi-implicit Fourier spectral
# ---------------------------------------------------------------------------

def gen_ch2d(derivs: str, fname: str):
    N = 64
    dx = 0.01
    kappa = 0.004
    A = 0.5
    dt = 1e-6
    n_steps = 40
    save_every = 10

    rng = np.random.default_rng(12345)
    u0 = 0.5 + 0.05 * rng.standard_normal((N, N))

    kx, ky = np.meshgrid(np.fft.fftfreq(N, dx), np.fft.fftfreq(N, dx),
                         indexing="ij")
    tpikx = 2j * np.pi * kx
    tpiky = 2j * np.pi * ky
    tpik2 = tpikx**2 + tpiky**2
    symbol = kappa * tpik2**2                      # real >= 0

    def rhs_fourier(u):
        uhat = np.fft.fftn(u)
        mu_hat = np.fft.fftn(mu(u)) - kappa * tpik2 * uhat
        Du = D(u)
        fx = np.fft.fftn(Du * np.fft.ifftn(tpikx * mu_hat))
        fy = np.fft.fftn(Du * np.fft.ifftn(tpiky * mu_hat))
        return np.real(np.fft.ifftn(tpikx * fx + tpiky * fy))

    def rhs_fd(u):
        lap = (
            (np.roll(u, -1, 0) - 2 * u + np.roll(u, 1, 0)) / dx**2
            + (np.roll(u, -1, 1) - 2 * u + np.roll(u, 1, 1)) / dx**2
        )
        m = mu(u) - kappa * lap
        Du = D(u)
        out = np.zeros_like(u)
        for ax in (0, 1):
            grad_f = (np.roll(m, -1, ax) - m) / dx          # center->face
            avg_f = 0.5 * (Du + np.roll(Du, -1, ax))
            F = avg_f * grad_f
            out += (F - np.roll(F, 1, ax)) / dx             # face->center
        return out

    rhs = rhs_fourier if derivs == "fourier" else rhs_fd

    traj = [u0.copy()]
    u = u0.copy()
    for k in range(1, n_steps + 1):
        f0 = rhs(u)
        u = u + dt * np.real(np.fft.ifftn(np.fft.fftn(f0) / (1.0 + A * dt * symbol)))
        if k % save_every == 0:
            traj.append(u.copy())

    np.savez_compressed(
        os.path.join(OUT, fname),
        u0=u0, traj=np.stack(traj), kappa=kappa, A=A, dt=dt,
        n_steps=n_steps, save_every=save_every, dx=dx, N=N,
    )
    print(f"{fname}: traj {np.stack(traj).shape}, final range "
          f"[{u.min():.4f}, {u.max():.4f}]")


# ---------------------------------------------------------------------------
# Strang split step, 64x64, imaginary-time GPE-style propagation
# ---------------------------------------------------------------------------

def gen_strang_imag():
    N = 64
    L = 16.0
    dx = L / N
    dt = 1e-3
    n_steps = 30
    save_every = 10
    g = 100.0

    x = np.linspace(-L / 2 + dx / 2, L / 2 - dx / 2, N)
    X, Y = np.meshgrid(x, x, indexing="ij")
    V = 0.5 * (X**2 + Y**2)

    kx, ky = np.meshgrid(np.fft.fftfreq(N, dx), np.fft.fftfreq(N, dx),
                         indexing="ij")
    # kinetic symbol of i dpsi/dt = -1/2 lap psi: A = -i*(2 pi k)^2 / 2
    A_term = -0.5j * ((2 * np.pi * kx) ** 2 + (2 * np.pi * ky) ** 2)

    rng = np.random.default_rng(777)
    psi0 = np.exp(-(X**2 + Y**2) / 4.0) * (1.0 + 0.05 * rng.standard_normal((N, N)))
    psi0 = psi0 / np.sqrt(np.sum(np.abs(psi0) ** 2) * dx**2)
    psi0 = psi0.astype(np.complex128)

    time_scale = -1j                                # imaginary time
    dtc = dt * time_scale

    def B(psi):
        return -1j * (V + g * np.abs(psi) ** 2)

    traj = [psi0.copy()]
    psi = psi0.copy()
    for k in range(1, n_steps + 1):
        expA = np.exp(A_term * 0.5 * dtc)
        tmp = np.fft.ifftn(np.fft.fftn(psi) * expA)
        b = B(psi)                                  # B at y0, per reference
        tmp = tmp * np.exp(b * dtc)
        tmp = tmp / np.sqrt(np.sum(np.abs(tmp) ** 2) * dx**2)
        psi = np.fft.ifftn(np.fft.fftn(tmp) * expA)
        if k % save_every == 0:
            traj.append(psi.copy())

    np.savez_compressed(
        os.path.join(OUT, "gpe_strang_imag.npz"),
        psi0=psi0, traj=np.stack(traj), A_term=A_term, V=V, g=g,
        dx=dx, dt=dt, n_steps=n_steps, save_every=save_every, N=N, L=L,
    )
    print(f"gpe_strang_imag: traj {np.stack(traj).shape}, "
          f"norm {np.sum(np.abs(psi)**2) * dx**2:.6f}")




# ---------------------------------------------------------------------------
# Allen-Cahn, 64x64, fixed-dt Tsitouras 5(4) (the reference's Tsit5 path)
# ---------------------------------------------------------------------------

# Standard published Tsitouras 5(4) tableau (Tsitouras, Comput. Math. Appl.
# 62 (2011) 770-775) — the same coefficients diffrax's Tsit5 uses, which is
# the solver the reference drives Allen-Cahn with
# (/root/reference/tests/test_solvers.py:81, pde_model.py via solver_type).
_TS_C = (0.161, 0.327, 0.9, 0.9800255409045097, 1.0, 1.0)
_TS_A = (
    (0.161,),
    (-0.008480655492356989, 0.335480655492357),
    (2.8971530571054935, -6.359448489975075, 4.3622954328695815),
    (5.325864828439257, -11.748883564062828, 7.4955393428898365,
     -0.09249506636175525),
    (5.86145544294642, -12.92096931784711, 8.159367898576159,
     -0.071584973281401, -0.028269050394068383),
    (0.09646076681806523, 0.01, 0.4798896504144996, 1.379008574103742,
     -3.290069515436081, 2.324710524099774),
)


def _tsit5_step(rhs, u, t, dt):
    k = [rhs(u, t)]
    for ci, ai in zip(_TS_C, _TS_A):
        ui = u.copy()
        for aij, kj in zip(ai, k):
            ui = ui + dt * aij * kj
        k.append(rhs(ui, t + ci * dt))
    u1 = u.copy()
    for aij, kj in zip(_TS_A[-1], k):
        u1 = u1 + dt * aij * kj
    return u1


def gen_ac2d_tsit5():
    """Allen-Cahn FD rhs (reference allen_cahn.py:81-84: rhs = -R(u) *
    (mu(u) - kappa*lap u)) advanced by fixed-dt Tsit5."""
    N = 64
    dx = 0.01
    kappa = 2e-3
    dt = 1e-4
    n_steps = 40
    save_every = 10

    def R(c):
        return 1.0 + 0.1 * c**2

    def rhs(u, t):
        lap = (
            (np.roll(u, -1, 0) - 2 * u + np.roll(u, 1, 0)) / dx**2
            + (np.roll(u, -1, 1) - 2 * u + np.roll(u, 1, 1)) / dx**2
        )
        return -R(u) * (mu(u) - kappa * lap)

    rng = np.random.default_rng(2024)
    u0 = 0.1 * rng.standard_normal((N, N))

    traj = [u0.copy()]
    u = u0.copy()
    for k in range(1, n_steps + 1):
        u = _tsit5_step(rhs, u, (k - 1) * dt, dt)
        if k % save_every == 0:
            traj.append(u.copy())

    np.savez_compressed(
        os.path.join(OUT, "ac2d_tsit5_fd.npz"),
        u0=u0, traj=np.stack(traj), kappa=kappa, dt=dt,
        n_steps=n_steps, save_every=save_every, dx=dx, N=N,
    )
    print(f"ac2d_tsit5_fd: traj {np.stack(traj).shape}, final range "
          f"[{u.min():.4f}, {u.max():.4f}]")




# ---------------------------------------------------------------------------
# Butler-Volmer constant-current Allen-Cahn, 48x48, classical RK4
# ---------------------------------------------------------------------------

def gen_bv_constant_current():
    """Galvanostatic Butler-Volmer Allen-Cahn + voltage trace.

    Reference semantics, transcribed: BV kinetics j0*(e^{-a*eta} -
    e^{(1-a)*eta}) with the overpotential eliminated by the closed-form
    constant-current closure (quadratic in y = e^{v/2}) and the cell
    voltage recovered as v = 2*log(y)
    (/root/reference/pde_opt/numerics/equations/allen_cahn.py:213-281,
    closure :257-270, get_voltage :272-281).  Advanced by classical RK4.
    """
    N = 48
    dx = 1.0 / N
    kappa = 5e-4
    alpha = 0.5
    Crate = 1.0
    dt = 5e-4
    n_steps = 60
    save_every = 20

    def clip(c):
        return np.clip(c, 1e-4, 1 - 1e-4)

    def mu_bv(c):
        return np.log(clip(c) / (1 - clip(c))) + 3.0 * (1.0 - 2.0 * c)

    def j0(c):
        return np.sqrt(np.clip(c * (1 - c), 1e-6, None))

    cell = dx * dx

    def mu_and_v(u):
        lap = (
            (np.roll(u, -1, 0) - 2 * u + np.roll(u, 1, 0)) / dx**2
            + (np.roll(u, -1, 1) - 2 * u + np.roll(u, 1, 1)) / dx**2
        )
        m = mu_bv(u) - kappa * lap
        j = j0(u)
        int_plus = np.sum(j * np.exp(0.5 * m)) * cell
        int_minus = np.sum(j * np.exp(-0.5 * m)) * cell
        y = (-Crate + np.sqrt(Crate**2 + 4.0 * int_plus * int_minus)) / (
            2.0 * int_plus)
        return m, 2.0 * np.log(y), j

    def rhs(u, t):
        m, v, j = mu_and_v(u)
        eta = m + v
        return j * (np.exp(-alpha * eta) - np.exp((1.0 - alpha) * eta))

    rng = np.random.default_rng(4242)
    u0 = np.clip(0.05 + 0.005 * rng.standard_normal((N, N)), 0.01, 0.99)

    traj, volts = [u0.copy()], [mu_and_v(u0)[1]]
    u = u0.copy()
    for k in range(1, n_steps + 1):
        t = (k - 1) * dt
        k1 = rhs(u, t)
        k2 = rhs(u + 0.5 * dt * k1, t + 0.5 * dt)
        k3 = rhs(u + 0.5 * dt * k2, t + 0.5 * dt)
        k4 = rhs(u + dt * k3, t + dt)
        u = u + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
        if k % save_every == 0:
            traj.append(u.copy())
            volts.append(mu_and_v(u)[1])

    np.savez_compressed(
        os.path.join(OUT, "bv_cc_rk4.npz"),
        u0=u0, traj=np.stack(traj), volts=np.asarray(volts),
        kappa=kappa, alpha=alpha, Crate=Crate, dt=dt,
        n_steps=n_steps, save_every=save_every, dx=dx, N=N,
    )
    print(f"bv_cc_rk4: traj {np.stack(traj).shape}, "
          f"voltage {volts[0]:+.4f} -> {volts[-1]:+.4f}, "
          f"mean fill {u.mean():.4f}")


def gen_sbm_bv_constant_current():
    """Smoothed-boundary galvanostatic Butler-Volmer + psi-weighted voltage.

    Reference semantics, transcribed
    (/root/reference/pde_opt/numerics/equations/allen_cahn.py:284-383):
    SBM chemical potential mu(c) - (kappa/psi) * div(psi_avg * grad c) on
    center->face/face->center stencils (grad_c2f: (roll(-1)-u)/h, avg_c2f:
    midpoint, div_f2c: (F-roll(+1))/h), psi-WEIGHTED global integrals in the
    closed-form constant-current closure, v = 2*log(y), contact-angle term
    disabled (commented out in the reference rhs, :334-338).  Advanced by
    classical RK4.  psi is an ANALYTIC tanh disk (deterministic; independent
    of any smoothing-flow implementation), clamped to [0.001, 1] like
    reference shapes.py:35-37.
    """
    N = 48
    dx = 1.0 / N
    kappa = 5e-4
    alpha = 0.5
    Crate = 1.0
    dt = 5e-4
    n_steps = 60
    save_every = 20

    x = (np.arange(N) + 0.5) * dx - 0.5
    X, Y = np.meshgrid(x, x, indexing="ij")
    r = np.sqrt(X**2 + Y**2)
    psi = 0.5 * (1.0 + np.tanh((0.35 - r) / 0.04))
    psi = np.where(psi < 0.001, 0.001, psi)
    psi = np.where(psi > 0.99, 1.0, psi)
    psi_avgx = 0.5 * (psi + np.roll(psi, -1, 0))
    psi_avgy = 0.5 * (psi + np.roll(psi, -1, 1))

    def clip(c):
        return np.clip(c, 1e-4, 1 - 1e-4)

    def mu_fn(c):
        return np.log(clip(c) / (1 - clip(c))) + 3.0 * (1.0 - 2.0 * c)

    def j0(c):
        return np.sqrt(np.clip(c * (1 - c), 1e-6, None))

    cell = dx * dx

    def mu_and_v(u):
        gx = (np.roll(u, -1, 0) - u) / dx
        gy = (np.roll(u, -1, 1) - u) / dx
        fx = psi_avgx * gx
        fy = psi_avgy * gy
        div = (fx - np.roll(fx, 1, 0)) / dx + (fy - np.roll(fy, 1, 1)) / dx
        m = mu_fn(u) - (kappa / psi) * div
        j = j0(u)
        int_plus = np.sum(j * np.exp(0.5 * m) * psi) * cell
        int_minus = np.sum(j * np.exp(-0.5 * m) * psi) * cell
        y = (-Crate + np.sqrt(Crate**2 + 4.0 * int_plus * int_minus)) / (
            2.0 * int_plus)
        return m, 2.0 * np.log(y), j

    def rhs(u, t):
        m, v, j = mu_and_v(u)
        eta = m + v
        return j * (np.exp(-alpha * eta) - np.exp((1.0 - alpha) * eta))

    rng = np.random.default_rng(5151)
    u0 = np.clip(0.05 + 0.005 * rng.standard_normal((N, N)), 0.01, 0.99)

    traj, volts = [u0.copy()], [mu_and_v(u0)[1]]
    u = u0.copy()
    for k in range(1, n_steps + 1):
        t = (k - 1) * dt
        k1 = rhs(u, t)
        k2 = rhs(u + 0.5 * dt * k1, t + 0.5 * dt)
        k3 = rhs(u + 0.5 * dt * k2, t + 0.5 * dt)
        k4 = rhs(u + dt * k3, t + dt)
        u = u + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
        if k % save_every == 0:
            traj.append(u.copy())
            volts.append(mu_and_v(u)[1])

    np.savez_compressed(
        os.path.join(OUT, "sbm_bv_cc_rk4.npz"),
        u0=u0, psi=psi, traj=np.stack(traj), volts=np.asarray(volts),
        kappa=kappa, alpha=alpha, Crate=Crate, dt=dt,
        n_steps=n_steps, save_every=save_every, dx=dx, N=N,
    )
    print(f"sbm_bv_cc_rk4: traj {np.stack(traj).shape}, "
          f"voltage {volts[0]:+.4f} -> {volts[-1]:+.4f}, "
          f"psi-weighted fill {np.sum(psi*u)/np.sum(psi):.4f}")


# ---------------------------------------------------------------------------
# Rotating-frame GPE, 64x64, directional (ADI) split-step, imaginary time
# ---------------------------------------------------------------------------

def gen_gpe_rot():
    """Rotating-frame GPE ground-state search via directional splitting.

    The per-direction symbols are transcribed from the reference's
    ``GPE2DTSRot.A_terms``/``B_terms``
    (/root/reference/pde_opt/numerics/equations/gross_pitaevskii.py:122-131):

        A_x = 0.5j*(2j*pi*kx)^2 - omega * y * (2j*pi*kx)
        A_y = 0.5j*(2j*pi*ky)^2 + omega * x * (2j*pi*ky)
        B   = -0.5j*((1+e)x^2 + (1-e)y^2) - 1j*k*|psi|^2

    The reference ships no solver able to integrate these mixed-basis
    per-direction terms; this fixture pins the framework's
    ``DirectionalSplitting`` scheme (Strang-symmetric x/y sweeps, B at the
    post-sweep state, mid-step L2 renormalization in imaginary time —
    ``pde_opt_jax/ops/steppers.py:DirectionalSplitting.step``).
    """
    N = 64
    L = 20.0
    dx = L / N
    dt = 2e-4
    n_steps = 45
    save_every = 15
    kint = 500.0      # interaction strength
    e = 0.0
    omega = 0.4

    x = np.linspace(-L / 2 + dx / 2, L / 2 - dx / 2, N)
    X, Y = np.meshgrid(x, x, indexing="ij")
    kx, ky = np.meshgrid(np.fft.fftfreq(N, dx), np.fft.fftfreq(N, dx),
                         indexing="ij")
    tpikx = 2j * np.pi * kx
    tpiky = 2j * np.pi * ky
    Ax = 0.5j * tpikx**2 - omega * Y * tpikx
    Ay = 0.5j * tpiky**2 + omega * X * tpiky

    rng = np.random.default_rng(4242)
    psi0 = np.exp(-(X**2 + Y**2) / 2.0 / 7.0**2) * (
        1.0 + 0.05 * rng.standard_normal((N, N))
        + 0.05j * rng.standard_normal((N, N))
    )
    psi0 = psi0 / np.sqrt(np.sum(np.abs(psi0) ** 2) * dx**2)
    psi0 = psi0.astype(np.complex128)

    dtc = dt * (-1j)                               # imaginary time
    expAx = np.exp(0.5 * dtc * Ax)
    expAy = np.exp(0.5 * dtc * Ay)

    def sweep_x(p):
        return np.fft.ifft(expAx * np.fft.fft(p, axis=0), axis=0)

    def sweep_y(p):
        return np.fft.ifft(expAy * np.fft.fft(p, axis=1), axis=1)

    traj = [psi0.copy()]
    psi = psi0.copy()
    for step in range(1, n_steps + 1):
        psi = sweep_y(sweep_x(psi))
        b = -0.5j * ((1 + e) * X**2 + (1 - e) * Y**2) \
            - 1j * kint * np.abs(psi) ** 2
        psi = psi * np.exp(b * dtc)
        psi = psi / np.sqrt(np.sum(np.abs(psi) ** 2) * dx**2)
        psi = sweep_x(sweep_y(psi))
        if step % save_every == 0:
            traj.append(psi.copy())

    np.savez_compressed(
        os.path.join(OUT, "gpe_rot_dirsplit.npz"),
        psi0=psi0, traj=np.stack(traj), k=kint, e=e, omega=omega,
        dx=dx, dt=dt, n_steps=n_steps, save_every=save_every, N=N, L=L,
    )
    print(f"gpe_rot_dirsplit: traj {np.stack(traj).shape}, "
          f"norm {np.sum(np.abs(psi)**2) * dx**2:.6f}")


if __name__ == "__main__":
    os.makedirs(OUT, exist_ok=True)
    gen_ch2d("fourier", "ch2d_sif_fourier.npz")
    gen_ch2d("fd", "ch2d_sif_fd.npz")
    gen_strang_imag()
    gen_ac2d_tsit5()
    gen_bv_constant_current()
    gen_sbm_bv_constant_current()
    gen_gpe_rot()
