"""Generate the tutorial notebook suite under ``docs/notebooks/``.

The reference ships its on-ramp as ~18 Jupyter notebooks
(``/root/reference/notebooks/*.ipynb`` + ``/root/reference/docs/notebooks/``,
wired into sphinx via nbsphinx, ``docs/index.rst:1-13``).  This framework's
equivalent is a *generated, executed, tested* suite: every notebook below is
produced from this script, executes top-to-bottom on CPU in seconds (crank
the sizes on a GPU), and is re-executed by ``tests/test_notebooks.py`` so the
tutorials can never rot.

Usage:
    python scripts/gen_notebooks.py            # write .ipynb (no outputs)
    python scripts/gen_notebooks.py --execute  # write with executed outputs
"""

from __future__ import annotations

import argparse
import os
import textwrap

import nbformat as nbf

OUT_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "docs", "notebooks")

NOTEBOOKS: dict = {}


def md(src: str):
    return nbf.v4.new_markdown_cell(textwrap.dedent(src).strip())


def code(src: str):
    return nbf.v4.new_code_cell(textwrap.dedent(src).strip())


def notebook(name: str):
    def deco(fn):
        NOTEBOOKS[name] = fn
        return fn

    return deco


SETUP = """
import os, sys
sys.path.insert(0, os.path.abspath(os.path.join(os.getcwd(), "..", "..")))

import jax
import jax.numpy as jnp
import numpy as np
import matplotlib.pyplot as plt

import pde_opt_jax as p
print("backend:", jax.default_backend(), "| devices:", len(jax.devices()))
"""


# ---------------------------------------------------------------------------
# 01 — forward solves
# ---------------------------------------------------------------------------

@notebook("01_solving_pdes")
def _nb01():
    return [
        md("""
        # Solving PDEs: Cahn-Hilliard spinodal decomposition

        The 60-second tour of the forward-solve stack: a `Domain` (uniform
        cell-centered grid + FFT meshes), an equation class
        (`CahnHilliard2DPeriodic`), a single-step integrator
        (`SemiImplicitFourierSpectral`), and `PDEModel.solve`, which compiles
        the whole rollout into **one** `lax.scan` — no Python time loop, no
        per-step dispatch.

        Mirrors the reference workflow in
        `notebooks/run_cahn_hilliard.ipynb`; sizes here are small so the
        notebook executes in seconds on CPU — on a GPU, 256² with
        thousands of saves is just as much one compiled region.
        """),
        code(SETUP),
        md("""
        ## The model

        Cahn-Hilliard with a Flory-Huggins-style chemical potential:
        $\\partial_t c = \\nabla\\cdot\\big(D(c)\\,\\nabla(\\mu(c) - \\kappa\\Delta c)\\big)$.
        Coefficient functions (`mu`, `D`) are injected as callables — swap in a
        neural network later and the same solve becomes trainable.
        """),
        code("""
        N = 64
        L = 0.01 * N
        domain = p.Domain((N, N), ((-L / 2, L / 2), (-L / 2, L / 2)))
        model = p.PDEModel(p.CahnHilliard2DPeriodic, domain,
                           p.SemiImplicitFourierSpectral)

        params = {
            "kappa": 0.002,
            "mu": lambda c: jnp.log(c / (1.0 - c)) + 3.0 * (1.0 - 2.0 * c),
            "D": lambda c: jnp.ones_like(c),
            "derivs": "fd",
        }
        y0 = jnp.clip(0.5 + 0.01 * jax.random.normal(jax.random.PRNGKey(0), (N, N)),
                      0.0, 1.0)
        ts = np.linspace(0.0, 0.01, 6)
        sol = model.solve(params, y0, ts, {"A": 0.5}, dt0=1e-5)
        sol.shape
        """),
        code("""
        fig, axes = plt.subplots(1, len(ts), figsize=(3 * len(ts), 3))
        for ax, t, frame in zip(axes, ts, np.asarray(sol)):
            ax.imshow(frame, cmap="RdBu", vmin=0, vmax=1)
            ax.set_title(f"t = {t:.3f}")
            ax.axis("off")
        plt.tight_layout()
        """),
        md("""
        Mass is conserved to solver precision (the FD flux form is exactly
        conservative):
        """),
        code("""
        drift = abs(float(sol[-1].mean() - sol[0].mean()))
        print(f"mass drift: {drift:.2e}")
        assert drift < 1e-4
        """),
        md("""
        ## Batched solves

        Equations are **batch-transparent**: hand `solve` a `(B, N, N)` stack
        and the whole batch integrates inside the same single scan — no vmap
        retrace, no outer loop. This is the primitive that scales to the
        4096-env RL fleets later in the series.
        """),
        code("""
        y0b = jnp.clip(0.5 + 0.01 * jax.random.normal(jax.random.PRNGKey(1), (8, N, N)),
                       0.0, 1.0)
        solb = model.solve(params, y0b, ts, {"A": 0.5}, dt0=1e-5)
        print(solb.shape)   # (saves, batch, N, N)
        """),
    ]


# ---------------------------------------------------------------------------
# 02 — advection-diffusion
# ---------------------------------------------------------------------------

@notebook("02_advection_diffusion")
def _nb02():
    return [
        md("""
        # Advection-diffusion with a controllable velocity field

        $\\partial_t u = -\\nabla\\cdot(u\\,\\mathbf v) + D\\Delta u$ — the
        transport workhorse behind the `AdvectionDiffusion-v0` control
        environment. The velocity field is a callable `v(t, X, Y) -> (vx, vy)`;
        in the RL setting the control value enters through it.

        Mirrors `notebooks/run_advection_diffusion.ipynb` in the reference.
        """),
        code(SETUP),
        code("""
        N = 64
        domain = p.Domain((N, N), ((-0.5, 0.5), (-0.5, 0.5)))
        X, Y = domain.mesh()

        def rotating_flow(t, x, y):
            return (-2.0 * y, 2.0 * x)     # solid-body rotation

        eq = p.AdvectionDiffusion2D(domain, rotating_flow,
                                    diffusion_coeff=2e-4, derivs="fd")
        u0 = jnp.exp(-((X - 0.2) ** 2 + Y ** 2) / 0.005)
        """),
        code("""
        stepper = p.Tsit5()
        ts, dt, nsub = [0.0], 2.5e-4, 400
        frames = [u0]
        u = u0
        for k in range(4):
            u = p.evolve(stepper, eq.rhs, u, k * nsub * dt, dt, nsub)
            frames.append(u)
            ts.append((k + 1) * nsub * dt)

        fig, axes = plt.subplots(1, 5, figsize=(15, 3))
        for ax, t, f in zip(axes, ts, frames):
            ax.imshow(np.asarray(f), cmap="viridis")
            ax.set_title(f"t = {t:.2f}")
            ax.axis("off")
        plt.tight_layout()
        """),
        md("""
        The blob rotates about the origin while diffusing. Transport is in
        conservative flux form, so total mass is invariant:
        """),
        code("""
        m0, m1 = float(frames[0].sum()), float(frames[-1].sum())
        print(f"mass: {m0:.6f} -> {m1:.6f}")
        assert abs(m1 - m0) / m0 < 1e-4
        """),
        md("""
        A second-order MMS convergence gate for this equation lives in the
        convergence notebook (04) and in `tests/test_rhs_convergence.py`;
        the smoothed-boundary variant (`smooth=True`) confines the transport
        to an irregular domain (notebook 06).
        """),
    ]


# ---------------------------------------------------------------------------
# 03 — interface physics oracles
# ---------------------------------------------------------------------------

@notebook("03_interfaces_allen_cahn")
def _nb03():
    return [
        md("""
        # Interface profiles: the tanh oracle

        Both Allen-Cahn and Cahn-Hilliard relax a diffuse interface to the
        analytic profile $c(x) = \\tanh\\big(x / \\sqrt{2\\kappa}\\big)$
        (for the double-well $\\mu(c) = c^3 - c$). This closed form is the
        physics oracle the test suite gates on
        (`tests/test_solvers.py`) — this notebook shows it interactively.

        1D problems are `(Nx, 1)` grids — spatial axes always trail, so the
        same stencils/steppers serve 1D/2D/3D and any leading batch axes.
        """),
        code(SETUP),
        code("""
        # Precision note: this is a tight-tolerance oracle; run it in f64 on
        # CPU (the f32 check lives in the golden-parity tests).
        jax.config.update("jax_enable_x64", True)

        KAPPA = 0.002
        Nx = 256
        Lx = 0.01 * Nx
        domain = p.Domain((Nx, 1), ((-Lx / 2, Lx / 2), (-0.005, 0.005)),
                          dtype=jnp.float64)
        x = np.asarray(domain.axes()[0])

        eq = p.AllenCahn2DPeriodic(domain, KAPPA,
                                   mu=lambda c: c**3 - c,
                                   R=lambda c: jnp.ones_like(c), derivs="fd")
        y0 = jnp.ones((Nx, 1), jnp.float64).at[: Nx // 2, :].set(-1.0)  # step
        ys = p.integrate_adaptive(p.Tsit5(), eq.rhs, y0,
                                  jnp.array([0.0, 2.0, 10.0]), 5e-5,
                                  rtol=1e-4, atol=1e-6)
        analytic = np.tanh(x / np.sqrt(2 * KAPPA))
        """),
        code("""
        plt.figure(figsize=(7, 4))
        plt.plot(x, np.asarray(y0).squeeze(), ":", label="initial step")
        plt.plot(x, np.asarray(ys[1]).squeeze(), alpha=0.7, label="t = 2")
        plt.plot(x, np.asarray(ys[2]).squeeze(), lw=2, label="t = 10")
        plt.plot(x, analytic, "--", label=r"$\\tanh(x/\\sqrt{2\\kappa})$")
        plt.xlim(-0.6, 0.6); plt.legend(); plt.xlabel("x"); plt.ylabel("c")
        plt.title("Allen-Cahn interface relaxes to the tanh profile")
        """),
        code("""
        half = slice(Nx // 4, 3 * Nx // 4)   # away from the periodic wrap
        err = float(np.abs(np.asarray(ys[2]).squeeze()[half] - analytic[half]).max())
        print(f"max |c - tanh| on the central half: {err:.2e}")
        assert err < 2e-3
        """),
        md("""
        The conserved dynamics (Cahn-Hilliard, same double well) reach the
        same profile through the `SemiImplicitFourierSpectral` stepper —
        that variant is `tests/test_solvers.py::test_1d_cahn_hilliard`.
        Full rollouts are additionally pinned **array-for-array** against
        fixtures generated from the reference implementation
        (`tests/test_golden_parity.py`, `scripts/gen_goldens.py`).
        """),
    ]


# ---------------------------------------------------------------------------
# 04 — convergence / MMS
# ---------------------------------------------------------------------------

@notebook("04_convergence_mms")
def _nb04():
    return [
        md("""
        # Order-of-accuracy testing with manufactured solutions

        Pick an exact field $u^*(x,y,t)$, push it through the *symbolic* form
        of the PDE operator (sympy), and compare against the numeric `rhs`
        evaluated at $u^*$ over a ladder of grids. The fitted log-log slope
        is the observed order of accuracy — the FD stencils here are
        second-order.

        The `MMS` engine takes any sympy expression and any operator factory;
        the per-equation symbolic twins (`SymbolicAllenCahn2DPeriodic`, …)
        are thin wrappers over it. Mirrors the reference's
        `tests/test_rhs_convergence.py` + `notebooks/test_sympy.ipynb`.
        """),
        code(SETUP),
        code("""
        import sympy as sp
        from pde_opt_jax.models.symbolic import SymbolicCahnHilliard2DPeriodic
        from pde_opt_jax.utils.testing import check_convergence, plot_convergence

        x, y, t = sp.symbols("x y t", real=True)
        u_star = sp.sin(2 * x) * sp.cos(3 * y) * sp.exp(-sp.Rational(7, 10) * t)

        mu_sym = lambda u: u ** 3 - u
        res = check_convergence(
            numeric=p.CahnHilliard2DPeriodic,
            symbolic=SymbolicCahnHilliard2DPeriodic,
            numeric_args={"kappa": 0.01, "mu": lambda c: c**3 - c,
                          "D": lambda c: jnp.ones_like(c), "derivs": "fd"},
            symbolic_args={"kappa": 0.01, "mu_sym": mu_sym,
                           "D_sym": lambda u: 1, "u_star": u_star},
            Ns=[32, 64, 128, 256],
            L=2 * float(np.pi),
            dtype=jnp.float64,
        )
        print("dx:", [f"{d:.4f}" for d in res.dxs])
        print("L2 err:", [f"{e:.2e}" for e in res.errors])
        print(f"fitted order: {res.order():.3f}")
        assert abs(res.order() - 2.0) < 0.25
        """),
        code("""
        plot_convergence(res.dxs, res.errors, orders=(1.0, 2.0))
        """),
        md("""
        ## Rolling your own manufactured problem

        `MMS` works for any operator — here a bespoke reaction-diffusion:
        """),
        code("""
        from pde_opt_jax.models.symbolic import MMS, sym_lap

        def reaction_diffusion_op(u, syms, t):
            return 0.1 * sym_lap(u, syms) + u - u ** 3

        N = 64
        domain = p.Domain((N, N), ((-np.pi, np.pi), (-np.pi, np.pi)))
        mms = MMS(domain, u_star, reaction_diffusion_op)

        u = mms.u_exact(0.3)
        rhs_exact = mms.rhs_exact(0.3)
        print(u.shape, rhs_exact.shape, float(jnp.abs(rhs_exact).max()))
        """),
    ]


# ---------------------------------------------------------------------------
# 05 — boundary conditions
# ---------------------------------------------------------------------------

@notebook("05_boundary_conditions")
def _nb05():
    return [
        md("""
        # Configurable boundary conditions

        Periodic, Dirichlet, and Neumann conditions per axis via ghost-cell
        padding — batch-transparent and jit/vmap/grad-safe. This restores
        the reference's ghost BC API
        (`notebooks/test_boundary_conditions.ipynb`), which its shipped
        package (periodic-only) had lost.

        The spec is `{axis: (kind, value)}` with kinds `"periodic"`,
        `"dirichlet"` (face value, 2nd-order ghost), `"neumann"` (outward
        normal derivative at the face).
        """),
        code(SETUP),
        code("""
        from pde_opt_jax.ops.boundary import laplacian

        # Dirichlet-0 walls: sin(pi x) is an eigenfunction of the Laplacian,
        # so heat flow just decays it at the exact rate pi^2.
        N = 64
        h = 1.0 / N
        x = (jnp.arange(N) + 0.5) * h              # cell centers in (0, 1)
        lap = laplacian(h, {0: ("dirichlet", 0.0)})

        u = jnp.sin(jnp.pi * x)
        dt = 0.2 * h * h
        steps = 800
        for _ in range(steps):
            u = u + dt * lap(u)
        decay = float(jnp.exp(-jnp.pi ** 2 * dt * steps))
        plt.plot(np.asarray(x), np.sin(np.pi * np.asarray(x)), ":", label="t = 0")
        plt.plot(np.asarray(x), np.asarray(u), lw=2, label="relaxed")
        plt.plot(np.asarray(x), decay * np.sin(np.pi * np.asarray(x)), "--",
                 label=r"$e^{-\\pi^2 t}\\sin(\\pi x)$")
        plt.legend(); plt.xlabel("x")
        err = float(jnp.abs(u - decay * jnp.sin(jnp.pi * x)).max())
        print(f"max error vs analytic decay: {err:.2e}")
        assert err < 2e-3
        """),
        md("""
        Neumann (zero-flux) walls conserve mass where a periodic wrap would
        teleport it:
        """),
        code("""
        lap_nf = laplacian((h, h), {0: ("neumann", 0.0), 1: ("neumann", 0.0)})
        X, Y = jnp.meshgrid(x, x, indexing="ij")
        u2 = jnp.exp(-((X - 0.8) ** 2 + (Y - 0.8) ** 2) / 0.01)  # corner blob
        m0 = float(u2.sum())
        for _ in range(400):
            u2 = u2 + 0.2 * h * h * lap_nf(u2)
        print(f"mass: {m0:.4f} -> {float(u2.sum()):.4f}")
        plt.imshow(np.asarray(u2)); plt.title("no-flux walls"); plt.colorbar()
        assert abs(float(u2.sum()) - m0) / m0 < 1e-4
        """),
        md("""
        Mixed specs (`{0: ("dirichlet", g), 1: ("periodic", None)}`, array-
        valued boundary data, a trailing time argument) are covered in
        `tests/test_boundary.py`. Irregular (non-box) domains use the
        smoothed-boundary method instead — next notebook.
        """),
    ]


# ---------------------------------------------------------------------------
# 06 — smoothed boundary
# ---------------------------------------------------------------------------

@notebook("06_smoothed_boundary")
def _nb06():
    return [
        md("""
        # Irregular domains: the smoothed-boundary method

        A binary mask becomes a smooth level-set $\\psi$ by integrating a
        curvature-regularized Allen-Cahn flow (one compiled adaptive
        `while_loop` on device); SBM equation variants then weight their
        fluxes by $\\psi$ so the PDE lives only inside the shape, with
        contact-angle control on the wall.

        Mirrors `notebooks/smooth_boundary.ipynb` and
        `docs/notebooks/solving_pde_smoothed_boundary.ipynb` in the
        reference.
        """),
        code(SETUP),
        code("""
        N = 64
        yy, xx = jnp.meshgrid(jnp.arange(N), jnp.arange(N), indexing="ij")
        disk = ((xx - N / 2) ** 2 + (yy - N / 2) ** 2 < (0.35 * N) ** 2)

        shape = p.Shape(disk.astype(jnp.float32), dx=(1.0, 1.0),
                        smooth_epsilon=2.0, smooth_tf=4.0)
        fig, axes = plt.subplots(1, 2, figsize=(9, 4))
        axes[0].imshow(np.asarray(disk)); axes[0].set_title("binary mask")
        im = axes[1].imshow(np.asarray(shape.smooth)); axes[1].set_title(r"smoothed $\\psi$")
        plt.colorbar(im, ax=axes[1])
        psi = shape.smooth
        assert float(psi.min()) >= 0.001 and float(psi.max()) <= 1.0
        """),
        md("""
        ## Allen-Cahn inside the disk

        The SBM Allen-Cahn weights the Laplacian by $\\psi$ and adds a
        contact-angle source on the wall ($\\theta$ may be time-dependent):
        """),
        code("""
        L = 0.01 * N
        domain = p.Domain((N, N), ((-L / 2, L / 2), (-L / 2, L / 2)),
                          geometry=shape)
        eq = p.AllenCahn2DSmoothedBoundary(
            domain, kappa=2e-4,
            f=lambda c: 0.25 * (c ** 2) * (1 - c) ** 2 + 1e-8,
            mu=lambda c: c ** 3 - c,
            R=lambda c: jnp.ones_like(c),
            theta=lambda t: jnp.pi / 2,
        )
        u0 = 0.5 + 0.3 * jnp.sin(8 * jnp.pi * xx / N)
        u = p.evolve(p.RK4(), eq.rhs, u0, 0.0, 2e-4, 600)
        plt.imshow(np.asarray(u * psi)); plt.colorbar()
        plt.title("phase field confined to the disk")
        assert bool(jnp.isfinite(u).all())
        """),
        md("""
        ## Graph-Laplacian shape modes

        Low eigenmodes of the mask's 4-neighbour graph Laplacian give a
        spectral basis *of the shape itself* (host-side scipy Lanczos,
        one-time preprocessing):
        """),
        code("""
        modes, vals = shape.get_shape_modes(4)
        fig, axes = plt.subplots(1, 4, figsize=(13, 3.2))
        for i, ax in enumerate(axes):
            ax.imshow(np.asarray(modes[..., i]))
            ax.set_title(f"$\\\\lambda_{i}$ = {float(vals[i]):.4f}")
            ax.axis("off")
        plt.tight_layout()
        """),
    ]


# ---------------------------------------------------------------------------
# 07 — Butler-Volmer electrochemistry
# ---------------------------------------------------------------------------

@notebook("07_butler_volmer")
def _nb07():
    return [
        md("""
        # Galvanostatic Butler-Volmer: charging a phase-separating particle

        Lithiation of an electrode particle under constant current: an
        Allen-Cahn phase field driven by Butler-Volmer insertion kinetics,
        with the overpotential eliminated by the constant-current closure
        (a per-particle *global* integral — a reduction inside the RHS).
        `get_voltage` recovers the cell voltage.

        Mirrors `notebooks/run_butler_volmer_sbm.ipynb`.
        """),
        code(SETUP),
        code("""
        N = 48
        domain = p.Domain((N, N), ((-0.5, 0.5), (-0.5, 0.5)))
        clip = lambda c: jnp.clip(c, 1e-4, 1 - 1e-4)
        eq = p.AllenCahn2DPeriodicButlerVolmerConstantCurrent(
            domain,
            kappa=5e-4,
            mu=lambda c: jnp.log(clip(c) / (1 - clip(c))) + 3.0 * (1.0 - 2.0 * c),
            j0=lambda c: jnp.sqrt(jnp.clip(c * (1 - c), 1e-6, None)),
            alpha=0.5,
            Crate=1.0,
        )
        u = jnp.clip(0.05 + 0.005 * jax.random.normal(jax.random.PRNGKey(0), (N, N)),
                     0.01, 0.99)
        """),
        code("""
        dt, chunk, nchunk = 5e-4, 40, 10
        fill, volt, snaps = [], [], []
        for i in range(nchunk):
            u = p.evolve(p.RK4(), eq.rhs, u, i * chunk * dt, dt, chunk)
            fill.append(float(u.mean()))
            volt.append(float(eq.get_voltage(u)))
            if i % 3 == 0:
                snaps.append(np.asarray(u))

        fig, axes = plt.subplots(1, len(snaps) + 1, figsize=(4 * (len(snaps) + 1), 3.2))
        for k, (ax, s) in enumerate(zip(axes, snaps)):
            ax.imshow(s, vmin=0, vmax=1, cmap="inferno"); ax.axis("off")
            ax.set_title(f"SOC = {s.mean():.2f}")
        axes[-1].plot(fill, volt, "o-")
        axes[-1].set_xlabel("state of charge"); axes[-1].set_ylabel("voltage")
        plt.tight_layout()
        """),
        md("""
        Under galvanostatic control the mean filling rate is pinned to the
        applied C-rate — a sharp conservation check on the closure:
        """),
        code("""
        area = domain.L[0] * domain.L[1]
        measured = (fill[-1] - fill[0]) / (chunk * dt * (nchunk - 1))
        print(f"d<c>/dt measured {measured:.3f} vs Crate/area {1.0/area:.3f}")
        assert abs(measured - 1.0 / area) < 0.05
        """),
        md("""
        The smoothed-boundary variant
        (`AllenCahn2DSmoothedBoundaryButlerVolmerConstantCurrent`) does the
        same on an irregular particle: its global integrals become
        $\\psi$-weighted. The whole family is batch-transparent — the
        per-env global integral stays per-env under a leading batch axis
        (see `tests/test_butler_volmer.py`) — which is what lets
        Butler-Volmer env fleets run in lockstep:
        `make_butler_volmer_control_env` turns this physics into an RL
        charging-protocol problem (the agent drives the C-rate), stepped
        by the same XLA RK4 path as this notebook.
        """),
    ]


# ---------------------------------------------------------------------------
# 08 — GPE
# ---------------------------------------------------------------------------

@notebook("08_gross_pitaevskii")
def _nb08():
    return [
        md("""
        # Gross-Pitaevskii: BEC ground states and vortices

        Imaginary-time Strang splitting ($\\tau = -i t$, per-substep L²
        renormalization) relaxes a trapped condensate to its ground state;
        in the strong-interaction limit the density approaches the
        Thomas-Fermi profile. The wavefunction is stored real-stacked
        `(..., 2)` so every kernel stays in real dtypes.

        Mirrors `notebooks/test_thomas_fermi.ipynb` and the `run_gpe`
        workloads (physical constants as in the reference's ⁸⁷Rb-like setup).
        """),
        code(SETUP),
        code("""
        from pde_opt_jax.utils import density, initialize_Psi

        # Physical scales (as in tests/test_solvers.py::..._thomas_fermi).
        atoms, hbar = 5e5, 1.05e-34
        omega = 2 * np.pi * 10
        omega_z = np.sqrt(8) * omega
        mass, a0 = 3.8175406e-26, 5.29177210903e-11
        a_s = 100 * a0
        N = 64
        x_s = np.sqrt(hbar / (mass * omega))
        t_s = 1 / omega
        Lx = 150e-6 / x_s
        k = 4 * np.pi * a_s * atoms * np.sqrt((mass * omega_z) / (2 * np.pi * hbar))

        domain = p.Domain((N, N), ((-Lx / 2, Lx / 2), (-Lx / 2, Lx / 2)))
        dx = float(domain.dx[0])
        Psi0 = initialize_Psi(N, width=50, vortexnumber=0)
        Psi0 = Psi0 / jnp.sqrt(jnp.sum(density(Psi0)) * dx * dx)

        eq = p.GPE2DTSControl(domain, k, 0.0, lambda t, x, y: 0.0, trap_factor=1.0)
        solver = p.StrangSplitting(eq.A_term, dx, eq.fft, eq.ifft, -1j)
        y0 = jnp.stack([Psi0.real, Psi0.imag], axis=-1)
        yT = p.evolve(solver, eq.B_terms, y0, 0.0, 1e-5 / t_s, 8000)
        rho = density(yT[..., 0] + 1j * yT[..., 1])
        """),
        code("""
        # Thomas-Fermi: n = max(mu - V, 0)/k, mu fixed by the norm.
        X, Y = domain.mesh()
        wx2 = wy2 = 0.5
        mu_tf = np.sqrt((1.0 * k * np.sqrt(wx2) * np.sqrt(wy2)) / (2 * np.pi))
        V = 0.5 * (wx2 * X ** 2 + wy2 * Y ** 2)
        n_tf = np.clip((mu_tf - np.asarray(V)) / k, 0, None)
        n_tf /= n_tf.sum() * dx * dx
        n = np.asarray(rho) / (np.asarray(rho).sum() * dx * dx)

        fig, axes = plt.subplots(1, 3, figsize=(13, 3.6))
        axes[0].imshow(n); axes[0].set_title("ground-state density")
        axes[1].imshow(n_tf); axes[1].set_title("Thomas-Fermi")
        mid = N // 2
        axes[2].plot(np.asarray(X[:, mid]), n[:, mid], label="numeric")
        axes[2].plot(np.asarray(X[:, mid]), n_tf[:, mid], "--", label="TF")
        axes[2].legend(); axes[2].set_title("central slice")
        rel = np.abs(n - n_tf).max() / n_tf.max()
        print(f"max density error vs TF: {rel:.3f}")
        assert rel < 0.05
        """),
        md("""
        ## Imprinting and detecting vortices

        `initialize_Psi` winds a quantized phase into the initial state;
        `detect_vortices` finds them by plaquette phase winding (the
        jit-safe core, `vortex_winding`, is usable inside batched reward
        functions):
        """),
        code("""
        from pde_opt_jax.utils.rl import detect_vortices

        psi_v = initialize_Psi(N, width=N // 3, vortexnumber=1)
        out = detect_vortices(psi_v,
                              amp_thresh=float(jnp.abs(psi_v).max() ** 2) * 0.01)
        print("vortices:", out["num_vortices"],
              "| total charge:", out["total_topological_charge"])
        plt.imshow(np.angle(np.asarray(psi_v)), cmap="twilight")
        plt.title("imprinted phase winding"); plt.colorbar()
        assert out["num_vortices"] >= 1
        """),
        md("""
        Real-time dynamics use `time_scale=1.0`; the rotating-frame family
        (`GPE2DTSRot`, $\\Omega L_z$ term) integrates with the
        `DirectionalSplitting` stepper — see `tests/test_gpe_rot.py`. The
        RL control preset (`make_gpe_control_env`) drives an optical spot
        through the same physics at fleet scale (`bench.py` times it).
        """),
    ]


# ---------------------------------------------------------------------------
# 09 — implicit + adaptive stepping
# ---------------------------------------------------------------------------

@notebook("09_implicit_and_adaptive")
def _nb09():
    return [
        md("""
        # Stiff problems: implicit and adaptive integrators

        Three tools for stiffness, all `lax`-native (no host loop):

        * `SemiImplicitFourierSpectral` — the workhorse: linear stiffness
          absorbed exactly in Fourier space, one FFT pair per step;
        * `ImplicitEuler` — Newton-GMRES backward Euler (matrix-free) when
          the stiffness is not diagonalizable by FFT;
        * `integrate_adaptive` — Tsit5 + PID step-size control in a
          `while_loop`, with dense save-at.

        Mirrors the reference's `notebooks/test_implicit.ipynb` (diffrax
        `ImplicitEuler` + lineax GMRES) and its PIDController usage.
        """),
        code(SETUP),
        code("""
        # Stiff diffusion: explicit Euler at this dt explodes; implicit is clean.
        N = 64
        h = 1.0 / N
        x = (jnp.arange(N) + 0.5) * h
        D = 1.0
        rhs = lambda u, t: D * (jnp.roll(u, 1) + jnp.roll(u, -1) - 2 * u) / h**2

        u0 = jnp.sin(2 * jnp.pi * x)
        dt = 5.0 * h * h / D          # 10x the explicit stability limit
        steps = 200
        u_imp = p.evolve(p.ImplicitEuler(newton_iters=3, gmres_iters=30),
                         rhs, u0, 0.0, dt, steps)
        u_exp = p.evolve(p.Euler(), rhs, u0, 0.0, dt, steps)
        exact = u0 * jnp.exp(-D * (2 * jnp.pi) ** 2 * dt * steps)
        print("implicit max|err|:", float(jnp.abs(u_imp - exact).max()))
        print("explicit max|u|  :", float(jnp.abs(u_exp).max()), "(diverged)")
        assert float(jnp.abs(u_imp - exact).max()) < 1e-2
        diverged = (not bool(jnp.isfinite(u_exp).all())) or \\
                   float(jnp.abs(u_exp).max()) > 1e3
        assert diverged
        """),
        code("""
        # Adaptive Tsit5 + PID on a problem with a fast transient:
        #   u' = -50 (u - cos t),  u(0) = 0.
        from pde_opt_jax.ops import integrate_adaptive

        lam = 50.0
        rhs_fast = lambda u, t: -lam * (u - jnp.cos(t))
        ts = jnp.linspace(0.0, 2.0, 41)
        ys = integrate_adaptive(p.Tsit5(), rhs_fast, jnp.array(0.0),
                                ts, 1e-3, rtol=1e-6, atol=1e-8)
        exact = (lam**2 * jnp.cos(ts) + lam * jnp.sin(ts)
                 - lam**2 * jnp.exp(-lam * ts)) / (lam**2 + 1)
        plt.plot(np.asarray(ts), np.asarray(ys), "o", label="adaptive Tsit5")
        plt.plot(np.asarray(ts), np.asarray(exact), "-", label="exact")
        plt.legend(); plt.xlabel("t")
        err = float(jnp.abs(ys - exact).max())
        print(f"max error: {err:.2e}")
        assert err < 2e-3   # f32 default; ~1e-7 under jax_enable_x64
        """),
        md("""
        For *batched* states, `integrate_adaptive(..., batch_ndim=1)` takes
        each instance's error norm separately and lets the strictest one
        govern the shared lockstep dt. Env fleets use fixed-dt `evolve` —
        adaptive dt would break lockstep batching (SURVEY §7).
        """),
    ]


# ---------------------------------------------------------------------------
# 10 — inverse problems
# ---------------------------------------------------------------------------

@notebook("10_inverse_problems")
def _nb10():
    return [
        md("""
        # Inverse problems: fitting parameters through the solver

        `PDEModel.train` differentiates through the whole rollout:
        Levenberg-Marquardt (forward-mode JVPs → normal equations) for small
        parameter vectors, Adam / L-BFGS (checkpointed reverse-mode) for
        NN-sized ones. `method="least_squares_jit"` runs LM entirely inside
        one `lax.while_loop` — zero per-iteration host sync, the
        device-resident training loop.

        Mirrors `notebooks/test_optimization_model.ipynb`.
        """),
        code(SETUP),
        code("""
        N = 32
        L = 0.01 * N
        domain = p.Domain((N, N), ((-L / 2, L / 2), (-L / 2, L / 2)))
        model = p.PDEModel(p.CahnHilliard2DPeriodic, domain,
                           p.SemiImplicitFourierSpectral)

        true = {"kappa": 0.004, "mu": lambda c: c**3 - c,
                "D": lambda c: jnp.ones_like(c), "derivs": "fd"}
        y0 = jnp.clip(0.5 + 0.05 * jax.random.normal(jax.random.PRNGKey(0), (N, N)), 0, 1)
        ts = np.linspace(0.0, 0.004, 9)
        sol = model.solve(true, y0, ts, {"A": 0.5}, dt0=2.5e-4)
        data = {"ys": list(sol), "ts": list(ts)}
        """),
        code("""
        fit = model.train(
            data, inds=[[0, 2, 4], [4, 6, 8]],
            opt_parameters={"kappa": 0.01},          # wrong initial guess
            other_parameters={"mu": true["mu"], "D": true["D"], "derivs": "fd"},
            solver_parameters={"A": 0.5},
            weights={"kappa": None}, lambda_reg=0.0,
            method="least_squares_jit",              # fully jitted LM
            max_steps=30, dt0=2.5e-4,
        )
        print(f"recovered kappa = {float(fit['kappa']):.5f} (true 0.004)")
        assert abs(float(fit["kappa"]) - 0.004) < 3e-4
        """),
        md("""
        ## Legendre-parameterized coefficient functions

        The `ChemicalPotentialLegendrePolynomials` /
        `DiffusionLegendrePolynomials` families put a recurrence-evaluated
        Legendre expansion behind μ and D (positivity of D via `exp`); their
        coefficients are pytree leaves, so the same `train` call fits them:
        """),
        code("""
        true_mu = p.ChemicalPotentialLegendrePolynomials(jnp.array([0.0, 1.0, 0.5]))
        solL = model.solve({"kappa": 0.004, "mu": true_mu, "D": true["D"],
                            "derivs": "fd"}, y0, ts, {"A": 0.5}, dt0=2.5e-4)
        fitL = model.train(
            {"ys": list(solL), "ts": list(ts)}, [[0, 2, 4], [4, 6, 8]],
            opt_parameters={"mu": p.ChemicalPotentialLegendrePolynomials(jnp.zeros(3))},
            other_parameters={"kappa": 0.004, "D": true["D"], "derivs": "fd"},
            solver_parameters={"A": 0.5},
            weights={"mu": None}, lambda_reg=0.0,
            method="least_squares", max_steps=40, dt0=2.5e-4,
        )
        coeffs = np.asarray(fitL["mu"].expansion.params)
        print("fit Legendre coeffs:", np.round(coeffs, 4), "true [0.0, 1.0, 0.5]")
        # Gauge note: Cahn-Hilliard only sees grad(mu), so the CONSTANT
        # Legendre coefficient is unidentifiable — compare the rest.
        assert np.allclose(coeffs[1:], [1.0, 0.5], atol=0.05)
        """),
        md("""
        `PDEModel.optimize` is the same machinery pointed at a scalar
        objective over the trajectory (optimal control); the NN notebook
        (11) and the 3D notebook (12) scale this up. Regularization enters
        as a pytree of per-leaf `weights` + a global `lambda_reg`, exactly
        like the reference (`pde_model.py:173-224`).
        """),
    ]


# ---------------------------------------------------------------------------
# 11 — NN chemical potential
# ---------------------------------------------------------------------------

@notebook("11_optimize_neural_network")
def _nb11():
    return [
        md("""
        # Learning a neural-network chemical potential

        Replace μ(c) with a translation-equivariant `PeriodicCNN`
        (CIRCULAR-padded, stride-1 — respects the torus) and fit its weights
        by reverse-mode differentiation through checkpointed rollouts.

        Mirrors `docs/notebooks/optimization_neural_network.ipynb` and
        `notebooks/optimize_nn_script.py` in the reference (which reports
        ~4 min / 100 steps at 32²; `bench.py`'s `train_grad` config
        times the same gradient path at fleet scale).
        """),
        code(SETUP),
        code("""
        N = 32
        L = 0.01 * N
        domain = p.Domain((N, N), ((-L / 2, L / 2), (-L / 2, L / 2)))
        model = p.PDEModel(p.CahnHilliard2DPeriodic, domain,
                           p.SemiImplicitFourierSpectral)

        clip = lambda c: jnp.clip(c, 1e-3, 1 - 1e-3)
        true_mu = lambda c: jnp.log(clip(c) / (1 - clip(c))) + 3.0 * (1 - 2 * c)
        D = lambda c: jnp.ones_like(c)

        y0 = jnp.clip(0.5 + 0.01 * jax.random.normal(jax.random.PRNGKey(0), (N, N)), 0, 1)
        ts = np.linspace(0.0, 0.004, 9)
        sol = model.solve({"kappa": 0.002, "mu": true_mu, "D": D, "derivs": "fd"},
                          y0, ts, {"A": 0.5}, dt0=2.5e-4)
        """),
        code("""
        cnn = p.PeriodicCNN(in_channels=1, hidden_channels=(16, 16), out_channels=1,
                            kernel_size=3, key=jax.random.PRNGKey(1))
        res = model.train(
            {"ys": list(sol), "ts": list(ts)}, [[0, 2, 4], [4, 6, 8]],
            opt_parameters={"mu": cnn},
            other_parameters={"kappa": 0.002, "D": D, "derivs": "fd"},
            solver_parameters={"A": 0.5},
            weights={"mu": None}, lambda_reg=0.0,
            method="adam", max_steps=15, dt0=2.5e-4, learning_rate=1e-2,
        )
        refit = model.solve({**res}, y0, ts, {"A": 0.5}, dt0=2.5e-4)
        rmse = float(jnp.sqrt(jnp.mean((refit - sol) ** 2)))
        print(f"trajectory RMSE after 15 Adam steps: {rmse:.3e}")
        assert rmse < 0.05
        """),
        code("""
        fig, axes = plt.subplots(1, 2, figsize=(9, 3.8))
        axes[0].imshow(np.asarray(sol[-1]), vmin=0, vmax=1)
        axes[0].set_title("data (true mu)"); axes[0].axis("off")
        axes[1].imshow(np.asarray(refit[-1]), vmin=0, vmax=1)
        axes[1].set_title("refit (CNN mu)"); axes[1].axis("off")
        plt.tight_layout()
        """),
        md("""
        More steps / bigger grids tighten the fit; the reference trains
        1000 BFGS steps at 128² on a GPU (`run_training.sh`). Here
        `method="mse"` gives optax L-BFGS with zoom line search; everything
        stays one compiled graph per optimizer step. `Mixer2d` (MLP-mixer)
        is the other NN family in `pde_opt_jax.models.functions`.
        """),
    ]


# ---------------------------------------------------------------------------
# 12 — 3D optimization
# ---------------------------------------------------------------------------

@notebook("12_optimization_3d")
def _nb12():
    return [
        md("""
        # 3D Cahn-Hilliard: fitting μ and D in 32³

        The reference's 3D workload
        (`docs/notebooks/optimization_3D.ipynb`): generate a 3D trajectory
        with known Legendre-parameterized chemical potential and mobility,
        then recover both coefficient vectors by Levenberg-Marquardt through
        the rollout. This notebook runs a 16³ miniature so it executes in
        seconds; `examples/optimize_3d.py` is the full 32³ driver, and the
        batched 3D spectral path has a cas-matmul macro
        (`ops/cas3d.py`; `bench.py` times it against the XLA-FFT path).
        """),
        code(SETUP),
        code("""
        from pde_opt_jax.models.cahn_hilliard import CahnHilliard3DPeriodic

        # LM normal equations through a 4th-order operator are sensitive to
        # rounding at miniature scale; run this CPU demo in f64 (the GPU
        # path trains in f32 with the longer trajectories of
        # examples/optimize_3d.py).
        jax.config.update("jax_enable_x64", True)

        N = 16
        L = 0.01 * N
        domain = p.Domain((N, N, N), ((-L / 2, L / 2),) * 3)
        model = p.PDEModel(CahnHilliard3DPeriodic, domain,
                           p.SemiImplicitFourierSpectral)

        mu = lambda c: c**3 - c
        true_D = p.DiffusionLegendrePolynomials(jnp.array([0.3, 0.2]))
        y0 = jnp.clip(0.5 + 0.01 * jax.random.normal(jax.random.PRNGKey(2), (N,) * 3), 0, 1)
        ts = np.linspace(0.0, 0.002, 5)
        sol = model.solve({"kappa": 0.002, "mu": mu, "D": true_D,
                           "derivs": "fd"}, y0, ts, {"A": 0.5}, dt0=2.5e-4)
        print(sol.shape)
        """),
        code("""
        mid = N // 2
        fig, axes = plt.subplots(1, 4, figsize=(13, 3.2))
        for ax, idx in zip(axes, [0, 1, 2, 4]):
            ax.imshow(np.asarray(sol[idx][mid]))
            ax.set_title(f"t = {ts[idx]:.4f} (z-slice)"); ax.axis("off")
        plt.tight_layout()
        """),
        md("""
        Recover the mobility coefficients by LM through the 3D rollout. (At
        this miniature scale we fit D with μ known: the *joint* μ+D fit has
        a near-degeneracy — scaling μ up and D down leaves the flux
        D(c)∇μ(c) almost unchanged over a short trajectory — which needs
        the longer 32³ trajectories of `examples/optimize_3d.py` to pin
        down. The constant Legendre coefficient of μ is exactly
        unidentifiable regardless, since CH only sees ∇μ.)
        """),
        code("""
        res = model.train(
            {"ys": list(sol), "ts": list(ts)}, [[0, 1, 2, 3, 4]],
            opt_parameters={"D": p.DiffusionLegendrePolynomials(jnp.zeros(2))},
            other_parameters={"kappa": 0.002, "mu": mu, "derivs": "fd"},
            solver_parameters={"A": 0.5},
            weights={"D": None}, lambda_reg=0.0,
            method="least_squares", max_steps=40, dt0=2.5e-4,
        )
        D_fit = np.asarray(res["D"].expansion.params)
        print("D coeffs:", np.round(D_fit, 4), "true [0.3, 0.2]")
        assert np.allclose(D_fit, [0.3, 0.2], atol=0.05)
        """),
        md("""
        ## The general-mobility fast path

        Concentration-dependent mobility D(c) ≠ 1 rules out every
        unit-mobility fused kernel, but not the cas transforms:
        `FusedMobilitySpectral` runs the conservative face-flux rhs as
        XLA-fused rolls and the stabilized implicit solve as cas matmuls
        (`bench.py ch3d_mobility` times it against the XLA-rfft stepper).
        Gradients flow natively (pass `--fused` to
        `examples/optimize_3d.py` for the full workload).

        **Stabilization with non-unit mobility.** Both semi-implicit
        steppers damp the stiff κ∇⁴ term with a *unit-mobility* implicit
        shift, so when max D(c) exceeds ≈ A·(shift strength), high-k
        modes amplify — dt-independently. This Legendre D reaches
        e^0.5 ≈ 1.65: the rfft path at the reference's default A=0.5 goes
        NaN at dt = 5·10⁻⁵ on this very workload, while A=1.0 is stable,
        and `FusedMobilitySpectral` exposes `stab_scale` (set it ≈ max D)
        to over-relax the FD-symbol shift the same way.
        """),
        code("""
        from pde_opt_jax.ops.steppers import FusedMobilitySpectral

        sol_ref = model.solve(
            {"kappa": 0.002, "mu": mu, "D": true_D, "derivs": "fd"},
            y0, ts, {"A": 1.0}, dt0=5e-5)
        fast = p.PDEModel(CahnHilliard3DPeriodic, domain,
                          FusedMobilitySpectral)
        sol_fast = fast.solve(
            {"kappa": 0.002, "mu": mu, "D": true_D, "derivs": "fd"},
            y0, ts, {"A": 1.0, "stab_scale": 2.0,
                     "mats_dtype": jnp.float64}, dt0=5e-5)
        err_traj = float(jnp.max(jnp.abs(sol_fast - sol_ref)))
        err_final = float(jnp.max(jnp.abs(sol_fast[-1] - sol_ref[-1])))
        print(f"|fused - rfft|: trajectory max {err_traj:.2e}, "
              f"final save {err_final:.2e}")
        # FD vs continuous symbol: an O(dt·Δsymbol) transient on the early
        # saves that the dynamics damp away; the endpoint agrees tightly.
        assert err_final < 1e-5
        """),
    ]


# ---------------------------------------------------------------------------
# 13 — RL environments
# ---------------------------------------------------------------------------

@notebook("13_rl_environments")
def _nb13():
    return [
        md("""
        # PDE control as an RL environment

        Two APIs over the same jitted core:

        * `VectorPDEEnv` — the native batched env: `reset`/`step` are pure
          jitted functions over an `EnvState` pytree with a leading env
          axis; `rollout` fuses whole episodes (physics + reward +
          auto-reset) into one on-device scan.
        * `PDEEnv` (`gym.make("PDEEnv-v0", ...)` once
          `pde_opt_jax.envs.gym_adapter` is imported) — a Gymnasium adapter with
          the reference's exact constructor, for SB3-style host loops.

        The reference env rebuilt the equation + solver and re-entered
        diffrax *every step* (`pde_env.py:281-303`); here a new control
        value is just a traced argument — nothing retraces.
        """),
        code(SETUP),
        code("""
        from pde_opt_jax.envs import make_cahn_hilliard_control_env

        env = make_cahn_hilliard_control_env(num_envs=32, grid_size=32,
                                             substeps=5)
        state, obs = env.reset(jax.random.PRNGKey(0))
        print("obs:", obs.shape, obs.dtype)           # (32, 1, 32, 32) uint8

        actions = jnp.zeros((32, 1))
        state, obs, reward, term, trunc, info = env.step(state, actions)
        print("reward:", reward.shape, float(reward.mean()))
        """),
        code("""
        # Whole-episode rollout: ONE compiled scan, zero host round-trips.
        def random_policy(obs, key):
            return jax.random.uniform(key, (32, 1), minval=-1.0, maxval=1.0)

        state, rewards, terms = env.rollout(state, random_policy, 50,
                                            key=jax.random.PRNGKey(1))
        plt.plot(np.asarray(rewards).mean(axis=-1))
        plt.xlabel("env step"); plt.ylabel("mean reward")
        plt.title("random policy on the CH control fleet")
        assert rewards.shape == (50, 32)
        """),
        md("""
        ## Divergence guards

        Fleets auto-reset finished episodes in lockstep, and per-env NaN /
        divergence masks re-seed any env whose physics blows up (the env
        analog of elastic recovery) — see `tests/test_env.py`.

        ## The Gymnasium adapter

        For host-side code (SB3, gym wrappers) the reference constructor
        works verbatim:
        """),
        code("""
        import gymnasium as gym
        import pde_opt_jax.envs.gym_adapter  # registers "PDEEnv-v0"

        N = 16
        L = 0.01 * N
        domain = p.Domain((N, N), ((-L / 2, L / 2), (-L / 2, L / 2)))
        genv = gym.make(
            "PDEEnv-v0",
            equation_type=p.CahnHilliard2DPeriodic,
            domain=domain,
            solver_type=p.SemiImplicitFourierSpectral,
            end_time=0.03, step_dt=0.01, numeric_dt=0.001,
            state_to_observation_func=lambda y: np.clip(
                np.asarray(y) * 255, 0, 255).astype(np.uint8)[None],
            reward_function=lambda y: float(-jnp.var(y)),
            reset_func=lambda domain, seed=0: jnp.clip(
                0.5 + 0.01 * jax.random.normal(jax.random.PRNGKey(seed),
                                               domain.points), 0.0, 1.0),
            reset_control_value=0.002,
            update_control_value=lambda off, old: float(
                np.clip(old + 0.0005 * np.asarray(off)[0], 1e-4, 0.01)),
            update_control_parameter=lambda old, new: new,
            action_space_config={"type": "continuous", "shape": (1,)},
            static_equation_parameters={"mu": lambda c: c**3 - c,
                                        "D": lambda c: jnp.ones_like(c),
                                        "derivs": "fd"},
            control_equation_parameter_name="kappa",
            solver_parameters={"A": 0.5},
        )
        obs, info = genv.reset(seed=0)
        obs, r, done, trunc, info = genv.step(genv.action_space.sample())
        print("gym obs", obs.shape, "| reward", r)
        """),
        md("""
        `AdvectionDiffusion-v0` (the reference notebooks' ghost env, with
        `reset_func` / `diffusion_coefficient` / `max_control_step` /
        `discrete_action_space` kwargs) is registered too — see
        `docs/environments.md`.
        """),
    ]


# ---------------------------------------------------------------------------
# 14 — PPO
# ---------------------------------------------------------------------------

@notebook("14_rl_ppo")
def _nb14():
    return [
        md("""
        # Training a policy: co-located PPO

        The reference trains stable-baselines3 PPO against its gym env on
        the host (`notebooks/test_pde_RL.ipynb`). Here the learner is
        *co-located*: rollout (physics included), GAE, minibatched
        clipped-surrogate epochs, and the optimizer all compile into ONE
        jitted train step over the batched env — the host only reads back
        scalar metrics. DQN and DDPG learners live in `pde_opt_jax.rl` too.
        """),
        code(SETUP),
        code("""
        from pde_opt_jax.envs import make_cahn_hilliard_control_env
        from pde_opt_jax.rl import ActorCriticConv, PPOConfig, ppo_train

        env = make_cahn_hilliard_control_env(num_envs=16, grid_size=16,
                                             substeps=2)
        net = ActorCriticConv(action_dim=1, channels=(8, 8), features=32,
                              key=jax.random.PRNGKey(0))
        cfg = PPOConfig(rollout_steps=8, epochs=2, minibatches=2, lr=3e-4)

        history = []
        params, _ = ppo_train(env, net, cfg, num_updates=6,
                              key=jax.random.PRNGKey(1),
                              log_fn=lambda u, m: history.append(
                                  (u, float(m["reward_mean"]), float(m["loss"]))))
        for u, r, l in history:
            print(f"update {u}: reward {r:+.4f}  loss {l:+.4f}")
        assert np.isfinite([h[2] for h in history]).all()
        """),
        code("""
        hs = np.array(history)
        fig, ax1 = plt.subplots(figsize=(7, 4))
        ax1.plot(hs[:, 0], hs[:, 1], "o-", color="tab:blue")
        ax1.set_xlabel("update"); ax1.set_ylabel("mean reward", color="tab:blue")
        ax2 = ax1.twinx()
        ax2.plot(hs[:, 0], hs[:, 2], "s--", color="tab:red")
        ax2.set_ylabel("PPO loss", color="tab:red")
        plt.title("PPO on the Cahn-Hilliard control fleet (smoke size)")
        """),
        md("""
        ## Pathwise gradients through the physics

        The fused env kernels carry custom VJPs, so `jax.grad` flows
        *through the PDE*: you can train a policy by direct analytic
        gradient of the reward instead of (or alongside) the score function
        — see `examples/rl_train_reinforce.py` and
        `tests/test_fused_grad.py` (`bench.py`'s `train_grad` config times
        it at fleet scale).

        Scaling up: pass `mesh=make_mesh()` to `ppo_train` for data-parallel
        learners over a device mesh (next notebook).
        """),
    ]


# ---------------------------------------------------------------------------
# 15 — sharding + checkpoint
# ---------------------------------------------------------------------------

@notebook("15_fleets_sharding_checkpoint")
def _nb15():
    return [
        md("""
        # Fleets at scale: device meshes, sharding, checkpoints

        The scaling axis for PDE control is the **env batch**: thousands of
        lockstep envs shard over a 1D `("env",)` mesh (pure data parallelism
        over ICI/DCN); the learner is co-located and `psum`s gradients.
        Spatial decomposition of a single huge grid (halo exchange +
        transpose FFT — the PDE analog of sequence parallelism) lives in
        `pde_opt_jax.parallel.halo`.

        This notebook runs on virtual CPU devices; the same code runs
        unchanged on several GPUs (and hosts, after
        `init_distributed(...)`).
        """),
        code("""
        import os, sys
        sys.path.insert(0, os.path.abspath(os.path.join(os.getcwd(), "..", "..")))
        # 8 virtual devices when no real mesh is present (set BEFORE jax init).
        flags = os.environ.get("XLA_FLAGS", "")
        if "host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (flags +
                " --xla_force_host_platform_device_count=8").strip()

        import jax
        import jax.numpy as jnp
        import numpy as np
        import matplotlib.pyplot as plt

        import pde_opt_jax as p
        print("devices:", len(jax.devices()))
        """),
        code("""
        from pde_opt_jax.envs import make_cahn_hilliard_control_env
        from pde_opt_jax.parallel import ShardedVectorPDEEnv, make_mesh

        n_dev = len(jax.devices())
        env = make_cahn_hilliard_control_env(num_envs=4 * n_dev, grid_size=16,
                                             substeps=2)
        mesh = make_mesh()                       # all devices on one "env" axis
        senv = ShardedVectorPDEEnv(env, mesh)

        policy = lambda obs, key: jnp.zeros((4 * n_dev, 1))
        state_s, obs = senv.reset(jax.random.PRNGKey(0))
        state_s, rewards_s, terms = senv.rollout(state_s, policy, 10,
                                                 key=jax.random.PRNGKey(42))
        print("rewards:", rewards_s.shape,
              "finite:", bool(jnp.isfinite(rewards_s).all()))
        """),
        md("""
        Each device owns `num_envs / n_devices` environments; env state
        never leaves its shard. Determinism across the mesh boundary — the
        sharded fleet reproduces the local fleet per-env:
        """),
        code("""
        state_l, _ = env.reset(jax.random.PRNGKey(0))
        _, rewards_l, _ = env.rollout(state_l, policy, 10,
                                      key=jax.random.PRNGKey(42))
        print("max |sharded - local| =",
              float(jnp.abs(rewards_l - rewards_s).max()))
        """),
        md("""
        `tests/test_sharding.py` gates this; `tests/test_distributed.py`
        exercises the real two-process `jax.distributed` entry path, and
        `docs/parallelism.md` carries the 1→N-host scaling model.

        ## Checkpoint / resume

        Orbax underneath; any pytree (policy params, optimizer state,
        env-fleet state, PRNG keys) round-trips — the multi-host resume
        story:
        """),
        code("""
        import tempfile
        from pde_opt_jax.utils.checkpoint import save_checkpoint, restore_checkpoint

        with tempfile.TemporaryDirectory() as d:
            save_checkpoint(d, step=10, tree={"env_y": state_s.y,
                                              "note": jnp.arange(3)})
            back = restore_checkpoint(d)          # latest step
            np.testing.assert_allclose(np.asarray(back["env_y"]),
                                       np.asarray(state_s.y))
        print("checkpoint roundtrip OK")
        """),
        md("""
        ## Where to go next

        * `docs/parallelism.md` — the mesh layout, the halo/transpose-FFT
          spatial decomposition, and the 1→N-host scaling model.
        * `PERF.md` — what has been measured on the H100, and the findings.
        * `examples/` — script versions of every workload in this series.
        """),
    ]


# ---------------------------------------------------------------------------
# 16 — spatial decomposition
# ---------------------------------------------------------------------------

@notebook("16_spatial_decomposition")
def _nb16():
    return [
        md("""
        # Spatial decomposition: halo exchange and the distributed FFT

        The PDE analog of sequence/context parallelism: when one instance's
        grid exceeds a chip, shard the grid's **rows** across a named mesh
        axis. Finite-difference stencils then need one ring `ppermute`
        halo exchange per evaluation; pseudo-spectral operators need a
        distributed FFT — local FFT → `all_to_all` transpose → local FFT,
        the natural shape of a 2D FFT across devices.

        Everything here runs inside `shard_map`; this notebook uses 8
        virtual CPU devices (same code on a real mesh). The reference has
        no multi-device support of any kind (SURVEY §2.3).
        """),
        code("""
        import os, sys
        sys.path.insert(0, os.path.abspath(os.path.join(os.getcwd(), "..", "..")))
        flags = os.environ.get("XLA_FLAGS", "")
        if "host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (flags +
                " --xla_force_host_platform_device_count=8").strip()

        import jax
        import jax.numpy as jnp
        import numpy as np
        import matplotlib.pyplot as plt
        from jax.sharding import PartitionSpec as P

        from pde_opt_jax.parallel.mesh import make_mesh, shard_map
        n_dev = len(jax.devices())
        mesh = make_mesh(axis_names=("space",))
        print("devices:", n_dev)
        """),
        md("""
        ## Halo-exchange stencils

        `sharded_lap_2nd_2d` pads one halo row per side with a ring
        `ppermute`, then applies the same arithmetic as the single-device
        stencil — the results agree exactly:
        """),
        code("""
        from pde_opt_jax.ops.stencils import lap_2nd_2d
        from pde_opt_jax.parallel.halo import sharded_lap_2nd_2d

        N = 64
        u = jax.random.normal(jax.random.PRNGKey(0), (N, N))
        lap_sharded = jax.jit(shard_map(
            lambda ul: sharded_lap_2nd_2d(ul, 0.1, 0.1, "space"),
            mesh=mesh, in_specs=P("space"), out_specs=P("space"),
        ))(u)
        lap_global = lap_2nd_2d(u, 0.1, 0.1)
        err = float(jnp.abs(lap_sharded - lap_global).max())
        scale = float(jnp.abs(lap_global).max())
        print(f"max |sharded - global| = {err:.2e} (field scale {scale:.1f})")
        assert err < 1e-5 * scale    # f32 summation-order noise only
        """),
        md("""
        ## The all-to-all distributed FFT

        Row-sharded input `(N/P, M)` → FFT along the unsharded axis →
        `all_to_all` global transpose → FFT along the other axis. The
        output lands **column-sharded**, which is exactly the layout you
        want for applying spectral multipliers locally:
        """),
        code("""
        from pde_opt_jax.parallel.halo import distributed_fft2, distributed_ifft2

        f = jax.random.normal(jax.random.PRNGKey(1), (N, N))
        fhat = jax.jit(shard_map(
            lambda ul: distributed_fft2(ul.astype(jnp.complex64), "space"),
            mesh=mesh, in_specs=P("space"), out_specs=P(None, "space"),
        ))(f)
        err = float(jnp.abs(fhat - jnp.fft.fft2(f)).max())
        print(f"max |distributed - jnp.fft.fft2| = {err:.2e}")
        assert err < 1e-3 * float(jnp.abs(fhat).max())
        """),
        md("""
        ## A spatially-sharded Cahn-Hilliard solve

        `make_sharded_sif_ch_macro` is the spatial-decomposition
        counterpart of the fused single-chip kernel: the same semi-implicit
        substep evaluated with the distributed FFT, spectral multipliers
        sliced per shard in the transposed layout. One 256² instance
        spreads across all 8 devices and matches the single-device run:
        """),
        code("""
        from pde_opt_jax.parallel.halo import make_sharded_sif_ch_macro
        from pde_opt_jax.ops.spectral_reference import ch_sif_macro_reference

        N = 256
        mu = lambda c: c**3 - c
        u0 = 0.5 + 0.05 * jax.random.normal(jax.random.PRNGKey(2), (N, N))
        macro = make_sharded_sif_ch_macro(mu, N, N, 0.01, 0.01,
                                          A=1.0, dt=1e-5, n_steps=20)
        u1 = jax.jit(shard_map(
            lambda ul: macro(ul, 0.004),
            mesh=mesh, in_specs=P("space"), out_specs=P("space"),
        ))(u0)
        ref = ch_sif_macro_reference(mu, 0.01, 0.01, 1.0, 1e-5, 20)
        u1_ref = jax.jit(lambda u: ref(u[None], jnp.array([0.004]))[0])(u0)
        err = float(jnp.abs(u1 - u1_ref).max())
        print(f"sharded vs single-device max |err| = {err:.2e}")
        assert err < 1e-4

        fig, axes = plt.subplots(1, 2, figsize=(9, 4))
        axes[0].imshow(np.asarray(u0), cmap="RdBu"); axes[0].set_title("t = 0")
        axes[1].imshow(np.asarray(u1), cmap="RdBu")
        axes[1].set_title("after 20 substeps, sharded over 8 devices")
        for ax in axes: ax.axis("off")
        plt.tight_layout()
        """),
        md("""
        When to use which scaling axis: for the benchmark-class 64²–128²
        control problems, the env **batch** is the scaling axis (pure data
        parallelism, notebook 15 — zero cross-device traffic in the
        rollout). Spatial decomposition is for single instances that
        outgrow a chip (512²+, 3D); its all_to_all/ppermute traffic rides
        ICI. `docs/parallelism.md` carries the full scaling model.
        """),
    ]


@notebook("17_rotating_bec_vortices")
def _nb17():
    return [
        md("""
        # Rotating BEC: vortex nucleation and the stirring control fleet

        The reference defines the rotating-frame GPE (`GPE2DTSRot`, adding
        −Ω·L_z to the Hamiltonian) but ships no solver able to integrate
        its per-direction mixed-basis split. This framework completes the
        capability twice over:

        * `DirectionalSplitting` — the FFT ADI split-step (Bao & Cai);
        * `FusedRotatingSplitting` — the matmul path: each directional
          sweep is a precomputed per-grid-line dense propagator applied as
          one batched contraction, with adjacent Strang half-sweeps merged
          across the segment.

        On top sits the sixth RL env family:
        `make_gpe_rot_control_env`, where the agent drives a co-rotating
        stirring beam and is rewarded for nucleating vortices
        (plaquette-winding census + ⟨L_z⟩ shaping).
        """),
        code(SETUP),
        code("""
        from pde_opt_jax.ops.steppers import (DirectionalSplitting,
                                              FusedRotatingSplitting)
        from pde_opt_jax.utils import density, initialize_Psi
        from pde_opt_jax.utils.rl import detect_vortices

        N, L = 32, 16.0
        domain = p.Domain((N, N), ((-L / 2, L / 2), (-L / 2, L / 2)))
        eq = p.GPE2DTSRot(domain, 200.0, 0.0, omega=0.6)
        psi0 = initialize_Psi(N, width=10, vortexnumber=1).astype(jnp.complex64)
        psi0 = psi0 / jnp.sqrt(jnp.sum(density(psi0)) * domain.dx[0] ** 2)

        # Imaginary-time relaxation toward the rotating ground state on
        # BOTH solver paths — they agree to float32 roundoff.
        fft_step = DirectionalSplitting(eq.A_terms, eq.B_terms,
                                        domain.dx[0], time_scale=-1j)
        psi_fft = p.evolve(fft_step, lambda y, t: y, psi0, 0.0, 1e-3, 200)
        fused = FusedRotatingSplitting(eq.A_terms, eq.B_terms,
                                       domain.dx[0], time_scale=-1j)
        psi_fast = fused.evolve(None, psi0, 0.0, 1e-3, 200)
        print("max |density diff|:",
              float(jnp.max(jnp.abs(density(psi_fast) - density(psi_fft)))))
        """),
        code("""
        census = detect_vortices(
            psi_fast / jnp.sqrt(jnp.max(density(psi_fast))), amp_thresh=0.05)
        print("vortices:", census["num_vortices"],
              "| total charge:", census["total_topological_charge"])

        fig, axes = plt.subplots(1, 2, figsize=(9, 4))
        axes[0].imshow(np.asarray(density(psi_fast)))
        axes[0].set_title("density"); axes[0].axis("off")
        axes[1].imshow(np.asarray(jnp.angle(psi_fast)), cmap="twilight")
        for y, x in census["positions"]:
            axes[1].plot(x, y, "wo", ms=8, mfc="none")
        axes[1].set_title("phase + detected vortices"); axes[1].axis("off")
        plt.tight_layout()
        """),
        md("""
        ## The stirring control fleet

        `make_gpe_rot_control_env` wraps the rotating frame in the batched
        env: the control is the per-env intensity of an off-center
        Gaussian beam (static in the rotating frame ⇒ a co-rotating
        stirrer). Stirring hard beats not stirring; PPO learns this from
        scratch in `tests/test_gpe_rot_env.py`.
        """),
        code("""
        from pde_opt_jax.envs import make_gpe_rot_control_env

        env = make_gpe_rot_control_env(num_envs=8, grid_size=32,
                                       substeps=4, end_time=0.32,
                                       step_dt=0.04, action_gain=2.5)
        state, obs = env.reset(jax.random.PRNGKey(0))

        def ep_return(policy):
            s, _ = env.reset(jax.random.PRNGKey(5))
            _, rewards, _ = env.rollout(s, policy, 8,
                                        key=jax.random.PRNGKey(6))
            return float(rewards.sum(axis=0).mean())

        stir = ep_return(lambda o, k: jnp.ones((8, 1)))
        idle = ep_return(lambda o, k: -jnp.ones((8, 1)))
        print(f"episode return: stirring {stir:+.3f} vs idle {idle:+.3f}")
        assert stir > idle
        """),
    ]


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------

def build(name: str) -> nbf.NotebookNode:
    nb = nbf.v4.new_notebook()
    nb.cells = NOTEBOOKS[name]()
    nb.metadata["kernelspec"] = {
        "display_name": "Python 3", "language": "python", "name": "python3",
    }
    nb.metadata["language_info"] = {"name": "python"}
    return nb


CPU_SETUP = (
    "import os\n"
    "os.environ.setdefault('JAX_PLATFORMS', 'cpu')\n"
    "import jax\n"
    "jax.config.update('jax_platforms', 'cpu')\n"
)


def execute(nb: nbf.NotebookNode, cwd: str, timeout: int = 900):
    """Execute with a CPU-forcing cell prepended (stripped after)."""
    from nbclient import NotebookClient

    nb.cells.insert(0, nbf.v4.new_code_cell(CPU_SETUP))
    client = NotebookClient(nb, timeout=timeout, kernel_name="python3",
                            resources={"metadata": {"path": cwd}})
    client.execute()
    nb.cells.pop(0)
    return nb


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--execute", action="store_true",
                    help="execute each notebook and save with outputs")
    ap.add_argument("--only", type=str, default=None,
                    help="comma-separated notebook names")
    args = ap.parse_args()

    os.makedirs(OUT_DIR, exist_ok=True)
    names = sorted(NOTEBOOKS)
    if args.only:
        names = [n for n in names if n in set(args.only.split(","))]
    for name in names:
        nb = build(name)
        if args.execute:
            print(f"executing {name} ...", flush=True)
            execute(nb, OUT_DIR)
        path = os.path.join(OUT_DIR, f"{name}.ipynb")
        with open(path, "w") as f:
            nbf.write(nb, f)
        print("wrote", path)


if __name__ == "__main__":
    main()
