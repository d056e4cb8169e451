"""Single-step time integrators (the replacement for diffrax solvers).

The reference delegates every time loop to ``diffrax.diffeqsolve`` with either
stock solvers (Tsit5, ImplicitEuler) or two custom ``dfx.AbstractSolver``s
(``/root/reference/pde_opt/numerics/solvers.py:23-125``).  Here each solver is
a plain object exposing

    ``step(rhs, y, t, dt) -> (y1, y_err)``

with ``y_err`` an embedded error estimate (or ``None``).  Steppers contain no
Python control flow over traced values, so a step inlines into ``lax.scan`` /
``lax.while_loop`` loops (:mod:`pde_opt_jax.ops.integrate`) and compiles to a
single fused XLA region — including over a leading env-batch axis.

The solver↔equation wiring contract is preserved: steppers declare
``required_equation_attrs`` and :func:`pde_opt_jax.utils.compat.prepare_solver_params`
auto-fills them from an equation (reference ``utils.py:34-53``).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp

__all__ = [
    "Euler",
    "Heun",
    "RK4",
    "Tsit5",
    "SemiImplicitFourierSpectral",
    "SemiImplicitDenseSolve",
    "FusedSemiImplicitSpectral",
    "FusedSemiImplicitSpectral3D",
    "FusedMobilitySpectral",
    "StrangSplitting",
    "DirectionalSplitting",
    "FusedRotatingSplitting",
    "ImplicitEuler",
]

Array = jax.Array


def _normalize_per_env_control(ctrl, batch_shape, name: str = "control"):
    """Canonicalize a per-env scalar control to ``batch_shape``.

    Fused steppers receive their per-env scalar control (kappa, C-rate, ...)
    from the env layer, where it naturally appears in several shapes: scalar
    (shared), ``batch_shape`` itself (e.g. ``(B,)``), or ``batch_shape`` plus
    trailing singleton broadcast axes (``(B, 1)``, ``(B, 1, 1)`` — the output
    of ``update_control_value`` / ``update_control_parameter``).  All are
    accepted; anything else (a trailing non-singleton axis that is not part
    of the batch) is an error rather than a silent mis-broadcast.
    """
    ctrl = jnp.asarray(ctrl)
    while ctrl.ndim > len(batch_shape):
        if ctrl.shape[-1] != 1:
            raise ValueError(
                f"{name} shape {ctrl.shape} does not broadcast to the env "
                f"batch {tuple(batch_shape)}: expected scalar, "
                f"{tuple(batch_shape)}, or {tuple(batch_shape)} plus "
                "trailing singleton axes"
            )
        ctrl = ctrl[..., 0]
    return jnp.broadcast_to(ctrl, batch_shape)


class AbstractStepper:
    """Base class: one explicit/implicit time step with optional error estimate."""

    required_equation_attrs: Tuple[str, ...] = ()
    order: int = 1

    def step(self, rhs: Callable, y: Array, t, dt) -> Tuple[Array, Optional[Array]]:
        raise NotImplementedError

    # Steppers are static configuration for jit purposes.
    def __hash__(self):
        return hash((type(self),))

    def __eq__(self, other):
        return type(self) is type(other)


class Euler(AbstractStepper):
    """Explicit (forward) Euler, 1st order."""

    order = 1

    def step(self, rhs, y, t, dt):
        return y + dt * rhs(y, t), None


class Heun(AbstractStepper):
    """Heun's method (explicit trapezoidal), 2nd order with embedded Euler error."""

    order = 2

    def step(self, rhs, y, t, dt):
        k1 = rhs(y, t)
        y_euler = y + dt * k1
        k2 = rhs(y_euler, t + dt)
        y1 = y + 0.5 * dt * (k1 + k2)
        return y1, y1 - y_euler


class RK4(AbstractStepper):
    """Classic 4th-order Runge-Kutta (no error estimate)."""

    order = 4

    def step(self, rhs, y, t, dt):
        k1 = rhs(y, t)
        k2 = rhs(y + 0.5 * dt * k1, t + 0.5 * dt)
        k3 = rhs(y + 0.5 * dt * k2, t + 0.5 * dt)
        k4 = rhs(y + dt * k3, t + dt)
        return y + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4), None


# Tsitouras 5(4) coefficients (Tsitouras, Comput. Math. Appl. 62 (2011)).
# Same tableau diffrax's Tsit5 uses — the reference integrates Allen-Cahn and
# the Shape-smoothing flow with it (test_solvers.py:81, shapes.py:69).
_TSIT5_C = (0.161, 0.327, 0.9, 0.9800255409045097, 1.0, 1.0)
_TSIT5_A = (
    (0.161,),
    (-0.008480655492356989, 0.335480655492357),
    (2.8971530571054935, -6.359448489975075, 4.3622954328695815),
    (5.325864828439257, -11.748883564062828, 7.4955393428898365, -0.09249506636175525),
    (5.86145544294642, -12.92096931784711, 8.159367898576159, -0.071584973281401, -0.028269050394068383),
    (0.09646076681806523, 0.01, 0.4798896504144996, 1.379008574103742, -3.290069515436081, 2.324710524099774),
)
# 5th-order weights are the last A row (FSAL); error weights b - bhat:
_TSIT5_BTILDE = (
    -0.00178001105222577714,
    -0.0008164344596567469,
    0.007880878010261995,
    -0.1447110071732629,
    0.5823571654525552,
    -0.45808210592918697,
    0.015151515151515152,
)


class Tsit5(AbstractStepper):
    """Tsitouras 5(4) explicit Runge-Kutta with embedded 4th-order error."""

    order = 5

    def step(self, rhs, y, t, dt):
        k = [rhs(y, t)]
        for ci, ai in zip(_TSIT5_C, _TSIT5_A):
            yi = y
            for aij, kj in zip(ai, k):
                yi = yi + dt * aij * kj
            k.append(rhs(yi, t + ci * dt))
        # 5th-order solution: y + dt * sum(a7j k_j) (already accumulated as
        # the stage-7 argument), recompute explicitly for clarity:
        y1 = y
        for aij, kj in zip(_TSIT5_A[-1], k):
            y1 = y1 + dt * aij * kj
        y_err = jax.tree_util.tree_reduce(
            lambda a, b: a + b,
            [dt * bt * kj for bt, kj in zip(_TSIT5_BTILDE, k)],
        )
        return y1, y_err


class SemiImplicitFourierSpectral(AbstractStepper):
    """Semi-implicit Fourier-spectral step for stiff phase-field equations.

    Step semantics follow the reference solver exactly
    (``/root/reference/pde_opt/numerics/solvers.py:56-70``) so fixed-seed
    trajectories match at matched grid/dt/dtype:

        ``y1 = y0 + dt * Re ifft( fft(rhs(y0,t)) / (1 + A*dt*symbol) )``

    with error estimate vs an explicit Euler step.  ``fft``/``ifft`` must
    transform the trailing spatial axes only (equations built here guarantee
    that), which makes the step batch-transparent: one batched FFT per
    stage for an entire env fleet.

    Reference: Zhu et al., PRE 60.4 (1999) 3564.
    """

    required_equation_attrs = ("fourier_symbol", "fft", "ifft")
    order = 1

    def __init__(self, A: float, fourier_symbol, fft, ifft):
        self.A = A
        self.fourier_symbol = fourier_symbol
        self.fft = fft
        self.ifft = ifft

    def step(self, rhs, y, t, dt):
        f0 = rhs(y, t)
        denom = 1.0 + self.A * dt * self.fourier_symbol
        y1 = y + dt * self.ifft(self.fft(f0) / denom).real
        euler_y1 = y + dt * f0
        return y1, y1 - euler_y1

    def __hash__(self):
        return hash((type(self), float(jnp.real(jnp.asarray(self.A)))))

    def __eq__(self, other):
        return type(self) is type(other) and self.A == other.A


class SemiImplicitDenseSolve(AbstractStepper):
    """Semi-implicit step with the spectral solve as ONE dense matmul.

    Same family as :class:`SemiImplicitFourierSpectral` but the implicit
    high-order damping uses a *fixed* reference symbol σ(k) (e.g. κ_max(2πik)⁴
    for a control env whose κ ≤ κ_max):

        ``y1 = y0 + dt · Re ifft2( fft2(f0) / (1 + A·dt·σ) )``

    For fixed σ and dt the whole solve is a real linear operator on the
    field, precomputed host-side as an (HW, HW) matrix and applied as a
    single ``(B, HW) @ (HW, HW)`` matmul (bf16 operands, f32
    accumulation, ~3e-3 relative error on the increment).  Any A·dt·σ
    upper-bounding the true stiffness keeps the stabilization property, so a
    per-env κ control works with one shared matrix.

    Notes: ``dt`` must be trace-time concrete (fixed-dt env loops are);
    matrices are cached per dt.
    """

    required_equation_attrs = ()
    order = 1

    def __init__(self, A, dense_symbol, points, dtype: str = "bf16_sqrt"):
        """Args:
            A: splitting constant (as in the reference stepper).
            dense_symbol: full-spectrum numpy symbol σ(k), shape ``points``.
            points: grid shape (H, W).
            dtype: "bf16_sqrt" (default; sqrt-factored two-stage bf16 —
                fast AND stable in stiff loops), "bf16" (flat, fastest,
                unstable feedback), or "f32" (exact, slow).
        """
        import numpy as _np

        self.A = A
        self.dense_symbol = _np.asarray(dense_symbol)
        self.points = tuple(points)
        self.dtype = dtype
        self._cache = {}

    def _solve_for_dt(self, dt: float):
        key = float(dt)
        if key not in self._cache:
            import numpy as _np

            from .dft import make_dense_spectral_solve

            denom = 1.0 / (1.0 + float(self.A) * key * self.dense_symbol)
            self._cache[key] = make_dense_spectral_solve(
                self.points, _np.real(denom), dtype=self.dtype
            )
        return self._cache[key]

    def step(self, rhs, y, t, dt):
        if isinstance(dt, jax.core.Tracer):
            raise TypeError(
                "SemiImplicitDenseSolve requires a trace-time concrete dt "
                "(fixed-step loops); use SemiImplicitFourierSpectral for "
                "adaptive dt."
            )
        solve = self._solve_for_dt(float(dt))
        f0 = rhs(y, t)
        y1 = y + dt * solve(f0)
        return y1, y1 - (y + dt * f0)

    def __hash__(self):
        return hash((type(self), float(self.A), self.points, self.dtype))

    def __eq__(self, other):
        return (
            type(self) is type(other)
            and self.A == other.A
            and self.points == other.points
            and self.dtype == other.dtype
            and (self.dense_symbol == other.dense_symbol).all()
        )


class FusedSemiImplicitSpectral(AbstractStepper):
    """Whole-macro-step Cahn-Hilliard stepper on the cas kernel.

    Runs *all* substeps of an :func:`pde_opt_jax.ops.integrate.evolve` call
    inside one Pallas kernel (:mod:`pde_opt_jax.ops.cas_spectral`): the
    field and its spectrum stay on chip, the transforms are bf16 matmuls
    with f32 accumulation, and the semi-implicit solve uses the env's own
    per-env ``kappa`` in the denominator.

    Contract: the equation must be Cahn-Hilliard-like with elementwise
    ``mu`` and **unit mobility** (``D == 1``) — the preset envs that select
    this stepper guarantee it, and construction probes ``D`` when it can.
    Batched (``vectorized_control``) paths only.

    Differentiable: the kernel's custom VJP runs the backward pass through
    the XLA oracle, so ``jax.grad`` flows through ``evolve`` w.r.t. both
    the field and the per-env ``kappa`` control.
    """

    required_equation_attrs = ("kappa", "mu", "D", "domain")
    order = 1

    def __init__(self, kappa, mu, D, domain, A: float = 1.0, mats_dtype=None):
        self.kappa = kappa
        self.mu = mu
        self.domain = domain
        self.A = float(A)
        self.mats_dtype = mats_dtype
        # Best-effort D == 1 probe (host-side, concrete; skipped if D closes
        # over traced values).
        try:
            probe = D(jnp.linspace(0.1, 0.9, 4))
            import numpy as _np

            if not _np.allclose(_np.asarray(probe), 1.0):
                raise ValueError(
                    "FusedSemiImplicitSpectral requires unit mobility "
                    "(D == 1); use SemiImplicitFourierSpectral otherwise."
                )
        except ValueError:
            raise
        except Exception:
            pass

    def _macro(self, dt, n_steps, epilogue=None):
        if isinstance(dt, jax.core.Tracer):
            raise TypeError(
                "FusedSemiImplicitSpectral requires trace-time concrete dt"
            )
        from .cas_spectral import make_ch_cas_fused_macro

        H, W = self.domain.points
        hx, hy = self.domain.dx
        kwargs = {}
        if self.mats_dtype is not None:
            kwargs["mats_dtype"] = self.mats_dtype
        return make_ch_cas_fused_macro(
            self.mu, H, W, float(hx), float(hy), self.A, float(dt),
            int(n_steps), epilogue=epilogue, **kwargs,
        )

    def evolve(self, rhs, y0, t0, dt, n_steps, unroll=1):
        """Advance ``n_steps`` substeps in one kernel (ignores ``rhs`` — the
        physics enters through ``mu``/``kappa``)."""
        del rhs, t0, unroll
        kappa = _normalize_per_env_control(self.kappa, y0.shape[:-2], "kappa")
        return self._macro(dt, n_steps)(y0, kappa)

    def evolve_with_epilogue(self, rhs, y0, t0, dt, n_steps, ep_cfg):
        """Advance ``n_steps`` substeps AND emit the env epilogue from the
        same kernel: ``(y1, stats, obs)`` per
        :func:`pde_opt_jax.ops.cas_spectral.make_ch_cas_fused_macro`.

        ``ep_cfg`` keys: ``obs_scale``, ``obs_offset``, ``obs_downsample``,
        ``stats_center`` (reference per-step obs/reward:
        ``pde_env.py:305-317``).
        """
        del rhs, t0
        kappa = _normalize_per_env_control(self.kappa, y0.shape[:-2], "kappa")
        epilogue = {
            "obs_scale": float(ep_cfg.get("obs_scale", 255.0)),
            "obs_offset": float(ep_cfg.get("obs_offset", 0.0)),
            "obs_downsample": int(ep_cfg.get("obs_downsample", 1)),
            "stats_center": float(ep_cfg.get("stats_center", 0.0)),
        }
        return self._macro(dt, n_steps, epilogue)(y0, kappa)

    def step(self, rhs, y, t, dt):
        y1 = self.evolve(rhs, y, t, dt, 1)
        return y1, None


class FusedSemiImplicitSpectral3D(AbstractStepper):
    """3D whole-segment semi-implicit CH stepper on cas-transform matmuls.

    XLA-einsum analog of :class:`FusedSemiImplicitSpectral` for rank-3
    domains (see :mod:`pde_opt_jax.ops.cas3d`): the spectrum is carried
    across substeps and each substep is 6 matmuls instead of ~7 FFT
    passes.  Unit mobility (``D == 1``), elementwise ``mu``; natively
    differentiable (plain XLA).
    """

    required_equation_attrs = ("kappa", "mu", "D", "domain")
    order = 1

    def __init__(self, kappa, mu, D, domain, A: float = 1.0,
                 mats_dtype=None):
        self.kappa = kappa
        self.mu = mu
        self.domain = domain
        self.A = float(A)
        self.mats_dtype = mats_dtype
        try:
            probe = D(jnp.linspace(0.1, 0.9, 4))
            import numpy as _np

            if not _np.allclose(_np.asarray(probe), 1.0):
                raise ValueError(
                    "FusedSemiImplicitSpectral3D requires unit mobility "
                    "(D == 1); use SemiImplicitFourierSpectral otherwise."
                )
        except ValueError:
            raise
        except Exception:
            pass

    def evolve(self, rhs, y0, t0, dt, n_steps, unroll=1):
        del rhs, t0, unroll
        if isinstance(dt, jax.core.Tracer):
            raise TypeError(
                "FusedSemiImplicitSpectral3D requires trace-time concrete dt"
            )
        from .cas3d import make_ch3d_cas_macro

        N1, N2, N3 = self.domain.points
        h1, h2, h3 = self.domain.dx
        kwargs = {}
        if self.mats_dtype is not None:
            kwargs["mats_dtype"] = self.mats_dtype
        macro = make_ch3d_cas_macro(
            self.mu, N1, N2, N3, float(h1), float(h2), float(h3),
            self.A, float(dt), int(n_steps), **kwargs,
        )
        kappa = _normalize_per_env_control(self.kappa, y0.shape[:-3], "kappa")
        return macro(y0, kappa)

    def step(self, rhs, y, t, dt):
        return self.evolve(rhs, y, t, dt, 1), None


class FusedMobilitySpectral(AbstractStepper):
    """Whole-segment semi-implicit CH stepper for GENERAL mobility D(c).

    The fast path for concentration-dependent mobility (the reference's 3D
    training workload: Legendre D and mu,
    ``/root/reference/docs/notebooks/optimization_3D.ipynb`` cell 4) —
    every other fused CH stepper here requires ``D == 1``.  Per substep the
    conservative face-flux rhs ``div(D_face·grad(mu − κ∇²u))`` is pure
    roll arithmetic and the stabilized implicit solve is ONE forward + ONE
    inverse cas transform as matmuls (4 in 2D, 6 in 3D; no FFTs) —
    see :mod:`pde_opt_jax.ops.cas_mobility`.  Rank is dispatched from the
    domain (2D and 3D).  Natively differentiable w.r.t. the field, per-env
    ``kappa``, and any learnable parameters inside ``mu``/``D``.

    ``stab_scale``: multiplies the implicit κλ² shift (set ≈ max D(c) when
    the mobility is large — the reference scheme stabilizes with the bare
    κλ² symbol, which assumes O(1) mobility).
    """

    required_equation_attrs = ("kappa", "mu", "D", "domain")
    order = 1

    def __init__(self, kappa, mu, D, domain, A: float = 1.0,
                 stab_scale: float = 1.0, mats_dtype=None):
        self.kappa = kappa
        self.mu = mu
        self.D = D
        self.domain = domain
        self.A = float(A)
        self.stab_scale = float(stab_scale)
        self.mats_dtype = mats_dtype

    def evolve(self, rhs, y0, t0, dt, n_steps, unroll=1):
        del rhs, t0, unroll
        if isinstance(dt, jax.core.Tracer):
            raise TypeError(
                "FusedMobilitySpectral requires trace-time concrete dt"
            )
        from . import cas_mobility as cm

        pts = tuple(self.domain.points)
        dxs = tuple(float(h) for h in self.domain.dx)
        kwargs = {"stab_scale": self.stab_scale}
        if self.mats_dtype is not None:
            kwargs["mats_dtype"] = self.mats_dtype
        if len(pts) == 2:
            macro = cm.make_ch_mobility_cas_macro(
                self.mu, self.D, *pts, *dxs, self.A, float(dt),
                int(n_steps), **kwargs,
            )
            ndim = 2
        elif len(pts) == 3:
            macro = cm.make_ch3d_mobility_cas_macro(
                self.mu, self.D, *pts, *dxs, self.A, float(dt),
                int(n_steps), **kwargs,
            )
            ndim = 3
        else:
            raise ValueError(
                f"FusedMobilitySpectral supports 2D/3D domains, got {pts}"
            )
        kappa = _normalize_per_env_control(
            self.kappa, y0.shape[:-ndim], "kappa")
        return macro(y0, kappa)

    def step(self, rhs, y, t, dt):
        return self.evolve(rhs, y, t, dt, 1), None


class StrangSplitting(AbstractStepper):
    """Strang split-step Fourier method for time-splitting equations (GPE).

    Reproduces the reference step operation-for-operation
    (``/root/reference/pde_opt/numerics/solvers.py:99-122``): half-step of the
    linear (Fourier-diagonal) ``A`` operator, full step of the pointwise ``B``
    operator, per-step L² renormalization, half-step of ``A`` again.  State is
    a real ``(..., 2)`` stack of (Re, Im) — matrix units have no complex
    datapath, so real-stacked storage with explicit complex arithmetic at the
    FFT boundary is the native layout.

    ``time_scale = -1j`` selects imaginary-time propagation (ground-state
    search); the renormalization then projects back onto the unit-norm
    manifold each step.

    Reference: Bao & Cai, arXiv:1212.5341.
    """

    required_equation_attrs = ("A_term", "dx", "fft", "ifft")
    order = 1

    def __init__(self, A_term, dx, fft, ifft, time_scale=1.0,
                 fast_evolve: bool = False):
        self.A_term = A_term
        self.dx = dx
        self.fft = fft
        self.ifft = ifft
        self.time_scale = time_scale
        # fast_evolve: multi-step rollouts merge the trailing/leading A
        # half-steps of consecutive substeps (see evolve()).
        self.fast_evolve = fast_evolve

    def step(self, rhs, y, t, dt):
        dt = dt * self.time_scale
        yc = y[..., 0] + 1j * y[..., 1]
        ndim_spatial = jnp.ndim(self.A_term)

        exp_A = jnp.exp(self.A_term * 0.5 * dt)
        tmp = self.ifft(self.fft(yc) * exp_A)
        b = rhs(y, t)  # B_terms, stacked (..., 2)
        tmp = tmp * jnp.exp((b[..., 0] + 1j * b[..., 1]) * dt)
        # L2 renormalization over the *spatial* axes only (batch-safe; the
        # reference sums over everything, identical for unbatched states).
        axes = tuple(range(-ndim_spatial, 0))
        norm = jnp.sqrt(
            jnp.sum(jnp.abs(tmp) ** 2, axis=axes, keepdims=True) * self.dx**2
        )
        tmp = tmp / norm
        y1c = self.ifft(self.fft(tmp) * exp_A)
        y1 = jnp.stack([y1c.real, y1c.imag], axis=-1)
        return y1, None

    def evolve(self, rhs, y0, t0, dt, n_steps, unroll=1):
        """Advance ``n_steps`` split steps; with ``fast_evolve`` the
        trailing and leading A half-steps of consecutive substeps merge
        into one full exponential — the standard *midpoint* Strang scheme
        (B evaluated at the half-propagated state): 2 FFT pairs per substep
        instead of 4, and formally 2nd-order where the reference's
        B-at-step-input variant is 1st.  Not bit-identical to per-step
        reference semantics; parity tests use :meth:`step`."""
        if not self.fast_evolve:
            def body(y, i):
                y1, _ = self.step(rhs, y, t0 + i * dt, dt)
                y1 = jax.tree_util.tree_map(
                    lambda a, b: a.astype(b.dtype), y1, y
                )
                return y1, None

            yT, _ = jax.lax.scan(body, y0, jnp.arange(n_steps),
                                 unroll=unroll)
            return yT

        dtc = dt * self.time_scale
        ndim_spatial = jnp.ndim(self.A_term)
        axes = tuple(range(-ndim_spatial, 0))
        # Pin the complex working dtype to the state's precision so the
        # scan carry stays type-stable (x64 mode would promote through the
        # complex128 A_term constants).
        cdtype = jnp.result_type(y0.dtype, jnp.complex64)
        expA_half = jnp.exp(self.A_term * 0.5 * dtc).astype(cdtype)
        expA_full = expA_half * expA_half
        yc = (y0[..., 0] + 1j * y0[..., 1]).astype(cdtype)

        def apply_B_renorm(psi, t):
            stacked = jnp.stack([psi.real, psi.imag], axis=-1)
            b = rhs(stacked, t)
            psi = psi * jnp.exp((b[..., 0] + 1j * b[..., 1]) * dtc)
            norm = jnp.sqrt(
                jnp.sum(jnp.abs(psi) ** 2, axis=axes, keepdims=True)
                * self.dx**2
            )
            return (psi / norm).astype(cdtype)

        psi = self.ifft(self.fft(yc) * expA_half)
        if n_steps > 1:
            def body(p, i):
                p = apply_B_renorm(p, t0 + i * dt)
                p = self.ifft(self.fft(p) * expA_full).astype(cdtype)
                return p, None

            psi, _ = jax.lax.scan(body, psi, jnp.arange(n_steps - 1),
                                  unroll=unroll)
        psi = apply_B_renorm(psi, t0 + (n_steps - 1) * dt)
        psi = self.ifft(self.fft(psi) * expA_half)
        out = jnp.stack([psi.real, psi.imag], axis=-1)
        return out.astype(y0.dtype)

    def __hash__(self):
        return hash((type(self), complex(self.time_scale), float(self.dx),
                     self.fast_evolve))

    def __eq__(self, other):
        return (
            type(self) is type(other)
            and self.time_scale == other.time_scale
            and self.dx == other.dx
            and self.fast_evolve == other.fast_evolve
        )


class DirectionalSplitting(AbstractStepper):
    """Directional (ADI-style) split-step for rotating-frame GPE.

    The reference defines the rotating-frame equation ``GPE2DTSRot``
    (``gross_pitaevskii.py:84-131``) whose ``A_terms`` returns *per-direction*
    mixed-basis symbols (x-sweep diagonal under an x-FFT, y-sweep under a
    y-FFT — the −Ω·L_z term couples k_x with y and k_y with x), but ships no
    solver able to integrate it.  This stepper completes the capability:

        ψ ← F_x⁻¹ e^{A_x δt/2} F_x ψ;  ψ ← F_y⁻¹ e^{A_y δt/2} F_y ψ;
        ψ ← e^{B(ψ,t) δt} ψ  (+ optional L² renormalization);
        then the y- and x-sweeps again in reverse order (Strang symmetry).

    Works on complex state arrays with trailing 2D spatial axes (batch axes
    lead).  ``time_scale=-1j`` selects imaginary-time ground-state search
    (renormalizing each step).

    Reference for the scheme: Bao & Cai, arXiv:1212.5341 §4 (GPE with
    angular-momentum rotation).
    """

    required_equation_attrs = ("A_terms", "B_terms", "dx")
    order = 2

    def __init__(self, A_terms, B_terms, dx, time_scale=1.0, normalize=None):
        self.A_terms = A_terms
        self.B_terms = B_terms
        self.dx = dx
        self.time_scale = time_scale
        if normalize is None:
            # Host-side dtype check (no eager device op on a complex
            # scalar).
            normalize = complex(time_scale).imag != 0.0
        self.normalize = normalize

    def step(self, rhs, y, t, dt):
        del rhs  # the equation enters through A_terms/B_terms
        dt = dt * self.time_scale
        Ax, Ay = self.A_terms(None, t)
        expAx = jnp.exp(0.5 * dt * jnp.asarray(Ax))
        expAy = jnp.exp(0.5 * dt * jnp.asarray(Ay))

        def sweep_x(psi):
            return jnp.fft.ifft(expAx * jnp.fft.fft(psi, axis=-2), axis=-2)

        def sweep_y(psi):
            return jnp.fft.ifft(expAy * jnp.fft.fft(psi, axis=-1), axis=-1)

        psi = sweep_x(y)
        psi = sweep_y(psi)
        b = self.B_terms(psi, t)
        psi = psi * jnp.exp(b * dt)
        if self.normalize:
            norm = jnp.sqrt(
                jnp.sum(jnp.abs(psi) ** 2, axis=(-2, -1), keepdims=True)
                * self.dx**2
            )
            psi = psi / norm
        psi = sweep_y(psi)
        psi = sweep_x(psi)
        return psi, None

    def __hash__(self):
        return hash((type(self), complex(self.time_scale), float(self.dx)))

    def __eq__(self, other):
        return (
            type(self) is type(other)
            and self.time_scale == other.time_scale
            and self.dx == other.dx
        )


class FusedRotatingSplitting(AbstractStepper):
    """Whole-segment matmul ADI stepper for the rotating-frame GPE.

    Matmul path for :class:`DirectionalSplitting`: each directional sweep
    is a precomputed per-grid-line dense propagator applied as one batched
    contraction (4 real matmuls) instead of a 1D FFT pair — and
    consecutive Strang half-sweeps merge across the segment (3 sweeps per inner substep, see
    :mod:`pde_opt_jax.ops.gpe_rot_fast`).  ``A_terms`` must be static
    (trap/rotation constants — evaluated once at trace time); ``B_terms``
    may close over traced per-env controls (the RL env hook).  Semantics
    match :class:`DirectionalSplitting` in exact arithmetic
    (``tests/test_gpe_rot_fast.py``).
    """

    required_equation_attrs = ("A_terms", "B_terms", "dx")
    order = 2

    def __init__(self, A_terms, B_terms, dx, time_scale=1.0, normalize=None,
                 mats_dtype=None, phase_poly=True):
        self.A_terms = A_terms
        self.B_terms = B_terms
        self.dx = dx
        self.time_scale = time_scale
        if normalize is None:
            normalize = complex(time_scale).imag != 0.0
        self.normalize = normalize
        self.mats_dtype = mats_dtype
        self.phase_poly = phase_poly

    def evolve(self, rhs, y0, t0, dt, n_steps, unroll=1):
        del rhs, unroll
        if isinstance(dt, jax.core.Tracer):
            raise TypeError(
                "FusedRotatingSplitting requires trace-time concrete dt"
            )
        from .gpe_rot_fast import make_rot_adi_macro

        H, W = y0.shape[-2:]
        kwargs = {}
        if self.mats_dtype is not None:
            kwargs["mats_dtype"] = self.mats_dtype
        macro = make_rot_adi_macro(
            self.A_terms, self.B_terms, float(self.dx), H, W, float(dt),
            int(n_steps), time_scale=self.time_scale,
            normalize=self.normalize, phase_poly=self.phase_poly, **kwargs,
        )
        return macro(y0, t0)

    def step(self, rhs, y, t, dt):
        return self.evolve(rhs, y, t, dt, 1), None


class ImplicitEuler(AbstractStepper):
    """Backward Euler via matrix-free Newton-Krylov (GMRES).

    Capability parity with the reference's ``diffrax.ImplicitEuler`` +
    ``optimistix.Newton``/``lineax.GMRES`` path
    (``/root/reference/notebooks/test_implicit.ipynb``).  Solves
    ``g(y1) = y1 - y0 - dt*rhs(y1, t1) = 0``; each Jacobian solve is
    matrix-free GMRES on ``jvp(g)``.

    Newton iterates until the residual norm satisfies
    ``||g|| <= atol + rtol·||y||`` or ``newton_iters`` is reached —
    data-dependent but fully traceable: a ``while_loop`` by default, or
    (``differentiable=True``) a masked ``fori_loop`` whose converged
    iterations are select-frozen, which reverse-mode AD can unroll.
    :meth:`solve_step` additionally returns convergence diagnostics
    (iterations used, final residual norm, converged flag) so a caller
    pushing dt can DETECT a non-converged solve instead of silently
    integrating garbage — the round-3 review's failure mode.
    """

    order = 1

    def __init__(self, newton_iters: int = 12, gmres_iters: int = 20,
                 tol: float = 1e-10, rtol: float = 1e-8, atol: float = 1e-10,
                 differentiable: bool = False):
        self.newton_iters = newton_iters
        self.gmres_iters = gmres_iters
        self.tol = tol
        self.rtol = rtol
        self.atol = atol
        self.differentiable = differentiable

    def _norm(self, z):
        return jnp.sqrt(jnp.sum(jnp.real(z * jnp.conj(z))))

    def solve_step(self, rhs, y, t, dt):
        """One backward-Euler solve; returns ``(y1, stats)`` with
        ``stats = {"iterations", "residual_norm", "converged"}``."""
        t1 = t + dt
        thresh = self.atol + self.rtol * self._norm(y)

        def g(z):
            return z - y - dt * rhs(z, t1)

        def newton_update(z):
            gz = g(z)

            def jvp_fn(v):
                return jax.jvp(g, (z,), (v,))[1]

            delta, _ = jax.scipy.sparse.linalg.gmres(
                jvp_fn, gz, tol=self.tol, maxiter=self.gmres_iters,
                solve_method="batched"
            )
            return z - delta

        z0 = y + dt * rhs(y, t)
        r0 = self._norm(g(z0))
        if self.differentiable:
            def body(_, carry):
                z, res, it = carry
                done = res <= thresh
                z_new = newton_update(z)
                z = jnp.where(done, z, z_new)
                res_new = self._norm(g(z))
                return (z, jnp.where(done, res, res_new),
                        it + jnp.where(done, 0, 1))

            z, res, iters = jax.lax.fori_loop(
                0, self.newton_iters, body, (z0, r0, jnp.int32(0)))
        else:
            def cond(carry):
                _, res, it = carry
                return (res > thresh) & (it < self.newton_iters)

            def body(carry):
                z, _, it = carry
                z = newton_update(z)
                return z, self._norm(g(z)), it + 1

            z, res, iters = jax.lax.while_loop(
                cond, body, (z0, r0, jnp.int32(0)))
        stats = {"iterations": iters, "residual_norm": res,
                 "converged": res <= thresh}
        return z, stats

    def step(self, rhs, y, t, dt):
        y1, _ = self.solve_step(rhs, y, t, dt)
        return y1, y1 - (y + dt * rhs(y, t))

    def __hash__(self):
        return hash((type(self), self.newton_iters, self.gmres_iters,
                     self.tol, self.rtol, self.atol, self.differentiable))

    def __eq__(self, other):
        return (
            type(self) is type(other)
            and (self.newton_iters, self.gmres_iters, self.tol, self.rtol,
                 self.atol, self.differentiable)
            == (other.newton_iters, other.gmres_iters, other.tol,
                other.rtol, other.atol, other.differentiable)
        )
