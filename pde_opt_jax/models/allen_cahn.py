"""Allen-Cahn equation family (incl. Butler-Volmer electrochemistry).

Capability parity with ``/root/reference/pde_opt/numerics/equations/allen_cahn.py``:
``AllenCahn2DPeriodic`` (:26-84), ``AllenCahn2DSmoothedBoundary`` (:87-159),
``AllenCahn2DPeriodicButlerVolmer`` (:162-210),
``AllenCahn2DPeriodicButlerVolmerConstantCurrent`` (:213-281) and
``AllenCahn2DSmoothedBoundaryButlerVolmerConstantCurrent`` (:284-383) —
rebuilt batch-transparent on trailing spatial axes.

The constant-current closures take *global* spatial integrals per instance;
those reductions are over the trailing axes with ``keepdims`` so a batched
state yields one overpotential per env.  If a single instance's grid is ever
spatially sharded, these sums are the one place needing a ``psum``
(see :mod:`pde_opt_jax.parallel.halo`).
"""

from __future__ import annotations

from typing import Callable, Optional

import jax.numpy as jnp
import numpy as np

from ..grid import Domain
from ..ops import stencils as st
from ..ops.spectral import make_fft_pair, make_rfft_pair
from .base import BaseEquation

__all__ = [
    "AllenCahn2DPeriodic",
    "AllenCahn2DSmoothedBoundary",
    "AllenCahn2DPeriodicButlerVolmer",
    "AllenCahn2DPeriodicButlerVolmerConstantCurrent",
    "AllenCahn2DSmoothedBoundaryButlerVolmerConstantCurrent",
]


class _Spectral2D:
    """Shared 2D spectral precomputation (k-meshes fold to jit constants)."""

    def _init_spectral(self, domain: Domain, use_rfft: bool = True):
        self.use_rfft = use_rfft
        kx, ky = domain.rfft_mesh() if use_rfft else domain.fft_mesh()
        self.two_pi_i_kx = 2j * np.pi * kx
        self.two_pi_i_ky = 2j * np.pi * ky
        self.two_pi_i_k_2 = self.two_pi_i_kx**2 + self.two_pi_i_ky**2
        if use_rfft:
            self.fft, self.ifft = make_rfft_pair(2, domain.points)
        else:
            self.fft, self.ifft = make_fft_pair(2)


class AllenCahn2DPeriodic(BaseEquation, _Spectral2D):
    """2D periodic Allen-Cahn: ∂u/∂t = −R(u)·μ, μ = μ_h(u) − κ∇²u."""

    fft = None
    ifft = None
    fourier_symbol = None
    # Class-level placeholders so solver-compat checks (which inspect the
    # class) see the attrs the fused stepper pulls off instances.
    kappa = None
    mu = None
    R = None
    domain = None

    def __init__(self, domain: Domain, kappa, mu: Callable, R: Callable,
                 derivs: str = "fd", use_rfft: bool = True):
        self.domain = domain
        self.kappa = kappa
        self.mu = mu
        self.R = R
        self.derivs = derivs
        self._init_spectral(domain, use_rfft)
        # Spectral symbol of the highest-order operator (−κ∇² → −κ(2πik)²);
        # lets the semi-implicit stepper treat stiff AC too (not in reference).
        self.fourier_symbol = -kappa * self.two_pi_i_k_2

        if derivs == "fourier":
            self.rhs = self.rhs_fourier
        elif derivs == "fd":
            self.rhs = self.rhs_fd
        else:
            raise ValueError(f"Invalid derivative type: {derivs}")

    def rhs_fourier(self, state, t):
        state_hat = self.fft(state)
        mu = self.ifft(
            self.fft(self.mu(state)) - self.kappa * self.two_pi_i_k_2 * state_hat
        ).real
        return -self.R(state) * mu

    def rhs_fd(self, state, t):
        hx, hy = self.domain.dx
        mu = self.mu(state) - self.kappa * st.lap_2nd_2d(state, hx, hy)
        return -self.R(state) * mu


class AllenCahn2DSmoothedBoundary(BaseEquation):
    """Allen-Cahn with smoothed-boundary contact-angle term.

    ``contact_cols``: the reference hardcodes the contact mask to the first
    100 columns (``allen_cahn.py:135-136``); parameterized with that default.
    """

    def __init__(self, domain: Domain, kappa, f: Callable, mu: Callable,
                 R: Callable, theta: Callable, derivs: str = "fd",
                 contact_cols: int = 100,
                 contact_mask: Optional[jnp.ndarray] = None):
        if derivs != "fd":
            raise ValueError(f"Invalid derivative type: {derivs}")
        self.domain = domain
        self.kappa = kappa
        self.f = f
        self.mu = mu
        self.R = R
        self.theta = theta
        self.derivs = derivs

        self.psi = domain.geometry.smooth
        self.sqrt_kappa = np.sqrt(kappa)
        self.hx, self.hy = domain.dx
        self.norm_grad_psi = (
            jnp.sqrt(
                st.grad_c(self.psi, self.hx, -2) ** 2
                + st.grad_c(self.psi, self.hy, -1) ** 2
            )
            / self.psi
        )
        if contact_mask is None:
            contact_mask = jnp.zeros_like(self.psi).at[:, :contact_cols].set(1.0)
        self.left_half = contact_mask
        self.psi_avgx = st.avg_c2f(self.psi, -2)
        self.psi_avgy = st.avg_c2f(self.psi, -1)
        self.rhs = self.rhs_fd

    def _sbm_mu(self, state, t, with_contact=True):
        mu = self.mu(state) - (self.kappa / self.psi) * (
            st.div_f2c(self.psi_avgx * st.grad_c2f(state, self.hx, -2), self.hx, -2)
            + st.div_f2c(self.psi_avgy * st.grad_c2f(state, self.hy, -1), self.hy, -1)
        )
        if with_contact:
            mu = mu - (
                self.sqrt_kappa
                * self.norm_grad_psi
                * jnp.sqrt(2.0 * self.f(state))
                * jnp.cos(self.theta(t))
                * self.left_half
            )
        return mu

    def rhs_fd(self, state, t):
        return -self.R(state) * self._sbm_mu(state, t)


def _bv_reaction(j0_val, eta, alpha):
    """Butler-Volmer kinetics: j0(u)·(e^{−αη} − e^{(1−α)η})."""
    return j0_val * (jnp.exp(-alpha * eta) - jnp.exp((1.0 - alpha) * eta))


class AllenCahn2DPeriodicButlerVolmer(BaseEquation, _Spectral2D):
    """Butler-Volmer reaction-driven Allen-Cahn at fixed applied voltage ``v``.

    ``rhs`` takes the overpotential offset through ``v`` supplied at
    construction (the reference's variant leaves ``v`` a free argument of
    ``rhs_fd``, ``allen_cahn.py:204``; here it is a constructor parameter so
    the equation satisfies the uniform ``rhs(state, t)`` contract — pass a
    new ``v`` by rebuilding, or use it as the env control parameter, which
    traces it).
    """

    fft = None
    ifft = None

    def __init__(self, domain: Domain, kappa, mu: Callable, j0: Callable,
                 alpha: float, v=0.0, derivs: str = "fd"):
        self.domain = domain
        self.kappa = kappa
        self.mu = mu
        self.j0 = j0
        self.alpha = alpha
        self.v = v
        self.derivs = derivs
        self._init_spectral(domain)
        if derivs != "fd":
            raise ValueError(f"Invalid derivative type: {derivs}")
        self.rhs = self.rhs_fd

    def rhs_fd(self, state, t):
        hx, hy = self.domain.dx
        mu = self.mu(state) - self.kappa * st.lap_2nd_2d(state, hx, hy)
        eta = mu + self.v
        return _bv_reaction(self.j0(state), eta, self.alpha)


class AllenCahn2DPeriodicButlerVolmerConstantCurrent(BaseEquation, _Spectral2D):
    """Butler-Volmer Allen-Cahn under a constant-current (galvanostatic) constraint.

    Per instance, the cell voltage ``v`` is solved in closed form from the
    global current constraint (reference ``allen_cahn.py:257-270``):

        I = ∫ j0 e^{−μ/2} y − ∫ j0 e^{μ/2} / y  with α = 1/2, y = e^{v/2}.

    The integrals reduce over trailing spatial axes (keepdims) so a batched
    state yields a per-env voltage that broadcasts back into the reaction.
    """

    fft = None
    ifft = None
    # Class-level placeholders so solver-compat checks (which inspect the
    # class) see the attrs the fused stepper pulls off instances.
    kappa = None
    mu = None
    j0 = None
    alpha = None
    Crate = None
    domain = None

    def __init__(self, domain: Domain, kappa, mu: Callable, j0: Callable,
                 alpha: float, Crate: float, derivs: str = "fd"):
        self.domain = domain
        self.kappa = kappa
        self.mu = mu
        self.j0 = j0
        self.alpha = alpha
        self.Crate = Crate
        self.derivs = derivs
        self._init_spectral(domain)
        if derivs != "fd":
            raise ValueError(f"Invalid derivative type: {derivs}")
        self.rhs = self.rhs_fd

    def _mu_and_v(self, state):
        hx, hy = self.domain.dx
        mu = self.mu(state) - self.kappa * st.lap_2nd_2d(state, hx, hy)
        j0v = self.j0(state)
        cell = hx * hy
        int_plus = jnp.sum(j0v * jnp.exp(0.5 * mu), axis=(-2, -1), keepdims=True) * cell
        int_minus = jnp.sum(j0v * jnp.exp(-0.5 * mu), axis=(-2, -1), keepdims=True) * cell
        y = (-self.Crate + jnp.sqrt(self.Crate**2 + 4.0 * int_plus * int_minus)) / (
            2.0 * int_plus
        )
        v = 2.0 * jnp.log(y)
        return mu, v, j0v

    def rhs_fd(self, state, t):
        mu, v, j0v = self._mu_and_v(state)
        return _bv_reaction(j0v, mu + v, self.alpha)

    def get_voltage(self, state):
        """Cell voltage satisfying the constant-current constraint.

        Returns a scalar for an unbatched state, per-env values otherwise
        (reference ``allen_cahn.py:272-281``).
        """
        _, v, _ = self._mu_and_v(state)
        return jnp.squeeze(v, axis=(-2, -1))


class AllenCahn2DSmoothedBoundaryButlerVolmerConstantCurrent(BaseEquation):
    """Galvanostatic Butler-Volmer Allen-Cahn on an SBM geometry.

    ψ-weighted global integrals per reference ``allen_cahn.py:340-354``; the
    contact-angle term is disabled in the reference rhs (commented out,
    ``allen_cahn.py:334-338``) and likewise here.
    """

    # Class-level placeholders so solver-compat checks (which inspect the
    # class) see the attrs the fused SBM stepper pulls off instances.
    kappa = None
    mu = None
    j0 = None
    alpha = None
    Crate = None
    domain = None
    psi = None

    def __init__(self, domain: Domain, kappa, f: Callable, mu: Callable,
                 j0: Callable, alpha: float, Crate: float, derivs: str = "fd",
                 contact_cols: int = 100, psi=None):
        if derivs != "fd":
            raise ValueError(f"Invalid derivative type: {derivs}")
        self.domain = domain
        self.kappa = kappa
        self.f = f
        self.mu = mu
        self.j0 = j0
        self.alpha = alpha
        self.Crate = Crate
        self.derivs = derivs

        # psi: inject a precomputed level-set field directly (analytic
        # profile, checkpointed smooth, ...); defaults to the domain
        # geometry's smoothed mask.
        self.psi = domain.geometry.smooth if psi is None else jnp.asarray(psi)
        self.sqrt_kappa = np.sqrt(kappa)
        self.hx, self.hy = domain.dx
        self.norm_grad_psi = (
            jnp.sqrt(
                st.grad_c(self.psi, self.hx, -2) ** 2
                + st.grad_c(self.psi, self.hy, -1) ** 2
            )
            / self.psi
        )
        self.left_half = jnp.zeros_like(self.psi).at[:, :contact_cols].set(1.0)
        self.psi_avgx = st.avg_c2f(self.psi, -2)
        self.psi_avgy = st.avg_c2f(self.psi, -1)
        self.rhs = self.rhs_fd

    def _mu_and_v(self, state):
        mu = self.mu(state) - (self.kappa / self.psi) * (
            st.div_f2c(self.psi_avgx * st.grad_c2f(state, self.hx, -2), self.hx, -2)
            + st.div_f2c(self.psi_avgy * st.grad_c2f(state, self.hy, -1), self.hy, -1)
        )
        j0v = self.j0(state)
        cell = self.hx * self.hy
        int_plus = jnp.sum(
            j0v * jnp.exp(0.5 * mu) * self.psi, axis=(-2, -1), keepdims=True
        ) * cell
        int_minus = jnp.sum(
            j0v * jnp.exp(-0.5 * mu) * self.psi, axis=(-2, -1), keepdims=True
        ) * cell
        y = (-self.Crate + jnp.sqrt(self.Crate**2 + 4.0 * int_plus * int_minus)) / (
            2.0 * int_plus
        )
        v = 2.0 * jnp.log(y)
        return mu, v, j0v

    def rhs_fd(self, state, t):
        mu, v, j0v = self._mu_and_v(state)
        return _bv_reaction(j0v, mu + v, self.alpha)

    def get_voltage(self, state):
        _, v, _ = self._mu_and_v(state)
        return jnp.squeeze(v, axis=(-2, -1))
