"""Gross-Pitaevskii equation family (BEC dynamics, time-splitting form).

Capability parity with ``/root/reference/pde_opt/numerics/equations/gross_pitaevskii.py``
(``GPE2DTSControl`` :18-81, ``GPE2DTSRot`` :84-131).  State is stored as a
real ``(..., 2)`` stack of (Re ψ, Im ψ) — matrix units have no complex datapath, so
real-stacked storage is the native layout; complex arithmetic appears only at
the FFT boundary inside the Strang stepper.

Note on the kinetic term: the reference zeroes the split-step ``A_term``
(``gross_pitaevskii.py:62-65`` multiplies it by 0.0), i.e. it integrates the
Thomas-Fermi/strong-interaction limit — valid for the imaginary-time
ground-state searches its tests exercise.  That behavior is the default here
(``kinetic=False``); pass ``kinetic=True`` for the full dispersion.
"""

from __future__ import annotations

from typing import Callable

import jax.numpy as jnp
import numpy as np

from ..grid import Domain
from ..ops.spectral import make_fft_pair
from .base import TimeSplittingEquation

__all__ = ["GPE2DTSControl", "GPE2DTSRot", "hbar", "mass_Na23", "a0"]

# Physical constants (reference gross_pitaevskii.py:14-16)
hbar = 1.05e-34  # J*s
mass_Na23 = 3.8175406e-26  # kg (sodium-23)
a0 = 5.29177210903e-11  # Bohr radius


class GPE2DTSControl(TimeSplittingEquation):
    """2D GPE with harmonic trap, optical control field and interaction.

        i ∂ψ/∂t = [−½∇² + V(r,t) + k|ψ|²] ψ
        V(r,t) = ½·trap_factor·[(1+e)x² + (1−e)y²] + V_control(r,t)

    ``lights(t, x, y)`` is the control field — a plain callable or a learnable
    module; in the RL env it is rebuilt per macro-step from a *traced* control
    value, so changing the control never retraces.
    """

    fft = None
    ifft = None
    A_term = None
    dx = None
    # Class-level placeholders so solver-compat checks (which inspect the
    # class) see the attrs the fused Strang stepper pulls off instances.
    k = None
    e = None
    lights = None
    trap_factor = None
    kinetic = None
    domain = None

    def __init__(self, domain: Domain, k, e, lights: Callable,
                 trap_factor: float = 1.0, kinetic: bool = False):
        self.domain = domain
        self.k = k
        self.e = e
        self.lights = lights
        self.trap_factor = trap_factor
        self.kinetic = kinetic

        self.dx = domain.dx[0]
        kx, ky = domain.fft_mesh()
        self.two_pi_i_kx = 2j * np.pi * kx
        self.two_pi_i_ky = 2j * np.pi * ky
        self.two_pi_i_k_2 = self.two_pi_i_kx**2 + self.two_pi_i_ky**2
        self.fft, self.ifft = make_fft_pair(2)
        self.xmesh, self.ymesh = domain.mesh()
        # Split-step linear symbol: kinetic −½∇²ψ → A = ½ i (2πik)².
        # Reference zeroes this (Thomas-Fermi regime, gross_pitaevskii.py:62).
        self.A_term = 0.5j * self.two_pi_i_k_2 * (1.0 if kinetic else 0.0)

    def control(self, t):
        return self.lights(t, self.xmesh, self.ymesh)

    def A_terms(self, state, t):
        return self.A_term if self.kinetic else self.A_term * 0.0

    def B_terms(self, state, t):
        tmp = (
            -0.5j
            * self.trap_factor
            * ((1 + self.e) * self.xmesh**2 + (1 - self.e) * self.ymesh**2)
            - 1j * self.control(t)
            - self.k * 1j * (jnp.abs(state[..., 0] + 1j * state[..., 1]) ** 2)
        )
        return jnp.stack(
            [jnp.broadcast_to(tmp.real, state[..., 0].shape),
             jnp.broadcast_to(tmp.imag, state[..., 0].shape)],
            axis=-1,
        )

    def rhs(self, state, t):
        # For the Strang stepper the vector field is the B (pointwise) part;
        # the A part is applied exactly in Fourier space by the stepper.
        return self.B_terms(state, t)


class GPE2DTSRot(TimeSplittingEquation):
    """2D GPE in a rotating frame: adds −Ω·L_z (reference :84-131).

    The rotating-frame split is per-direction (ADI-style): ``A_terms`` returns
    the x- and y-sweep symbols separately, each diagonalizable by a 1D FFT.

    ``lights(t, x, y)`` (optional) is an extra pointwise control potential —
    in the rotating frame a static spot is a co-rotating stirrer; the RL
    preset (:func:`pde_opt_jax.envs.presets.make_gpe_rot_control_env`)
    rebuilds it per macro-step from the traced per-env control, exactly as
    ``GPE2DTSControl`` does.  It enters ``B_terms`` only, so the
    precomputed ADI sweep matrices of the fused stepper stay static.
    """

    # Class-level placeholders so solver-compat checks (which inspect the
    # class) see the attrs the steppers pull off instances.
    dx = None
    lights = None
    domain = None
    k = None
    e = None
    omega = None

    def __init__(self, domain: Domain, k, e, omega, lights: Callable = None):
        self.domain = domain
        self.k = k
        self.e = e
        self.omega = omega
        self.lights = lights
        self.dx = domain.dx[0]

        # Constants are kept REAL; complex values are formed in-trace by jnp
        # ops (real constants + on-device `* 1j` fold to the same HLO as
        # complex constants, without a host->device complex transfer).
        kx, ky = domain.fft_mesh()
        self.two_pi_kx = 2.0 * np.pi * kx
        self.two_pi_ky = 2.0 * np.pi * ky
        self.fft, self.ifft = make_fft_pair(2)
        self.xmesh, self.ymesh = domain.mesh()

    def A_terms(self, state_hat, t):
        ikx = 1j * jnp.asarray(self.two_pi_kx)
        iky = 1j * jnp.asarray(self.two_pi_ky)
        return (
            0.5j * ikx**2 - self.omega * jnp.asarray(self.ymesh) * ikx,
            0.5j * iky**2 + self.omega * jnp.asarray(self.xmesh) * iky,
        )

    def B_terms(self, state, t):
        trap = jnp.asarray(
            (1 + self.e) * self.xmesh**2 + (1 - self.e) * self.ymesh**2
        )
        b = -0.5j * trap - self.k * 1j * (jnp.abs(state) ** 2)
        if self.lights is not None:
            b = b - 1j * self.lights(t, jnp.asarray(self.xmesh),
                                     jnp.asarray(self.ymesh))
        return b

    def rhs(self, state, t):
        raise NotImplementedError(
            "GPE2DTSRot is integrated by directional split-step; use A_terms/B_terms."
        )
