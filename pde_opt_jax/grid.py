"""Uniform cell-centered grids and their Fourier duals.

Counterpart of the reference ``Domain`` dataclass
(``/root/reference/pde_opt/numerics/domains.py:13-67``): same public surface
(``points``, ``box``, ``units``, ``dx``, ``L``, ``axes``, ``fft_axes``,
``rfft_axes``, ``mesh``, ``fft_mesh``, ``rfft_mesh``, optional ``geometry``),
but designed as a *static*, hashable description.  All derived arrays
(meshes, wavenumbers, spectral symbols) are pure functions of the static
fields, so under ``jit`` they fold into compile-time constants — nothing is
carried across the host↔device boundary per step.

The grid is the single source of truth for spatial layout.  Spatial axes are
always the *trailing* axes of a state array; any leading axes are batch (env)
axes.  Every kernel in :mod:`pde_opt_jax.ops` follows this convention, which
is what makes the whole framework batch-transparent without ``vmap``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, TYPE_CHECKING

import jax
import jax.numpy as jnp
import numpy as np

if TYPE_CHECKING:  # pragma: no cover
    from .geometry import Shape


@dataclasses.dataclass
class Domain:
    """A uniform, cell-centered rectangular grid.

    Attributes:
        points: number of collocation points per dimension.
        box: ``((lo, hi), ...)`` physical bounds per dimension.
        units: human-readable length unit label.
        geometry: optional smoothed-boundary :class:`~pde_opt_jax.geometry.Shape`
            for irregular domains.
        dtype: real dtype used for derived meshes (default float32 — the
            accelerator-native precision; pass ``jnp.float64`` with x64 enabled to
            reproduce the reference's CPU test conditions).
    """

    points: Tuple[int, ...]
    box: Tuple[Tuple[float, float], ...]
    units: str = "dimensionless"
    geometry: Optional["Shape"] = None
    dtype: jnp.dtype = jnp.float32

    def __post_init__(self):
        self.points = tuple(int(p) for p in self.points)
        self.box = tuple((float(lo), float(hi)) for lo, hi in self.box)
        self.dx = tuple(
            (hi - lo) / n for (lo, hi), n in zip(self.box, self.points)
        )
        self.L = tuple(hi - lo for (lo, hi) in self.box)

    @property
    def ndim(self) -> int:
        return len(self.points)

    # All derived axes/meshes are host-side numpy: they are static
    # configuration.  Consumed inside traced code they become compile-time
    # constants; nothing here ever dispatches an eager device op.

    # ---- spatial axes / meshes (cell-centered) -------------------------
    def axes(self) -> Tuple[np.ndarray, ...]:
        return tuple(
            np.linspace(lo + h / 2, hi - h / 2, num=n).astype(self.dtype)
            for (lo, hi), n, h in zip(self.box, self.points, self.dx)
        )

    def mesh(self) -> Tuple[np.ndarray, ...]:
        return tuple(np.meshgrid(*self.axes(), indexing="ij"))

    # ---- Fourier axes / meshes -----------------------------------------
    def fft_axes(self) -> Tuple[np.ndarray, ...]:
        return tuple(
            np.fft.fftfreq(n, h).astype(self.dtype)
            for n, h in zip(self.points, self.dx)
        )

    def rfft_axes(self) -> Tuple[np.ndarray, ...]:
        return tuple(
            np.fft.rfftfreq(n, h).astype(self.dtype)
            for n, h in zip(self.points, self.dx)
        )

    def fft_mesh(self) -> Tuple[np.ndarray, ...]:
        return tuple(np.meshgrid(*self.fft_axes(), indexing="ij"))

    def rfft_mesh(self) -> Tuple[np.ndarray, ...]:
        """Real-FFT mesh: full frequencies on leading axes, half on the last.

        Matches ``numpy``'s rfftn layout; useful because real fields only need
        the half-spectrum, halving HBM traffic for spectral steppers.
        """
        axes = list(self.fft_axes())
        axes[-1] = self.rfft_axes()[-1]
        return tuple(np.meshgrid(*axes, indexing="ij"))

    # ---- spectral symbols ----------------------------------------------
    def two_pi_i_k(self) -> Tuple[np.ndarray, ...]:
        """``2πik`` per dimension — the spectral first-derivative symbols."""
        return tuple(2j * np.pi * k for k in self.fft_mesh())

    def laplacian_symbol(self) -> np.ndarray:
        """``(2πik)² summed`` — the spectral Laplacian symbol (real, ≤ 0)."""
        return sum((2 * np.pi * k) ** 2 for k in self.fft_mesh()) * (-1.0)

    def __str__(self):
        return (
            f"Domain with bounds {self.box} with units of {self.units} "
            f"and {self.points} collocation points."
        )

    # Hashability: a Domain is static configuration. Two domains are
    # interchangeable iff their static fields match, so jit caches keyed on a
    # Domain (e.g. closures in equations) behave correctly.
    def __hash__(self):
        return hash((self.points, self.box, self.units, str(self.dtype)))

    def __eq__(self, other):
        if not isinstance(other, Domain):
            return NotImplemented
        return (
            self.points == other.points
            and self.box == other.box
            and self.units == other.units
            and self.geometry is other.geometry
            and self.dtype == other.dtype
        )


# Alias: the framework calls it a Grid internally; `Domain` keeps the
# reference spelling for drop-in familiarity.
Grid = Domain
