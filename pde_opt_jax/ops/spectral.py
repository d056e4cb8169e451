"""Batched spectral operators.

The reference binds ``jnp.fft.fftn``/``ifftn`` directly onto equation objects
(``/root/reference/pde_opt/numerics/equations/cahn_hilliard.py:72-73``),
transforming *all* axes — which silently breaks the moment a batch axis is
added.  Here every transform is pinned to the trailing ``ndim`` spatial axes,
so spectral RHS evaluations and semi-implicit steps run over arbitrary env
fleets in one XLA FFT batch (the FFT is batched natively; batch-major
layout keeps the lanes full).
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp

__all__ = ["fftn", "ifftn", "rfftn", "irfftn", "spatial_axes", "make_fft_pair", "make_rfft_pair"]


def spatial_axes(ndim: int) -> Tuple[int, ...]:
    """The trailing ``ndim`` axes: ``(-ndim, ..., -1)``."""
    return tuple(range(-ndim, 0))


def fftn(x, ndim: int):
    return jnp.fft.fftn(x, axes=spatial_axes(ndim))


def ifftn(x, ndim: int):
    return jnp.fft.ifftn(x, axes=spatial_axes(ndim))


def rfftn(x, ndim: int):
    return jnp.fft.rfftn(x, axes=spatial_axes(ndim))


def irfftn(x, shape, ndim: int):
    return jnp.fft.irfftn(x, s=shape, axes=spatial_axes(ndim))


def make_fft_pair(ndim: int):
    """Return ``(fft, ifft)`` closures over the trailing ``ndim`` axes.

    These are what equations expose as their ``fft``/``ifft`` attributes for
    the solver auto-wiring contract (reference ``solvers.py:42,84``), batched.
    """
    return partial(fftn, ndim=ndim), partial(ifftn, ndim=ndim)


def make_rfft_pair(ndim: int, shape):
    """Real-input ``(rfft, irfft)`` closures over the trailing ``ndim`` axes.

    Real PDE fields only need the half-spectrum: rfft halves the spectral
    array (and hence HBM traffic through the semi-implicit step's
    divide-by-symbol) vs the reference's full ``fftn``
    (``cahn_hilliard.py:72-73``).  ``irfft`` pins the output length to
    ``shape`` so odd-size grids round-trip exactly.  Note ``irfft`` returns a
    *real* array; ``.real`` on it is a no-op, so these closures satisfy the
    same stepper contract as the complex pair.
    """
    shape = tuple(shape)

    def _rfft(x):
        return jnp.fft.rfftn(x, axes=spatial_axes(ndim))

    def _irfft(x):
        return jnp.fft.irfftn(x, s=shape, axes=spatial_axes(ndim))

    return _rfft, _irfft


def fourier_derivative(u_hat, two_pi_i_k: jax.Array):
    """Multiply a spectrum by the first-derivative symbol ``2πik``."""
    return two_pi_i_k * u_hat
