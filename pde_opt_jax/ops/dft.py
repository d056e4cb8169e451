"""Matmul-based spectral solves (for small grids).

For grids whose DFT matrix is small (N ≤ ~256), the transform can be
expressed as matmuls instead of XLA's FFT of many small 2D transforms:

* ``separable``: 4 complex axis-transforms as real einsums — O(B·N³) FLOPs.
* ``dense``: the *entire* real→real solve ``irfft(denom ⊙ rfft(x))`` folded
  into one precomputed (N², N²) real matrix — O(B·N⁴) FLOPs in one large
  matmul (K = N² = 4096 for N = 64).  Only valid for a *fixed* denominator (see
  :class:`pde_opt_jax.ops.steppers.SemiImplicitFourierSpectral` fixed-symbol
  variant) — with a per-env denominator use ``separable``.

``dtype``: ``"bf16"`` runs the matmuls in bfloat16 with f32 accumulation
(~5e-3 relative error on the *increment* — fine for RL env physics, not for
convergence tests); ``"f32"`` uses full float32 (3-pass) matmuls.
"""

from __future__ import annotations

from functools import partial
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["dense_solve_matrix", "make_dense_spectral_solve",
           "make_separable_spectral_solve"]


def dense_solve_matrix(points, denom: np.ndarray) -> np.ndarray:
    """Real (N²,N²)-ish matrix S with vec(out) = S @ vec(x) for the solve
    ``out = Re ifft2(denom ⊙ fft2(x))`` on a real field.

    Built column-by-column via numpy FFTs (host-side, one-time).
    """
    H, W = points
    n = H * W
    denom = np.asarray(denom)
    # S = Re(F⁻¹ D F) as a real operator. Column j = solve(e_j).
    # Vectorized: apply the solve to the identity batch.
    eye = np.eye(n, dtype=np.float64).reshape(n, H, W)
    out = np.fft.ifftn(np.fft.fftn(eye, axes=(1, 2)) * denom[None], axes=(1, 2)).real
    return out.reshape(n, n).T.copy()  # column j action -> S[:, j]


def make_dense_spectral_solve(points, denom: np.ndarray, dtype: str = "bf16_sqrt"):
    """Return ``solve(x)`` applying the fixed dense solve to (..., H, W).

    ``dtype="bf16_sqrt"`` (default) factors the operator as P = √P·√P and
    applies two bf16 matmuls: the second √P spectrally damps the first's
    bf16 rounding noise exactly where the stiff feedback loop would amplify
    it (high k), which restores long-rollout stability that a single flat
    bf16 matmul loses — at 2× the matmul cost, still well under the FFT
    pair.  ``"bf16"`` is the single flat matmul (fastest, unstable in stiff
    loops); ``"f32"`` is exact (slow).
    """
    H, W = points
    if dtype == "bf16_sqrt":
        denom = np.asarray(denom)
        if np.any(denom < 0):
            raise ValueError("bf16_sqrt requires a nonnegative denominator")
        S_half = jnp.asarray(
            dense_solve_matrix(points, np.sqrt(denom)), jnp.bfloat16
        )

        def solve(x):
            *batch, h, w = x.shape
            xb = x.reshape(-1, h * w).astype(jnp.bfloat16)
            half = jnp.dot(xb, S_half.T, preferred_element_type=jnp.float32)
            out = jnp.dot(half.astype(jnp.bfloat16), S_half.T,
                          preferred_element_type=jnp.float32)
            return out.reshape(*batch, h, w).astype(x.dtype)

        return solve
    S = dense_solve_matrix(points, denom)
    if dtype == "bf16":
        S_dev = jnp.asarray(S, jnp.bfloat16)

        def solve(x):
            *batch, h, w = x.shape
            xb = x.reshape(-1, h * w).astype(jnp.bfloat16)
            out = jnp.dot(xb, S_dev.T, preferred_element_type=jnp.float32)
            return out.reshape(*batch, h, w).astype(x.dtype)
    elif dtype == "f32":
        S_dev = jnp.asarray(S, jnp.float32)

        def solve(x):
            *batch, h, w = x.shape
            xb = x.reshape(-1, h * w)
            out = jnp.dot(xb, S_dev.T, preferred_element_type=jnp.float32,
                          precision=jax.lax.Precision.HIGHEST)
            return out.reshape(*batch, h, w).astype(x.dtype)
    else:
        raise ValueError(f"unknown dtype: {dtype!r}")
    return solve


def make_separable_spectral_solve(points, dtype: str = "f32",
                                  precision: str = "default"):
    """Return ``solve(x, denom)`` via 4 complex axis-DFT matmuls.

    Supports a (possibly batched, full-spectrum) elementwise ``denom`` —
    usable with per-env control parameters.
    """
    H, W = points
    kh = np.arange(H)
    kw = np.arange(W)
    WH = np.exp(-2j * np.pi * np.outer(kh, kh) / H)
    WW = np.exp(-2j * np.pi * np.outer(kw, kw) / W)
    VH = np.exp(2j * np.pi * np.outer(kh, kh) / H) / H
    VW = np.exp(2j * np.pi * np.outer(kw, kw) / W) / W
    cast = (lambda a: jnp.asarray(a, jnp.bfloat16)) if dtype == "bf16" else (
        lambda a: jnp.asarray(a, jnp.float32))
    WHr, WHi = cast(WH.real), cast(WH.imag)
    WWr, WWi = cast(WW.real), cast(WW.imag)
    VHr, VHi = cast(VH.real), cast(VH.imag)
    VWr, VWi = cast(VW.real), cast(VW.imag)
    ein = partial(jnp.einsum, precision=precision,
                  preferred_element_type=jnp.float32)

    def solve(x, denom):
        xd = x.astype(WHr.dtype)
        # fft along W (last axis)
        xr = ein("...ij,kj->...ik", xd, WWr)
        xi = ein("...ij,kj->...ik", xd, WWi)
        # fft along H
        yr = ein("ki,...ij->...kj", WHr, xr) - ein("ki,...ij->...kj", WHi, xi)
        yi = ein("ki,...ij->...kj", WHr, xi) + ein("ki,...ij->...kj", WHi, xr)
        yr = yr * denom
        yi = yi * denom
        # ifft along H
        zr = ein("ki,...ij->...kj", VHr, yr) - ein("ki,...ij->...kj", VHi, yi)
        zi = ein("ki,...ij->...kj", VHr, yi) + ein("ki,...ij->...kj", VHi, yr)
        # ifft along W, real part
        out = ein("...ij,kj->...ik", zr, VWr) - ein("...ij,kj->...ik", zi, VWi)
        return out.astype(x.dtype)

    return solve
