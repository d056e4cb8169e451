"""Spatial-domain decomposition: halo exchange + distributed FFT.

The PDE analog of sequence/context parallelism (SURVEY.md §5): when one
env's grid exceeds a chip, shard the *rows* of the grid across a named mesh
axis.  Finite-difference stencils then need one ring ``ppermute`` halo
exchange per evaluation; pseudo-spectral operators need a distributed FFT
(local FFT → ``all_to_all`` transpose → local FFT), the accelerator-native shape of
a 2D FFT across the interconnect.

All functions here run *inside* ``shard_map`` over a mesh axis (default
``"space"``); each takes the per-shard block with the first spatial axis
sharded.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp

__all__ = [
    "ring_perm",
    "halo_pad_rows",
    "sharded_lap_2nd_2d",
    "distributed_fft2",
    "distributed_ifft2",
    "make_sharded_sif_ch_macro",
    "sharded_lap_2nd_3d",
    "distributed_fft3",
    "distributed_ifft3",
    "make_sharded_sif_ch3d_macro",
]


def ring_perm(n: int, shift: int = 1):
    """Ring permutation [(src, dst)] for ``ppermute``."""
    return [(i, (i + shift) % n) for i in range(n)]


def halo_pad_rows(u_local, axis_name: str, halo: int = 1):
    """Pad ``halo`` rows on each side of the sharded first-spatial axis.

    One bidirectional ring ``ppermute`` per side; periodic global topology.
    ``u_local``: (..., rows_local, cols).
    """
    n = jax.lax.axis_size(axis_name)
    # My last rows become the next shard's top halo; my first rows the
    # previous shard's bottom halo.
    top_halo = jax.lax.ppermute(
        u_local[..., -halo:, :], axis_name, ring_perm(n, +1)
    )
    bottom_halo = jax.lax.ppermute(
        u_local[..., :halo, :], axis_name, ring_perm(n, -1)
    )
    return jnp.concatenate([top_halo, u_local, bottom_halo], axis=-2)


def sharded_lap_2nd_2d(u_local, hx: float, hy: float, axis_name: str = "space"):
    """2nd-order periodic Laplacian of a row-sharded 2D field.

    Matches the single-device :func:`pde_opt_jax.ops.stencils.lap_2nd_2d`
    exactly (same arithmetic; halos replace the cross-shard rolls).
    """
    up = halo_pad_rows(u_local, axis_name, halo=1)
    lap_rows = (up[..., :-2, :] - 2 * up[..., 1:-1, :] + up[..., 2:, :]) / hx**2
    lap_cols = (
        jnp.roll(u_local, 1, -1) - 2 * u_local + jnp.roll(u_local, -1, -1)
    ) / hy**2
    return lap_rows + lap_cols


def distributed_fft2(u_local, axis_name: str = "space"):
    """2D FFT of a row-sharded field via all_to_all transpose.

    Input: per-shard ``(N/P, M)`` row block of a global ``(N, M)`` field.
    Output: per-shard ``(N, M/P)`` **column block** of the global 2D FFT
    (i.e. output sharded over the last axis).  Pair with
    :func:`distributed_ifft2`, which accepts that layout and returns row
    blocks — spectral multipliers apply elementwise in the transposed layout
    (slice the symbol with ``[..., :, col_block]``).
    """
    n_dev = jax.lax.axis_size(axis_name)
    npp, m = u_local.shape[-2], u_local.shape[-1]
    a = jnp.fft.fft(u_local, axis=-1)
    a = a.reshape(*a.shape[:-1], n_dev, m // n_dev)
    # Scatter column chunks, gather row chunks: a global transpose.
    a = jax.lax.all_to_all(a, axis_name, split_axis=a.ndim - 2,
                           concat_axis=a.ndim - 3)
    a = a.reshape(*a.shape[: -3], npp * n_dev, m // n_dev)
    return jnp.fft.fft(a, axis=-2)


def make_sharded_sif_ch_macro(mu_fn: Callable, N: int, M: int,
                              hx: float, hy: float, A: float, dt: float,
                              n_steps: int, axis_name: str = "space"):
    """Semi-implicit spectral Cahn-Hilliard macro-step on a row-sharded grid.

    The spatial-decomposition counterpart of the single-chip fused kernel
    (:func:`pde_opt_jax.ops.spectral_reference.ch_sif_macro_reference`) for
    grids too large for one device: same per-substep semantics (FD Laplacian
    symbols, per-instance kappa in the implicit denominator), evaluated with
    the all-to-all distributed FFT.  Spectral multipliers apply in the
    transposed (column-block) layout, sliced per shard.

    Returns ``macro(u_local, kappa) -> u_local`` to be called INSIDE
    ``shard_map`` with the global field's rows sharded over ``axis_name``
    (``u_local``: (..., N/P, M)).
    """
    import numpy as np

    lam_n = (2.0 * np.cos(2.0 * np.pi * np.arange(N) / N) - 2.0) / (hx * hx)
    lam_m = (2.0 * np.cos(2.0 * np.pi * np.arange(M) / M) - 2.0) / (hy * hy)
    lam_full = jnp.asarray(lam_n[:, None] + lam_m[None, :])       # (N, M)

    def macro(u_local, kappa):
        P = jax.lax.axis_size(axis_name)
        i = jax.lax.axis_index(axis_name)
        mpp = M // P
        # Column block of the spectral symbols owned by this shard.
        lam = jax.lax.dynamic_slice_in_dim(lam_full, i * mpp, mpp, axis=1)
        lam2 = lam * lam
        kap = jnp.asarray(kappa)
        if kap.ndim <= u_local.ndim - 2:
            kap = kap.reshape(kap.shape + (1, 1))
        denom = 1.0 / (1.0 + A * dt * kap * lam2)

        def substep(u, _):
            m_hat = distributed_fft2(mu_fn(u), axis_name)
            u_hat = distributed_fft2(u, axis_name)
            incr = denom * (lam * m_hat - kap * lam2 * u_hat)
            u = u + dt * distributed_ifft2(incr, axis_name).real.astype(u.dtype)
            return u, None

        u_local, _ = jax.lax.scan(substep, u_local, None, length=n_steps)
        return u_local

    return macro


def distributed_ifft2(f_local, axis_name: str = "space"):
    """Inverse of :func:`distributed_fft2`: (N, M/P) column block → (N/P, M) rows."""
    n_dev = jax.lax.axis_size(axis_name)
    n, mpp = f_local.shape[-2], f_local.shape[-1]
    a = jnp.fft.ifft(f_local, axis=-2)
    # Scatter row chunks back to their owner shards, gather column chunks.
    a = a.reshape(*a.shape[:-2], n_dev, n // n_dev, mpp)
    a = jax.lax.all_to_all(a, axis_name, split_axis=a.ndim - 3,
                           concat_axis=a.ndim - 2)
    # Out layout: (*batch, n/P, n_dev, mpp) — flatten source-device-major
    # columns back into the full M axis.
    a = a.reshape(*a.shape[:-2], mpp * n_dev)
    return jnp.fft.ifft(a, axis=-1)


# ---------------------------------------------------------------------------
# 3D extensions: shard the leading spatial axis of a (..., N, M, K) field
# ---------------------------------------------------------------------------

def sharded_lap_2nd_3d(u_local, hx: float, hy: float, hz: float,
                       axis_name: str = "space"):
    """2nd-order periodic 3D Laplacian of a first-spatial-axis-sharded field.

    Matches the single-device :func:`pde_opt_jax.ops.stencils.lap_2nd_3d`
    exactly; the sharded axis uses one ring-``ppermute`` halo exchange,
    the two local axes use rolls.  ``u_local``: (..., N/P, M, K).
    """
    up = halo_pad_rows(u_local.reshape(*u_local.shape[:-2], -1), axis_name,
                       halo=1).reshape(*u_local.shape[:-3],
                                       u_local.shape[-3] + 2,
                                       *u_local.shape[-2:])
    lap_x = (up[..., :-2, :, :] - 2 * up[..., 1:-1, :, :]
             + up[..., 2:, :, :]) / hx**2
    lap_y = (jnp.roll(u_local, 1, -2) - 2 * u_local
             + jnp.roll(u_local, -1, -2)) / hy**2
    lap_z = (jnp.roll(u_local, 1, -1) - 2 * u_local
             + jnp.roll(u_local, -1, -1)) / hz**2
    return lap_x + lap_y + lap_z


def distributed_fft3(u_local, axis_name: str = "space"):
    """3D FFT of a first-axis-sharded field via one all_to_all transpose.

    Input: per-shard ``(N/P, M, K)`` block of a global ``(N, M, K)`` field.
    The two local trailing axes transform with on-device FFTs; the sharded
    leading axis transforms after an all_to_all that trades M-chunks for
    the full N extent.  Output: per-shard ``(N, M/P, K)`` block (sharded
    over the SECOND axis) of the global 3D FFT — pair with
    :func:`distributed_ifft3`.  Spectral multipliers apply elementwise in
    that layout (slice the symbol with ``[:, m_block, :]``).
    """
    n_dev = jax.lax.axis_size(axis_name)
    npp, m, k = u_local.shape[-3], u_local.shape[-2], u_local.shape[-1]
    a = jnp.fft.fftn(u_local, axes=(-2, -1))
    a = a.reshape(*a.shape[:-3], npp, n_dev, m // n_dev, k)
    a = jax.lax.all_to_all(a, axis_name, split_axis=a.ndim - 3,
                           concat_axis=a.ndim - 4)
    a = a.reshape(*a.shape[:-4], npp * n_dev, m // n_dev, k)
    return jnp.fft.fft(a, axis=-3)


def distributed_ifft3(f_local, axis_name: str = "space"):
    """Inverse of :func:`distributed_fft3`: (N, M/P, K) → (N/P, M, K)."""
    n_dev = jax.lax.axis_size(axis_name)
    n, mpp, k = f_local.shape[-3], f_local.shape[-2], f_local.shape[-1]
    a = jnp.fft.ifft(f_local, axis=-3)
    a = a.reshape(*a.shape[:-3], n_dev, n // n_dev, mpp, k)
    # Out layout: (*batch, n/P, n_dev, mpp, k) — flatten source-device-major
    # columns back into the full M axis (same transpose as distributed_ifft2).
    a = jax.lax.all_to_all(a, axis_name, split_axis=a.ndim - 4,
                           concat_axis=a.ndim - 3)
    a = a.reshape(*a.shape[:-3], mpp * n_dev, k)
    return jnp.fft.ifftn(a, axes=(-2, -1))


def make_sharded_sif_ch3d_macro(mu_fn: Callable, N: int, M: int, K: int,
                                hx: float, hy: float, hz: float,
                                A: float, dt: float, n_steps: int,
                                axis_name: str = "space"):
    """Semi-implicit spectral 3D Cahn-Hilliard macro on a sharded grid.

    3D counterpart of :func:`make_sharded_sif_ch_macro` for volumes beyond
    one device (e.g. 256³ at f32 is 64 MB/field + spectra — several such
    buffers strain device-memory working sets at batch): the first
    spatial axis is sharded over ``axis_name`` and every substep evaluates
    the same FD-symbol semi-implicit update with the all_to_all
    distributed 3D FFT.  Call INSIDE ``shard_map``; ``u_local``:
    (..., N/P, M, K).
    """
    import numpy as np

    lam_n = (2.0 * np.cos(2.0 * np.pi * np.arange(N) / N) - 2.0) / (hx * hx)
    lam_m = (2.0 * np.cos(2.0 * np.pi * np.arange(M) / M) - 2.0) / (hy * hy)
    lam_k = (2.0 * np.cos(2.0 * np.pi * np.arange(K) / K) - 2.0) / (hz * hz)
    lam_full = jnp.asarray(
        lam_n[:, None, None] + lam_m[None, :, None] + lam_k[None, None, :]
    )                                                            # (N, M, K)

    def macro(u_local, kappa):
        P = jax.lax.axis_size(axis_name)
        i = jax.lax.axis_index(axis_name)
        mpp = M // P
        # Spectral symbols in the transposed (second-axis-sharded) layout.
        lam = jax.lax.dynamic_slice_in_dim(lam_full, i * mpp, mpp, axis=1)
        lam2 = lam * lam
        kap = jnp.asarray(kappa)
        if kap.ndim <= u_local.ndim - 3:
            kap = kap.reshape(kap.shape + (1, 1, 1))
        denom = 1.0 / (1.0 + A * dt * kap * lam2)

        def substep(u, _):
            m_hat = distributed_fft3(mu_fn(u), axis_name)
            u_hat = distributed_fft3(u, axis_name)
            incr = denom * (lam * m_hat - kap * lam2 * u_hat)
            u = u + dt * distributed_ifft3(incr, axis_name).real.astype(u.dtype)
            return u, None

        u_local, _ = jax.lax.scan(substep, u_local, None, length=n_steps)
        return u_local

    return macro
