"""Plain-XLA oracles of the semi-implicit macro-steps (no Pallas).

:func:`ch_sif_macro_reference` is the exact semantics the Cahn-Hilliard
cas kernel (:mod:`pde_opt_tpu.ops.cas_spectral`) implements, evaluated with
``jnp.fft``; :func:`ac_sif_macro_reference` is the Allen-Cahn analog.  Both
double as the backward pass of kernels that attach them with
:func:`_attach_oracle_vjp`, and as the comparison target of the tests.

Per substep (per env, ``kappa_b`` the env's own control) the CH update is

    ``y1 = y0 + dt * ifft( (lam*fft(mu(y0)) - kappa_b*lam**2*fft(y0))
                            / (1 + A*dt*kappa_b*lam**2) )``

with ``lam`` the finite-difference Laplacian symbol — the reference
semi-implicit step (``/root/reference/pde_opt/numerics/solvers.py:56-70``)
with the FD-consistent symbol.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["ch_sif_macro_reference", "ac_sif_macro_reference"]


def _fd_lap_symbols(H: int, W: int, hx: float, hy: float):
    """FD Laplacian eigenvalues per axis (roll-stencil spectrum)."""
    lam_h = (2.0 * np.cos(2.0 * np.pi * np.arange(H) / H) - 2.0) / (hx * hx)
    lam_w = (2.0 * np.cos(2.0 * np.pi * np.arange(W) / W) - 2.0) / (hy * hy)
    return lam_h, lam_w


def _attach_oracle_vjp(fast_macro, oracle_macro):
    """Register a custom VJP on a kernel macro using the XLA oracle.

    Primal = the kernel; backward = ``jax.vjp`` through the mathematically
    identical XLA/FFT oracle, which recomputes the forward under
    ``jax.checkpoint`` scan semantics.  Cotangent shapes/dtypes match the
    user's ``(state, kappa)`` since the oracle broadcasts kappa the same way
    the kernel does.
    """

    @jax.custom_vjp
    def dmacro(state, kappa):
        return fast_macro(state, kappa)

    def dmacro_fwd(state, kappa):
        return fast_macro(state, kappa), (state, kappa)

    def dmacro_bwd(res, g):
        state, kappa = res
        _, vjp = jax.vjp(oracle_macro, state, kappa)
        return vjp(g)

    dmacro.defvjp(dmacro_fwd, dmacro_bwd)
    return dmacro


def _per_env_kappa(kappa, u):
    """Scalar, (B,) or batch-shaped kappa -> (*batch, 1, 1); a kappa that
    already carries trailing singleton axes is left as given."""
    kap = jnp.asarray(kappa)
    batch = u.shape[:-2]
    if kap.ndim <= len(batch):
        kap = jnp.broadcast_to(kap, batch).reshape(batch + (1, 1))
    return kap


def ch_sif_macro_reference(mu_fn, hx, hy, A, dt, n_steps, remat=False):
    """XLA/FFT macro ``(u, kappa) -> u1`` of ``n_steps`` CH substeps.

    With ``remat=True`` the scan body is ``jax.checkpoint``-wrapped so
    reverse-mode AD stores only the carried field per substep.
    """

    def macro(u, kappa):
        H, W = u.shape[-2:]
        lam_h, lam_w = _fd_lap_symbols(H, W, hx, hy)
        lam = jnp.asarray(lam_h[:, None] + lam_w[None, :])       # (H, W)
        kap = _per_env_kappa(kappa, u)
        denom = 1.0 / (1.0 + A * dt * kap * lam**2)

        def body(uu, _):
            m_hat = jnp.fft.fftn(mu_fn(uu), axes=(-2, -1))
            u_hat = jnp.fft.fftn(uu, axes=(-2, -1))
            incr = denom * (lam * m_hat - kap * lam**2 * u_hat)
            uu = uu + dt * jnp.fft.ifftn(incr, axes=(-2, -1)).real.astype(uu.dtype)
            return uu, None

        out, _ = jax.lax.scan(
            jax.checkpoint(body) if remat else body, u, None, length=n_steps
        )
        return out

    return macro


def ac_sif_macro_reference(mu_fn, R_fn, hx, hy, A, dt, n_steps, remat=False):
    """XLA/FFT Allen-Cahn semi-implicit macro (FD-consistent symbol
    ``kappa*(-lam)``); ``remat=True`` checkpoint-wraps the scan body."""

    def macro(u, kappa):
        H, W = u.shape[-2:]
        lam_h, lam_w = _fd_lap_symbols(H, W, hx, hy)
        lam = jnp.asarray(lam_h[:, None] + lam_w[None, :])
        kap = _per_env_kappa(kappa, u)
        denom = 1.0 / (1.0 + A * dt * kap * (-lam))

        def body(uu, _):
            lap = jnp.fft.ifftn(
                lam * jnp.fft.fftn(uu, axes=(-2, -1)), axes=(-2, -1)
            ).real.astype(uu.dtype)
            g = -R_fn(uu) * (mu_fn(uu) - kap * lap)
            incr = denom * jnp.fft.fftn(g, axes=(-2, -1))
            uu = uu + dt * jnp.fft.ifftn(incr, axes=(-2, -1)).real.astype(uu.dtype)
            return uu, None

        out, _ = jax.lax.scan(
            jax.checkpoint(body) if remat else body, u, None, length=n_steps
        )
        return out

    return macro
