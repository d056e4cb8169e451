"""Plain-XLA oracle of the galvanostatic Butler-Volmer macro-step.

:func:`bv_cc_reference` advances ``n_steps`` RK4 substeps of the periodic
constant-current Butler-Volmer Allen-Cahn equation
(``AllenCahn2DPeriodicButlerVolmerConstantCurrent``; reference
``/root/reference/pde_opt/numerics/equations/allen_cahn.py:213-281``) with
the roll-stencil Laplacian and the closed-form alpha = 1/2 voltage.  It is
batched over leading axes with a per-env C-rate, and differentiable
(checkpointed scan with ``remat=True``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["bv_cc_reference"]


def bv_cc_reference(mu_fn, j0_fn, kappa, hx, hy, dt, n_steps, remat=True):
    """Roll-stencil RK4 oracle: ``macro(u, crate) -> u1`` (jnp, batched)."""
    from . import stencils as st

    cell = hx * hy

    def rhs(u, crate):
        lap = st.lap_2nd_2d(u, hx, hy)
        m = mu_fn(u) - kappa * lap
        j = j0_fn(u)
        ip = jnp.sum(j * jnp.exp(0.5 * m), axis=(-2, -1), keepdims=True) * cell
        im = jnp.sum(j * jnp.exp(-0.5 * m), axis=(-2, -1), keepdims=True) * cell
        y = (-crate + jnp.sqrt(crate**2 + 4.0 * ip * im)) / (2.0 * ip)
        em = jnp.exp(0.5 * m)
        return j * (1.0 / (em * y) - em * y)

    def macro(u, crate):
        crate = jnp.asarray(crate)
        if crate.ndim <= u.ndim - 2:
            crate = crate.reshape(crate.shape + (1, 1))

        def substep(u, _):
            k1 = rhs(u, crate)
            k2 = rhs(u + 0.5 * dt * k1, crate)
            k3 = rhs(u + 0.5 * dt * k2, crate)
            k4 = rhs(u + dt * k3, crate)
            u1 = u + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
            return u1.astype(u.dtype), None   # crate may promote (x64 mode)

        body = jax.checkpoint(substep) if remat else substep
        u, _ = jax.lax.scan(body, u, None, length=n_steps)
        return u

    return macro
