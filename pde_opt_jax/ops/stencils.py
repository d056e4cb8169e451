"""Periodic finite-difference stencils, batch-transparent on trailing axes.

Counterpart of the reference roll-stencil library
(``/root/reference/pde_opt/numerics/utils/derivatives.py:8-106``).  Two
deliberate departures from the reference:

1. **Trailing-axis convention.** The reference indexes spatial axes 0/1(/2),
   which pins every kernel to unbatched fields.  Here spatial axes are the
   *last* ``ndim`` axes (x = axis ``-ndim``), so the same stencil evaluates a
   single ``(H, W)`` field or a ``(4096, H, W)`` fleet of env states with one
   fused XLA kernel — the batch axis rides along for free, no ``vmap``
   retrace, and XLA tiles the batch across the device.

2. **Pure free functions with explicit axis arguments** so the same code
   serves 1D/2D/3D and arbitrary batch shapes.

``jnp.roll`` with static shift is a cheap shifted read, and XLA fuses chains
of them with the surrounding arithmetic into one loop, so these stencils
are memory-bound at speed-of-light for their access pattern.
"""

from __future__ import annotations

import jax.numpy as jnp

__all__ = [
    "shift",
    "grad_c2f", "avg_c2f", "div_f2c", "grad_c", "grad2_c", "grad2_cross_c",
    "laplacian",
    "lap_2nd_2d", "lap_2nd_3d",
    "gradx_c2f", "grady_c2f", "gradz_c2f",
    "avgx_c2f", "avgy_c2f", "avgz_c2f",
    "divx_f2c", "divy_f2c", "divz_f2c",
    "gradx_c", "grady_c", "gradz_c",
    "grad2x_c", "grad2y_c", "grad2z_c", "grad2xy_c",
]


def shift(u, amount: int, axis: int):
    """Periodic shift: ``shift(u, +1, ax)[i] = u[i+1]`` along ``axis``."""
    return jnp.roll(u, -amount, axis)


# ---- generic axis-parameterized stencils (2nd order, periodic) ----------

def grad_c2f(a, h, axis: int):
    """Center→face forward difference: value at face ``i+1/2``."""
    return (jnp.roll(a, -1, axis) - a) / h


def avg_c2f(a, axis: int):
    """Linear interpolation of cell centers to faces ``i+1/2``."""
    return 0.5 * (a + jnp.roll(a, -1, axis))


def div_f2c(F, h, axis: int):
    """Face→center backward difference (adjoint of :func:`grad_c2f`)."""
    return (F - jnp.roll(F, 1, axis)) / h


def grad_c(a, h, axis: int):
    """Centered first derivative at cell centers."""
    return 0.5 * (jnp.roll(a, -1, axis) - jnp.roll(a, 1, axis)) / h


def grad2_c(a, h, axis: int):
    """Centered second derivative at cell centers."""
    return (jnp.roll(a, -1, axis) - 2 * a + jnp.roll(a, 1, axis)) / (h * h)


def grad2_cross_c(a, hx, hy, axis_x: int, axis_y: int):
    """Centered mixed second derivative ∂²/∂x∂y at cell centers."""
    return (
        jnp.roll(jnp.roll(a, -1, axis_x), -1, axis_y)
        + jnp.roll(jnp.roll(a, 1, axis_x), 1, axis_y)
        - jnp.roll(jnp.roll(a, -1, axis_x), 1, axis_y)
        - jnp.roll(jnp.roll(a, 1, axis_x), -1, axis_y)
    ) / (4.0 * hx * hy)


def laplacian(u, dx, ndim: int | None = None):
    """2nd-order periodic Laplacian over the trailing ``ndim`` axes.

    Args:
        u: field with spatial axes trailing (any number of leading batch axes).
        dx: per-dimension spacings, length ``ndim``.
        ndim: number of spatial dimensions; defaults to ``len(dx)``.
    """
    if ndim is None:
        ndim = len(dx)
    out = 0.0
    for d in range(ndim):
        axis = d - ndim  # -ndim .. -1
        out = out + grad2_c(u, dx[d], axis)
    return out


# ---- reference-named 2D/3D aliases (trailing-axis semantics) ------------
# x = axis -ndim (first spatial), y = next, z = last. Cited lines are the
# reference stencils these reproduce (derivatives.py:8-106).

def lap_2nd_2d(u, hx, hy):
    return grad2_c(u, hx, -2) + grad2_c(u, hy, -1)


def lap_2nd_3d(u, hx, hy, hz):
    return grad2_c(u, hx, -3) + grad2_c(u, hy, -2) + grad2_c(u, hz, -1)


def gradx_c2f(a, hx, ndim: int = 2):
    return grad_c2f(a, hx, -ndim)


def grady_c2f(a, hy, ndim: int = 2):
    return grad_c2f(a, hy, -ndim + 1)


def gradz_c2f(a, hz):
    return grad_c2f(a, hz, -1)


def avgx_c2f(a, ndim: int = 2):
    return avg_c2f(a, -ndim)


def avgy_c2f(a, ndim: int = 2):
    return avg_c2f(a, -ndim + 1)


def avgz_c2f(a):
    return avg_c2f(a, -1)


def divx_f2c(F, hx, ndim: int = 2):
    return div_f2c(F, hx, -ndim)


def divy_f2c(F, hy, ndim: int = 2):
    return div_f2c(F, hy, -ndim + 1)


def divz_f2c(F, hz):
    return div_f2c(F, hz, -1)


def gradx_c(a, hx, ndim: int = 2):
    return grad_c(a, hx, -ndim)


def grady_c(a, hy, ndim: int = 2):
    return grad_c(a, hy, -ndim + 1)


def gradz_c(a, hz):
    return grad_c(a, hz, -1)


def grad2x_c(a, hx, ndim: int = 2):
    return grad2_c(a, hx, -ndim)


def grad2y_c(a, hy, ndim: int = 2):
    return grad2_c(a, hy, -ndim + 1)


def grad2z_c(a, hz):
    return grad2_c(a, hz, -1)


def grad2xy_c(a, hx, hy, ndim: int = 2):
    return grad2_cross_c(a, hx, hy, -ndim, -ndim + 1)
