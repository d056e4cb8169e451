"""General-mobility Cahn-Hilliard semi-implicit macro on cas-transform matmuls.

Closes the fast-path gap for concentration-dependent mobility ``D(c) != 1``
(the reference's 3D training workload — Legendre diffusivity + chemical
potential, ``/root/reference/docs/notebooks/optimization_3D.ipynb`` cell 4,
``numerics/equations/cahn_hilliard.py:89-109``): every previously fused CH
macro in this repo requires unit mobility, so that workload fell back to
the ~30x slower XLA-rfft SIF path.

The scheme is the reference's stabilized semi-implicit update
(``/root/reference/pde_opt/numerics/solvers.py:56-70``) with the
FD-consistent symbol:

    rhs   = div( D_face(c) · grad(mu(c) − κ ∇²c) )      (conservative
            face-flux roll stencils — exactly ``rhs_fd`` of the CH models)
    u    += dt · C⁻¹[ C[rhs] / (1 + A·dt·κ·s·λ²) ]      (cas transform)

where λ is the FD Laplacian symbol and ``s`` (``stab_scale``) optionally
over-relaxes the implicit shift for stiff mobilities (D ≫ 1).  The rhs is
nonlinear and non-diagonal (no spectrum can be carried), but it is pure
elementwise roll arithmetic, which XLA fuses; the only matmul work is ONE
forward and ONE inverse cas transform per substep (4 matmuls in 2D, 6 in
3D), with no FFT.  The matmul operands are bf16 with f32 accumulation by
default (``mats_dtype``) — a precision choice; ``jnp.float32`` is exact.

Everything is plain XLA (`lax.scan` over substeps, einsum contractions),
so the macro is **natively differentiable** w.r.t. the field, ``kappa``,
and any parameters closed over by ``mu_fn``/``D_fn`` (the
learnable-function training path) — no custom VJP needed.

With ``D ≡ 1`` the update is algebraically identical to the unit-mobility
scheme (circular convolution: ``C[lap_roll(z)] = λ·C[z]`` exactly), which
the tests use as a cross-oracle.
"""

from __future__ import annotations

import math
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from . import stencils as st

__all__ = [
    "make_ch_mobility_cas_macro",
    "make_ch3d_mobility_cas_macro",
    "ch_mobility_macro_reference",
    "ch3d_mobility_macro_reference",
]


def _cas_mat(N: int) -> np.ndarray:
    x = np.arange(N)
    ang = 2.0 * np.pi * np.outer(x, x) / N
    return np.cos(ang) + np.sin(ang)


def _fd_lap_symbol(N: int, h: float) -> np.ndarray:
    return (2.0 * np.cos(2.0 * np.pi * np.arange(N) / N) - 2.0) / (h * h)


def _flux_div_rhs(mu_fn, D_fn, kap, dxs, axes):
    """Conservative FD rhs ``div(D_face · grad(mu − κ·lap u))`` (batched).

    Mirrors ``CahnHilliard{2D,3D}Periodic.rhs_fd`` with a per-env ``kap``
    broadcast over the spatial axes.
    """

    def rhs(u):
        lap = 0.0
        for h, ax in zip(dxs, axes):
            lap = lap + st.grad2_c(u, h, ax)
        mu_tot = mu_fn(u) - kap * lap
        Du = D_fn(u)
        out = 0.0
        for h, ax in zip(dxs, axes):
            F = st.avg_c2f(Du, ax) * st.grad_c2f(mu_tot, h, ax)
            out = out + st.div_f2c(F, h, ax)
        return out

    return rhs


def make_ch_mobility_cas_macro(
    mu_fn: Callable,
    D_fn: Callable,
    H: int,
    W: int,
    hx: float,
    hy: float,
    A: float,
    dt: float,
    n_steps: int,
    *,
    stab_scale: float = 1.0,
    mats_dtype=jnp.bfloat16,
):
    """Build ``macro(u, kappa) -> u1``: 2D general-mobility CH substeps.

    ``u``: (..., H, W) real field (leading axes batch); ``kappa``
    broadcastable to the batch; ``mu_fn``/``D_fn`` elementwise callables
    (may close over learnable parameters — gradients flow natively).
    ``stab_scale``: multiplies the implicit κλ² shift (set ≈ max D for
    stiff mobilities).  ``mats_dtype=jnp.float32`` forces exact arithmetic
    for tests.
    """
    C1 = _cas_mat(H)
    C2 = _cas_mat(W)
    lam = (_fd_lap_symbol(H, hx)[:, None]
           + _fd_lap_symbol(W, hy)[None, :])
    lam2_j = jnp.asarray(lam, jnp.float32) ** 2
    mats = mats_dtype
    prec = jax.lax.Precision.HIGHEST if mats == jnp.float32 else None
    A_dt = float(A) * float(dt) * float(stab_scale)
    dt_f = float(dt)

    F1 = jnp.asarray(C1, mats)
    F2 = jnp.asarray(C2, mats)
    I1 = jnp.asarray(C1 / H, mats)
    I2 = jnp.asarray(C2 / W, mats)

    def _apply(z, M1, M2):
        z = jnp.einsum("...ab,ad->...db", z.astype(mats), M1,
                       preferred_element_type=jnp.float32, precision=prec)
        return jnp.einsum("...ab,be->...ae", z.astype(mats), M2,
                          preferred_element_type=jnp.float32, precision=prec)

    def macro(state, kappa):
        *batch, a, b = state.shape
        if (a, b) != (H, W):
            raise ValueError(f"state trailing shape {(a, b)} != {(H, W)}")
        B = math.prod(batch) if batch else 1
        u = state.reshape(B, H, W).astype(jnp.float32)
        kap = jnp.asarray(kappa, jnp.float32)
        kap = (jnp.broadcast_to(kap, (B,)) if kap.ndim <= 1
               else kap.reshape(B)).reshape(B, 1, 1)
        denom_dt = dt_f / (1.0 + A_dt * (kap * lam2_j[None]))
        rhs = _flux_div_rhs(mu_fn, D_fn, kap, (hx, hy), (-2, -1))

        def body(uu, _):
            incr = _apply(denom_dt * _apply(rhs(uu), F1, F2), I1, I2)
            return uu + incr, None

        u1, _ = jax.lax.scan(body, u, None, length=n_steps)
        return u1.astype(state.dtype).reshape(*batch, H, W)

    return macro


def make_ch3d_mobility_cas_macro(
    mu_fn: Callable,
    D_fn: Callable,
    N1: int,
    N2: int,
    N3: int,
    h1: float,
    h2: float,
    h3: float,
    A: float,
    dt: float,
    n_steps: int,
    *,
    stab_scale: float = 1.0,
    mats_dtype=jnp.bfloat16,
):
    """3D analog of :func:`make_ch_mobility_cas_macro` (6 matmuls/substep)."""
    C1, C2, C3 = _cas_mat(N1), _cas_mat(N2), _cas_mat(N3)
    lam = (
        _fd_lap_symbol(N1, h1)[:, None, None]
        + _fd_lap_symbol(N2, h2)[None, :, None]
        + _fd_lap_symbol(N3, h3)[None, None, :]
    )
    lam2_j = jnp.asarray(lam, jnp.float32) ** 2
    mats = mats_dtype
    prec = jax.lax.Precision.HIGHEST if mats == jnp.float32 else None
    A_dt = float(A) * float(dt) * float(stab_scale)
    dt_f = float(dt)

    F = [jnp.asarray(c, mats) for c in (C1, C2, C3)]
    I = [jnp.asarray(c / n, mats)
         for c, n in ((C1, N1), (C2, N2), (C3, N3))]

    def _apply(z, M1, M2, M3):
        z = jnp.einsum("...abc,ad->...dbc", z.astype(mats), M1,
                       preferred_element_type=jnp.float32, precision=prec)
        z = jnp.einsum("...abc,be->...aec", z.astype(mats), M2,
                       preferred_element_type=jnp.float32, precision=prec)
        return jnp.einsum("...abc,cf->...abf", z.astype(mats), M3,
                          preferred_element_type=jnp.float32, precision=prec)

    def macro(state, kappa):
        *batch, a, b, c = state.shape
        if (a, b, c) != (N1, N2, N3):
            raise ValueError(
                f"state trailing shape {(a, b, c)} != {(N1, N2, N3)}"
            )
        B = math.prod(batch) if batch else 1
        u = state.reshape(B, N1, N2, N3).astype(jnp.float32)
        kap = jnp.asarray(kappa, jnp.float32)
        kap = (jnp.broadcast_to(kap, (B,)) if kap.ndim <= 1
               else kap.reshape(B)).reshape(B, 1, 1, 1)
        denom_dt = dt_f / (1.0 + A_dt * (kap * lam2_j[None]))
        rhs = _flux_div_rhs(mu_fn, D_fn, kap, (h1, h2, h3), (-3, -2, -1))

        def body(uu, _):
            incr = _apply(denom_dt * _apply(rhs(uu), *F), *I)
            return uu + incr, None

        u1, _ = jax.lax.scan(body, u, None, length=n_steps)
        return u1.astype(state.dtype).reshape(*batch, N1, N2, N3)

    return macro


def _fft_reference(mu_fn, D_fn, dxs, A, dt, n_steps, stab_scale, ndim):
    """jnp.fft oracle with identical exact-arithmetic semantics (tests)."""
    axes = tuple(range(-ndim, 0))

    def macro(u, kappa):
        Ns = u.shape[-ndim:]
        lam = 0.0
        for i, (n, h) in enumerate(zip(Ns, dxs)):
            shape = [1] * ndim
            shape[i] = n
            lam = lam + jnp.asarray(_fd_lap_symbol(n, h)).reshape(shape)
        kap = jnp.asarray(kappa)
        if kap.ndim <= 1:
            kap = jnp.broadcast_to(kap, u.shape[:-ndim]).reshape(
                u.shape[:-ndim] + (1,) * ndim
            )
        denom = 1.0 / (1.0 + A * dt * stab_scale * kap * lam**2)
        rhs = _flux_div_rhs(mu_fn, D_fn, kap, dxs, axes)

        def body(uu, _):
            incr = denom * jnp.fft.fftn(rhs(uu), axes=axes)
            uu = uu + dt * jnp.fft.ifftn(incr, axes=axes).real.astype(uu.dtype)
            return uu, None

        out, _ = jax.lax.scan(body, u, None, length=n_steps)
        return out

    return macro


def ch_mobility_macro_reference(mu_fn, D_fn, hx, hy, A, dt, n_steps,
                                stab_scale: float = 1.0):
    return _fft_reference(mu_fn, D_fn, (hx, hy), A, dt, n_steps,
                          stab_scale, 2)


def ch3d_mobility_macro_reference(mu_fn, D_fn, h1, h2, h3, A, dt, n_steps,
                                  stab_scale: float = 1.0):
    return _fft_reference(mu_fn, D_fn, (h1, h2, h3), A, dt, n_steps,
                          stab_scale, 3)
