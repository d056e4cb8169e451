"""Matmul ADI macro for the rotating-frame GPE.

The rotating-frame directional split (:class:`~pde_opt_jax.ops.steppers.DirectionalSplitting`,
scheme: Bao & Cai, arXiv:1212.5341 §4) spends its time in eight 1D FFTs per
substep.  But each
ADI sweep is a *fixed linear operator per grid line*: the x-sweep applies
``F⁻¹ · diag(exp(½δt·A_x(k_x, y))) · F`` to every column ``y``, and the
mixed-basis symbol ``A_x`` (kinetic + −Ω·L_z coupling of ``k_x`` with
``y``) depends only on static trap/rotation constants.  So the whole sweep
is precomputed into a per-line dense propagator tensor ``M[g, h, y]``
(size H·H·W complex — 2 MB at 64²) and applied as ONE batched matmul
contraction over the fleet: 4 real matmuls per sweep instead of a
forward+inverse FFT pair.

The macro also merges the Strang chain across substeps
(``(Sx Sy B Sy Sx)ⁿ = Sx Sy [B Sy Sx² Sy]ⁿ⁻¹ B Sy Sx``): 3 sweeps per
inner substep instead of 4.  Per-step L² renormalization (imaginary time)
commutes with the linear sweeps, so applying it right after ``B``
reproduces the reference ordering exactly.

The nonlinear ``B`` phase stays pointwise.  State is carried as a real
(re, im) pair — no complex scan carries, and all host-side setup is real
numpy.

Semantics match :class:`DirectionalSplitting` step-for-step in exact
arithmetic (gated by ``tests/test_gpe_rot_fast.py``); bench ``gpe_rot``
times it against the FFT ADI path.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["make_rot_adi_macro", "build_sweep_tensors"]


def _dft(N: int) -> np.ndarray:
    """Forward DFT matrix with jnp.fft.fft conventions: X_k = Σ_x e^{-2πikx/N} ψ_x."""
    x = np.arange(N)
    return np.exp(-2j * np.pi * np.outer(x, x) / N)


def build_sweep_tensors(Ax, Ay, dt_c):
    """Per-line ADI propagators for both axes at phase ``exp(dt_c · A)``.

    Args:
        Ax: (H, W) complex symbol of the x-sweep — row index is k_x,
            column index is the y grid line (mixed basis).
        Ay: (H, W) complex symbol of the y-sweep — column index is k_y,
            row index is the x grid line.
        dt_c: complex step (δt·time_scale, with the half/full factor
            already applied).

    Returns ``(Mx, My)``: ``Mx[g, h, y] = [F⁻¹ diag(e^{dt_c·Ax[:,y]}) F]_{gh}``
    (shape (H, H, W)) and ``My[g, w, x] = [F⁻¹ diag(e^{dt_c·Ay[x,:]}) F]_{gw}``
    (shape (W, W, H)), as (real, imag) float32 pairs.
    """
    Ax = np.asarray(Ax)
    Ay = np.asarray(Ay)
    H, W = Ax.shape
    Fh, Fw = _dft(H), _dft(W)
    iFh, iFw = np.conj(Fh) / H, np.conj(Fw) / W
    Ex = np.exp(dt_c * Ax)                       # (H_k, W_y)
    Ey = np.exp(dt_c * Ay)                       # (H_x, W_k)
    Mx = np.einsum("gk,ky,kh->ghy", iFh, Ex, Fh)
    My = np.einsum("gk,xk,kw->gwx", iFw, Ey, Fw)
    return ((np.float32(Mx.real), np.float32(Mx.imag)),
            (np.float32(My.real), np.float32(My.imag)))


def make_rot_adi_macro(
    A_terms: Callable,
    B_terms: Callable,
    dx: float,
    H: int,
    W: int,
    dt: float,
    n_steps: int,
    *,
    time_scale=1.0,
    normalize: Optional[bool] = None,
    mats_dtype=jnp.float32,
    phase_poly: bool = True,
):
    """Build ``macro(psi, t0) -> psi1`` advancing ``n_steps`` ADI substeps.

    ``A_terms(None, t)`` must be concrete at build time (static rotation /
    trap constants — evaluated under ``jax.ensure_compile_time_eval``);
    ``B_terms(psi, t)`` may close over traced per-env controls (pointwise).
    ``psi``: complex array (..., H, W), batch axes leading.  ``normalize``
    defaults to on for imaginary ``time_scale`` (ground-state search),
    exactly as :class:`~pde_opt_jax.ops.steppers.DirectionalSplitting`.

    ``phase_poly``: evaluate the pointwise B-phase ``exp(z)`` (``z =
    B_terms·δt·time_scale``, split into ``e^{Re z}·(cos Im z + i sin Im z)``)
    with degree-7 Taylor polynomials instead of hardware exp/cos/sin —
    the same trade as :func:`pde_opt_jax.ops.gpe_cas.make_gpe_strang_cas_macro`:
    the splitting itself needs ``|z| << 1`` per substep, and on that domain
    the truncation error (``~|z|^8/8!``) is below f32 resolution for
    ``|z| <= ~0.35`` and ~1e-6 at 0.7.  No runtime guard: callers whose
    per-substep phase can exceed ~0.7 must pass ``phase_poly=False``.
    """
    if normalize is None:
        normalize = complex(time_scale).imag != 0.0
    dt_c = complex(time_scale) * float(dt)

    # The symbols are build-time constants: evaluate them on the HOST CPU
    # backend (ensure_compile_time_eval alone would still execute them on
    # the default device).
    with jax.ensure_compile_time_eval():
        with jax.default_device(jax.local_devices(backend="cpu")[0]):
            Ax, Ay = A_terms(None, 0.0)
            Ax = np.asarray(Ax)
            Ay = np.asarray(Ay)
    (Mxh_r, Mxh_i), (Myh_r, Myh_i) = build_sweep_tensors(Ax, Ay, 0.5 * dt_c)
    (Mxf_r, Mxf_i), _ = build_sweep_tensors(Ax, Ay, dt_c)

    mats = mats_dtype
    prec = jax.lax.Precision.HIGHEST if mats == jnp.float32 else None

    def _pack_complex(Mr, Mi):
        """(K, K, L) complex pair -> (2K, 2K, L) real block
        ``[[Mr, -Mi], [Mi, Mr]]`` per line: ONE matmul of DOUBLE
        contraction depth replaces the 4-matmul complex product."""
        top = np.concatenate([Mr, -Mi], axis=1)
        bot = np.concatenate([Mi, Mr], axis=1)
        return jnp.asarray(np.concatenate([top, bot], axis=0), mats)

    Mxh = _pack_complex(Mxh_r, Mxh_i)
    Myh = _pack_complex(Myh_r, Myh_i)
    Mxf = _pack_complex(Mxf_r, Mxf_i)

    def _ein(eq, M, z):
        return jnp.einsum(eq, M, z.astype(mats),
                          preferred_element_type=jnp.float32,
                          precision=prec)

    def sweep_x(M, pr, pi):
        z = jnp.concatenate([pr, pi], axis=-2)          # (B, 2H, W)
        o = _ein("ghy,bhy->bgy", M, z)
        return o[:, :H], o[:, H:]

    def sweep_y(M, pr, pi):
        z = jnp.concatenate([pr, pi], axis=-1)          # (B, H, 2W)
        o = _ein("gwx,bxw->bxg", M, z)
        return o[..., :W], o[..., W:]

    dx2 = float(dx) ** 2

    def b_apply(pr, pi, t):
        psi = pr + 1j * pi
        z = B_terms(psi, t) * dt_c
        zr, zi = jnp.real(z), jnp.imag(z)
        if phase_poly:
            # exp(z) = e^{zr}·(cos zi + i·sin zi) as degree-7 Taylor
            # polynomials (pure FMA chains) instead of the hardware
            # exp/cos/sin transcendentals.
            er = 1.0 + zr * (1.0 + zr * (0.5 + zr * (
                1.0 / 6.0 + zr * (1.0 / 24.0 + zr * (
                    1.0 / 120.0 + zr * (1.0 / 720.0 + zr / 5040.0))))))
            t2 = zi * zi
            c = 1.0 + t2 * (-0.5 + t2 * (1.0 / 24.0 + t2 * (-1.0 / 720.0)))
            s = zi * (1.0 + t2 * (-1.0 / 6.0 + t2 * (
                1.0 / 120.0 + t2 * (-1.0 / 5040.0))))
        else:
            er = jnp.exp(zr)
            c = jnp.cos(zi)
            s = jnp.sin(zi)
        pr, pi = er * (pr * c - pi * s), er * (pr * s + pi * c)
        if normalize:
            norm = jax.lax.rsqrt(
                jnp.sum(pr * pr + pi * pi, axis=(-2, -1), keepdims=True)
                * dx2
            )
            pr, pi = pr * norm, pi * norm
        return pr, pi

    def macro(psi, t0=0.0):
        *batch, a, b = psi.shape
        if (a, b) != (H, W):
            raise ValueError(f"state trailing shape {(a, b)} != {(H, W)}")
        B = math.prod(batch) if batch else 1
        pr = jnp.real(psi).reshape(B, H, W).astype(jnp.float32)
        pi = jnp.imag(psi).reshape(B, H, W).astype(jnp.float32)

        pr, pi = sweep_x(Mxh, pr, pi)
        pr, pi = sweep_y(Myh, pr, pi)

        def inner(carry, i):
            pr, pi = carry
            t = t0 + i * dt
            pr, pi = b_apply(pr, pi, t)
            pr, pi = sweep_y(Myh, pr, pi)
            pr, pi = sweep_x(Mxf, pr, pi)
            pr, pi = sweep_y(Myh, pr, pi)
            return (pr, pi), None

        if n_steps > 1:
            (pr, pi), _ = jax.lax.scan(
                inner, (pr, pi), jnp.arange(n_steps - 1, dtype=jnp.float32)
            )
        pr, pi = b_apply(pr, pi, t0 + (n_steps - 1) * dt)
        pr, pi = sweep_y(Myh, pr, pi)
        pr, pi = sweep_x(Mxh, pr, pi)
        out = (pr + 1j * pi).reshape(*batch, H, W)
        return out.astype(psi.dtype)

    return macro
