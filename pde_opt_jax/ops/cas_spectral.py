"""Hartley-transform (cas) Cahn-Hilliard macro-step kernel (Pallas, Triton).

Every multiplier in the semi-implicit Cahn-Hilliard update — the FD
Laplacian symbol ``lam``, ``lam**2`` and the per-env implicit denominator
``1/(1 + A*dt*kappa*lam**2)`` — is **even in each frequency axis**
(``lam(N-k) == lam(k)``).  The separable discrete Hartley (cas) transform,
``C[x,k] = cos(2*pi*x*k/N) + sin(2*pi*x*k/N)`` applied along each axis,
diagonalizes circular convolutions with axis-even symbols exactly like the
DFT, while being a *real, symmetric, self-inverse* map: ``C @ C = N*I``.
So a substep needs no complex arithmetic:

    per substep (per env; kappa_b is the env's own traced control):
        m~    = C mu(u) C                              (2 matmuls)
        incr~ = (dt*lam * m~ - dt*kappa_b*lam^2 * u~)
                / (1 + A*dt*kappa_b*lam^2)
        u~   += incr~
        u    += C incr~ C / (H*W)                      (2 matmuls)

— in exact arithmetic identical to
:func:`pde_opt_jax.ops.spectral_reference.ch_sif_macro_reference`.  Since
the update is linear in the spectrum, ``u~`` is carried across substeps.

Hopper layout: one program per env.  The grid runs over the fleet (4096
programs cover the card's 132 SMs many times over); each program loads its
``(H, W)`` field and the cas matrices once, runs all substeps in a
``fori_loop`` with ``u`` and ``u~`` held on chip, and does each of the two
matrix products of a transform as three bf16 tensor-core dots with f32
accumulation (operands split into a bf16 head and tail), on deviations
from the field's mean: f32-level accuracy at bf16 tensor-core rates.  The
field crosses device memory twice per macro-step (read, write) instead of
several times per substep.  Triton needs power-of-two tiles of at least
16, and a 128-wide f32 field no longer fits a program's registers, so the
grid must be 16, 32 or 64 along each axis; other grids raise and point to
``spectral_solve="fft"``.

With ``epilogue`` the same kernel also emits, before its single store, the
env step's per-env statistics and uint8 observation (see
:func:`make_ch_cas_fused_macro`).

Differentiable: the custom VJP's backward pass is the VJP of the XLA oracle
(checkpointed scan), so training gradients are exact for the macro's
semantics.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .kernel_backend import pallas_interpret
from .spectral_reference import (
    _attach_oracle_vjp,
    _fd_lap_symbols,
    ch_sif_macro_reference,
)

__all__ = ["make_ch_cas_fused_macro", "SUPPORTED_GRIDS"]

# Grid sizes (per axis) the kernel takes: power-of-two Triton tiles, >= 16
# for the tensor-core dot, <= 64 so u and u~ stay in registers.
SUPPORTED_GRIDS = (16, 32, 64)
# Warps per program: 4 measured 2.5x faster than 8 at 4096x64² on an H100
# (8 spills the per-program tiles); pipeline stages do not matter here.
_NUM_WARPS = 4


def _cas_mat(N: int) -> np.ndarray:
    """Symmetric cas (Hartley) matrix: C @ C = N * I."""
    x = np.arange(N)
    ang = 2.0 * np.pi * np.outer(x, x) / N
    return np.cos(ang) + np.sin(ang)


def _pool_mat(N: int, ds: int) -> np.ndarray:
    """(N, N//ds) mean-pooling matrix: ``P.T @ u @ P`` pools ds x ds."""
    P = np.zeros((N, N // ds), np.float32)
    P[np.arange(N), np.arange(N) // ds] = 1.0 / ds
    return P


def _fold_stats_cotangent(u1, gu, gstats, center):
    """Fold the stats cotangent into the field cotangent at the final
    field (s1 = sum(uz), s2 = sum(uz^2), uz = NaN-masked centered field;
    the finite count has zero gradient a.e.)."""
    fin = jnp.isfinite(u1)
    uz = jnp.where(fin, u1 - center, jnp.zeros_like(u1))
    return gu + jnp.where(
        fin,
        gstats[..., 0][..., None, None]
        + 2.0 * uz * gstats[..., 1][..., None, None],
        jnp.zeros_like(u1),
    ).astype(gu.dtype)


def make_ch_cas_fused_macro(
    mu_fn: Callable,
    H: int,
    W: int,
    hx: float,
    hy: float,
    A: float,
    dt: float,
    n_steps: int,
    *,
    mats_dtype=jnp.bfloat16,
    epilogue: Optional[dict] = None,
):
    """Build ``macro(u, kappa) -> u1`` advancing ``n_steps`` substeps.

    Args:
        mu_fn: elementwise homogeneous chemical potential (e.g. ``c**3 - c``).
        H, W: grid shape (trailing axes of ``u``); each in
            :data:`SUPPORTED_GRIDS`.
        hx, hy: grid spacings for axes -2/-1.
        A: implicit splitting constant (1.0 = deadbeat high-k noise damping).
        dt: substep size (static).
        n_steps: substeps per macro-step (static).
        mats_dtype: matmul operand dtype.  bf16 (default) splits each
            operand into a bf16 head and tail and sums three f32-accumulated
            products (head*head + head*tail + tail*head): relative error
            ~2**-16 per transform.  One bf16 product alone (~2**-9) puts
            noise above the flagship's variance reward right after reset.
            f32 runs exact IEEE products (for testing).
        epilogue: optional env-epilogue config with keys ``obs_scale``,
            ``obs_offset``, ``obs_downsample`` and ``stats_center``.  The
            macro then returns ``(u1, stats, obs)``:

            * ``stats`` (..., 3) f32 per env:
              ``[sum(u-c), sum((u-c)**2), n_finite]`` over the finite
              pixels, ``c = stats_center`` (centered moments keep the
              variance reward ``-(s2/n - (s1/n)**2)`` cancellation-free);
            * ``obs`` (..., H/ds, W/ds) uint8:
              ``clip(pool(u)*obs_scale + obs_offset, 0, 255)`` with
              non-finite pixels read as 0 and ``ds = obs_downsample``
              mean-pooling (``H/ds`` and ``W/ds`` must be >= 16 when
              ``ds > 1``).

            ``stats`` is differentiable (its cotangent folds into the
            field's); ``obs`` is not.

    ``u`` has shape (..., H, W) (leading axes are the env batch); ``kappa``
    broadcasts to the batch.
    """
    for n in (H, W):
        if n not in SUPPORTED_GRIDS:
            raise ValueError(
                f"cas kernel grid {(H, W)}: each axis must be one of "
                f"{SUPPORTED_GRIDS}; use spectral_solve='fft' for other grids"
            )
    lam_h, lam_w = _fd_lap_symbols(H, W, hx, hy)
    lam_np = (lam_h[:, None] + lam_w[None, :]).astype(np.float32)
    CH_np, CW_np = _cas_mat(H), _cas_mat(W)
    A_dt = float(A) * float(dt)
    dt_f = float(dt)
    inv_hw = 1.0 / float(H * W)
    mats = mats_dtype
    prec = jax.lax.Precision.HIGHEST if mats == jnp.float32 else None
    split = mats == jnp.bfloat16

    if epilogue is not None:
        obs_scale = float(epilogue.get("obs_scale", 255.0))
        obs_offset = float(epilogue.get("obs_offset", 0.0))
        center = float(epilogue.get("stats_center", 0.0))
        ds = int(epilogue.get("obs_downsample", 1))
        if H % ds or W % ds:
            raise ValueError(f"obs_downsample={ds} must divide {(H, W)}")
        Hd, Wd = H // ds, W // ds
        if ds > 1 and min(Hd, Wd) < 16:
            raise ValueError(
                f"pooled observation {(Hd, Wd)} must be >= 16 per axis"
            )

    def _split(x):
        hi = x.astype(mats)
        return hi, (x - hi.astype(jnp.float32)).astype(mats)

    def _dot(a, b):
        """f32-accumulated product of (head, tail) operand pairs."""
        if not split:
            return pl.dot(a[0], b[0], precision=prec)
        return (pl.dot(a[0], b[0]) + pl.dot(a[0], b[1])
                + pl.dot(a[1], b[0]))

    def cas2(z, ch, cw):
        """C z C with ``mats`` operands and f32 accumulation."""
        t = _dot(ch, _split(z))
        return _dot(_split(t), cw)

    def evolve(u_ref, kap_ref, ch_ref, cw_ref, lam_ref):
        u = u_ref[...].astype(jnp.float32)
        kap = kap_ref[...]
        ch = (ch_ref[0], ch_ref[1])
        cw = (cw_ref[0], cw_ref[1])
        lam = lam_ref[...]
        lam2 = lam * lam
        denom = 1.0 / (1.0 + A_dt * kap * lam2)
        cm = dt_f * lam * denom
        cu = (dt_f * kap) * lam2 * denom
        # A constant shift moves only the DC coefficient, which cm and cu
        # zero (lam[0, 0] == 0).  Transforming deviations from the initial
        # means keeps the bf16 operand rounding relative to the field's
        # variation instead of to its (much larger) mean.
        u_c = jnp.sum(u) * inv_hw
        mu_c = jnp.sum(mu_fn(u)) * inv_hw

        def substep(_, carry):
            u, u_t = carry
            incr = cm * cas2(mu_fn(u) - mu_c, ch, cw) - cu * u_t
            return u + inv_hw * cas2(incr, ch, cw), u_t + incr

        u_t = cas2(u - u_c, ch, cw)
        u, _ = jax.lax.fori_loop(0, n_steps, substep, (u, u_t))
        return u

    def kernel(u_ref, kap_ref, ch_ref, cw_ref, lam_ref, out_ref):
        out_ref[...] = evolve(u_ref, kap_ref, ch_ref, cw_ref,
                              lam_ref).astype(out_ref.dtype)

    def kernel_ep(u_ref, kap_ref, ch_ref, cw_ref, lam_ref, *rest):
        if ds > 1:
            ph_ref, pw_ref, out_ref, stats_ref, obs_ref = rest
        else:
            out_ref, stats_ref, obs_ref = rest
        u = evolve(u_ref, kap_ref, ch_ref, cw_ref, lam_ref)
        fin = (u - u) == 0.0                              # False on inf/NaN
        uz = jnp.where(fin, u - center, 0.0)
        s1 = jnp.sum(uz)
        s2 = jnp.sum(uz * uz)
        nf = jnp.sum(fin.astype(jnp.float32))
        idx = jax.lax.broadcasted_iota(jnp.int32, (4,), 0)
        stats_ref[...] = jnp.where(
            idx == 0, s1, jnp.where(idx == 1, s2, jnp.where(idx == 2, nf, 0.0))
        )
        if ds > 1:
            hi = jax.lax.Precision.HIGHEST
            t = pl.dot(ph_ref[...], uz, trans_a=True, precision=hi)
            y = pl.dot(t, pw_ref[...], precision=hi) + center
        else:
            y = jnp.where(fin, u, 0.0)
        ob = jnp.clip(y * obs_scale + obs_offset, 0.0, 255.0)
        obs_ref[...] = ob.astype(jnp.int32).astype(jnp.uint8)
        out_ref[...] = u.astype(out_ref.dtype)

    def _split_const(m):
        """(2, N, N) stack of the ``mats`` head and tail of ``m``."""
        hi = jnp.asarray(m, jnp.float32).astype(mats)
        return jnp.stack([hi, (jnp.asarray(m, jnp.float32)
                               - hi.astype(jnp.float32)).astype(mats)])

    def _call(x, kapf):
        B = x.shape[0]
        consts = [_split_const(CH_np), _split_const(CW_np),
                  jnp.asarray(lam_np)]
        if epilogue is not None and ds > 1:
            consts += [jnp.asarray(_pool_mat(H, ds)),
                       jnp.asarray(_pool_mat(W, ds))]
        field = pl.BlockSpec((None, H, W), lambda i: (i, 0, 0))
        in_specs = [field, pl.BlockSpec((None,), lambda i: (i,))] + [
            pl.BlockSpec(c.shape, lambda i, _n=c.ndim: (0,) * _n)
            for c in consts
        ]
        field_out = jax.ShapeDtypeStruct((B, H, W), x.dtype)
        if epilogue is None:
            body, out_specs, out_shape = kernel, field, field_out
        else:
            body = kernel_ep
            out_specs = (field, pl.BlockSpec((None, 4), lambda i: (i, 0)),
                         pl.BlockSpec((None, Hd, Wd), lambda i: (i, 0, 0)))
            out_shape = (field_out,
                         jax.ShapeDtypeStruct((B, 4), jnp.float32),
                         jax.ShapeDtypeStruct((B, Hd, Wd), jnp.uint8))
        return pl.pallas_call(
            body,
            grid=(B,),
            in_specs=in_specs,
            out_specs=out_specs,
            out_shape=out_shape,
            backend="triton",
            compiler_params=plgpu.CompilerParams(num_warps=_NUM_WARPS,
                                                 num_stages=1),
            interpret=pallas_interpret(),
            name="ch_cas_macro",
        )(x, kapf, *consts)

    def _flatten(state, kappa):
        *batch, h, w = state.shape
        if (h, w) != (H, W):
            raise ValueError(f"state trailing shape {(h, w)} != {(H, W)}")
        B = math.prod(batch)
        kap = jnp.asarray(kappa, jnp.float32)
        kapf = (jnp.broadcast_to(kap, (B,)) if kap.ndim <= 1
                else kap.reshape(B))
        return batch, state.reshape(B, H, W), kapf

    oracle = ch_sif_macro_reference(mu_fn, hx, hy, A, dt, n_steps, remat=True)

    if epilogue is None:
        def macro(state, kappa):
            batch, x, kapf = _flatten(state, kappa)
            return _call(x, kapf).reshape(*batch, H, W)

        return _attach_oracle_vjp(macro, oracle)

    @jax.custom_vjp
    def macro_ep(state, kappa):
        batch, x, kapf = _flatten(state, kappa)
        u1, stats, obs = _call(x, kapf)
        return (u1.reshape(*batch, H, W), stats[:, :3].reshape(*batch, 3),
                obs.reshape(*batch, Hd, Wd))

    def macro_ep_fwd(state, kappa):
        out = macro_ep(state, kappa)
        return out, (state, kappa, out[0])

    def macro_ep_bwd(res, cots):
        # The obs output ends in uint8: no cotangent flows through it.
        state, kappa, u1 = res
        gu, gstats, _ = cots
        g = _fold_stats_cotangent(u1, gu, gstats, center)
        _, vjp = jax.vjp(oracle, state, kappa)
        return vjp(g)

    macro_ep.defvjp(macro_ep_fwd, macro_ep_bwd)
    return macro_ep
