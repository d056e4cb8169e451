"""Time-integration drivers: the on-device replacement for ``diffrax.diffeqsolve``.

The reference runs every rollout through diffrax's host-side while-loop
(``/root/reference/pde_opt/pde_model.py:120-134``, ``pde_env.py:293-303``).
Here the loop is a ``lax.scan`` over save intervals with a nested scan of
fixed substeps — one compiled XLA region per rollout, batch-transparent, and
differentiable both ways:

* forward-mode (``jax.jvp``) flows straight through the scan — the
  replacement for diffrax ``ForwardMode`` (reference ``pde_model.py:74``);
* reverse-mode uses ``jax.checkpoint`` on each save segment — the replacement
  for ``RecursiveCheckpointAdjoint`` (reference ``pde_model.py:282``),
  trading FLOPs for device memory.

An adaptive PID-controlled driver (``integrate_adaptive``) covers the
reference's Tsit5+PIDController paths (``test_solvers.py:94``,
``shapes.py:74``) using a ``lax.while_loop`` with dense save-at via linear
interpolation — matching ``diffrax.SaveAt(ts=...)`` semantics.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .steppers import AbstractStepper

__all__ = ["evolve", "integrate", "integrate_adaptive", "PIDController", "ConstantStepSize"]


class PIDController:
    """Adaptive step-size request (API familiarity with diffrax's PIDController).

    Pass as ``stepsize_controller`` to :meth:`PDEModel.solve` to select the
    adaptive driver; fields feed :func:`integrate_adaptive`.
    """

    def __init__(self, rtol: float = 1e-4, atol: float = 1e-6):
        self.rtol = rtol
        self.atol = atol


class ConstantStepSize:
    """Fixed step-size request (the default; selects :func:`integrate`)."""


def evolve(
    stepper: AbstractStepper,
    rhs: Callable,
    y0,
    t0,
    dt,
    n_steps: int,
    unroll: int = 1,
):
    """Advance ``n_steps`` fixed steps; return the final state only.

    This is the env hot path: an entire RL macro-step (``step_dt`` worth of
    ``numeric_dt`` substeps) fuses into one scan — the reference instead
    re-entered diffrax (and re-jitted the rhs) every RL step
    (``pde_env.py:281-303``).

    Steppers may override the whole loop by defining
    ``evolve(rhs, y0, t0, dt, n_steps, unroll)`` — the hook the fused
    macro-step stepper (:class:`~pde_opt_jax.ops.steppers.FusedSemiImplicitSpectral`)
    uses to keep all substeps on chip in one kernel.
    """
    own = getattr(stepper, "evolve", None)
    if own is not None:
        return own(rhs, y0, t0, dt, n_steps, unroll)

    def body(y, i):
        t = t0 + i * dt
        y1, _ = stepper.step(rhs, y, t, dt)
        # Keep the carry dtype-stable (x64 mode can promote through FFTs).
        y1 = jax.tree_util.tree_map(lambda a, b: a.astype(b.dtype), y1, y)
        return y1, None

    yT, _ = jax.lax.scan(body, y0, jnp.arange(n_steps), unroll=unroll)
    return yT


def _segment_advance(stepper, rhs, y, t_start, dt_sub, n_sub, unroll):
    # Steppers with a whole-segment evolve hook (the fused Pallas macros)
    # advance all substeps in one kernel — model-layer solves then run at
    # fused speed too, and their custom VJPs keep the segment
    # differentiable under both adjoint modes.
    own = getattr(stepper, "evolve", None)
    if own is not None:
        return own(rhs, y, t_start, dt_sub, n_sub, unroll)

    def body(yc, i):
        t = t_start + i * dt_sub
        y1, _ = stepper.step(rhs, yc, t, dt_sub)
        y1 = jax.tree_util.tree_map(lambda a, b: a.astype(b.dtype), y1, yc)
        return y1, None

    y_end, _ = jax.lax.scan(body, y, jnp.arange(n_sub), unroll=unroll)
    return y_end


def integrate(
    stepper: AbstractStepper,
    rhs: Callable,
    y0,
    ts,
    dt0: float,
    adjoint: str = "forward",
    unroll: int = 1,
):
    """Fixed-step integration with solutions saved at ``ts``.

    Args:
        stepper: single-step integrator.
        rhs: ``rhs(y, t) -> dy/dt`` (batch axes ride along).
        y0: initial state at ``ts[0]``.
        ts: **concrete** (host-known) 1D array of save times, increasing.
            Concreteness lets the substep counts be static — the whole rollout
            compiles to nested scans with no dynamic shapes.
        dt0: target step size.  Each save interval takes
            ``n = max(1, round(Δ/dt0))`` substeps of size ``Δ/n`` — save points
            are hit exactly (no interpolation error), with effective dt within
            rounding of ``dt0``.
        adjoint: ``"forward"`` (plain scans; use with ``jax.jvp``/LM) or
            ``"checkpoint"`` (each save segment wrapped in ``jax.checkpoint``
            so reverse-mode memory is O(saves + steps-per-segment), the scan
            analog of diffrax's RecursiveCheckpointAdjoint).

    Returns:
        Array stacked over ``ts`` — shape ``(len(ts), *y0.shape)``, with
        ``out[0] = y0`` (matching ``diffrax.SaveAt(ts)`` when ``ts[0]=t0``,
        as the reference's residual slicing assumes, ``pde_model.py:167-169``).
    """
    ts = np.asarray(ts, dtype=np.float64)
    if ts.ndim != 1 or len(ts) < 2:
        raise ValueError("ts must be a 1D array of at least two save times")
    deltas = np.diff(ts)
    if np.any(deltas <= 0):
        raise ValueError("ts must be strictly increasing")

    n_subs = np.maximum(1, np.round(deltas / dt0).astype(int))

    advance = _segment_advance
    if adjoint == "checkpoint":
        # dt_sub (argnum 4) stays static: it is always a host float here,
        # and whole-segment steppers (the fused Pallas macros) require a
        # trace-time-concrete dt to specialize their kernels.
        advance = jax.checkpoint(
            _segment_advance, static_argnums=(0, 1, 4, 5, 6)
        )
    elif adjoint != "forward":
        raise ValueError(f"unknown adjoint mode: {adjoint!r}")

    # Uniform save grid (the common case) -> a single nested scan.
    if len(set(n_subs.tolist())) == 1 and np.allclose(deltas, deltas[0]):
        n_sub = int(n_subs[0])
        dt_sub = float(deltas[0]) / n_sub

        def seg(y, t_start):
            y_end = advance(stepper, rhs, y, t_start, dt_sub, n_sub, unroll)
            return y_end, y_end

        _, ys_tail = jax.lax.scan(seg, y0, jnp.asarray(ts[:-1]))
        return jnp.concatenate([y0[None], ys_tail], axis=0)

    # Non-uniform grid: unrolled python loop over segments (len(ts) is small).
    ys = [y0]
    y = y0
    for i, (t_start, delta, n_sub) in enumerate(zip(ts[:-1], deltas, n_subs)):
        dt_sub = float(delta) / int(n_sub)
        y = advance(stepper, rhs, y, float(t_start), dt_sub, int(n_sub), unroll)
        ys.append(y)
    return jnp.stack(ys, axis=0)


# ---------------------------------------------------------------------------
# Adaptive (PID-controlled) driver
# ---------------------------------------------------------------------------

def _rms_norm(err, y0, y1, rtol, atol, batch_ndim: int = 0):
    """Scaled RMS error norm; with ``batch_ndim`` leading batch axes the
    norm is taken per instance and the MAX across the batch controls dt —
    every instance's tolerance is respected (conservative lockstep) instead
    of being silently averaged away across the batch."""
    scale = atol + rtol * jnp.maximum(jnp.abs(y0), jnp.abs(y1))
    ratio = err / scale
    if batch_ndim:
        axes = tuple(range(batch_ndim, ratio.ndim))
        return jnp.max(jnp.sqrt(jnp.mean(ratio**2, axis=axes)))
    return jnp.sqrt(jnp.mean(ratio**2))


def integrate_adaptive(
    stepper: AbstractStepper,
    rhs: Callable,
    y0,
    ts,
    dt0: float,
    rtol: float = 1e-4,
    atol: float = 1e-6,
    max_steps: int = 1_000_000,
    safety: float = 0.9,
    factor_min: float = 0.2,
    factor_max: float = 10.0,
    return_stats: bool = False,
    batch_ndim: int = 0,
):
    """Adaptive-step integration with dense save-at (linear interpolation).

    The I-controller step-size law diffrax's default ``PIDController`` reduces
    to (pcoeff=0, icoeff=1): accept when the RMS-scaled error ≤ 1, and scale
    ``dt *= clip(safety * err^(-1/(order+1)), factor_min, factor_max)``.
    Solutions are recorded at ``ts`` by linear interpolation between accepted
    steps (``diffrax.LocalLinearInterpolation`` semantics — what both custom
    reference solvers declare, ``solvers.py:48,91``).

    Adaptive stepping is primarily for the single-instance model paths
    (AC/SBM notebooks, Shape smoothing); env fleets use fixed-dt
    :func:`evolve`.  For a batched ``y0``, pass ``batch_ndim`` (number of
    leading batch axes): the controller then takes each instance's error
    norm separately and lets the strictest one govern the shared lockstep
    dt — without it a batched state's errors would be silently RMS-averaged
    across the batch, loosening every instance's tolerance.

    Returns ``ys`` of shape ``(len(ts), *y0.shape)`` (and, if requested, a
    stats dict with accepted/rejected step counts).
    """
    ts = jnp.asarray(ts)
    n_save = ts.shape[0]
    t0 = ts[0]
    t_final = ts[-1]
    time_dtype = jnp.result_type(ts.dtype, jnp.float32)
    # Dtype-aware time tolerance: save capture and loop termination compare
    # accumulated step times against the save grid, so the slack must scale
    # with the time dtype's resolution at the magnitude of the run (an
    # absolute 1e-12 is below one ulp for f32 runs with t ~ 1, which could
    # defer the final write past loop exit).  Interior points can never be
    # *skipped* regardless: a point not yet captured when t passes it is
    # written on the next accepted step by (slightly extrapolated) linear
    # interpolation, and the final accepted step — the one that ends the
    # loop by reaching t_final - tol — captures every remaining point
    # because ts[i] <= t_final <= t_new + 2*tol.
    tmax = jnp.maximum(jnp.max(jnp.abs(ts)), 1.0).astype(time_dtype)
    time_tol = 32.0 * jnp.finfo(time_dtype).eps * tmax
    ys_buf = jnp.zeros((n_save,) + y0.shape, dtype=y0.dtype)
    ys_buf = ys_buf.at[0].set(y0)

    # The while_loop carries (time state, save cursor, stats) plus the
    # preallocated save buffer; save points inside each accepted step are
    # written by linear interpolation.
    def body_with_buf(carry):
        (t, y, dt, save_idx, n_acc, n_rej), buf = carry
        dt = jnp.minimum(dt, t_final - t)
        y1, y_err = stepper.step(rhs, y, t, dt)
        # Pin the carry dtype (same invariant as evolve()): x64 test mode
        # can promote through the rhs, which would change the while_loop
        # carry type mid-trace on f32/bf16 states.
        y1 = jax.tree_util.tree_map(
            lambda a, b: a.astype(b.dtype), y1, y
        )
        err_norm = _rms_norm(y_err, y, y1, rtol, atol, batch_ndim)
        accept = err_norm <= 1.0

        exponent = -1.0 / (stepper.order + 1.0)
        factor = jnp.clip(
            safety * jnp.power(jnp.maximum(err_norm, 1e-16), exponent),
            factor_min,
            factor_max,
        )
        dt_next = dt * factor
        t_new = jnp.where(accept, t + dt, t)
        y_new = jnp.where(accept, y1, y)

        def wcond(s):
            _, i = s
            return (i < n_save) & accept & (
                ts[jnp.minimum(i, n_save - 1)] <= t_new + 2.0 * time_tol
            )

        def wbody(s):
            b, i = s
            t_save = ts[i]
            theta = jnp.where(dt > 0, (t_save - t) / dt, 0.0).astype(y1.dtype)
            y_interp = y + theta * (y1 - y)
            return b.at[i].set(y_interp), i + 1

        buf, save_idx = jax.lax.while_loop(wcond, wbody, (buf, save_idx))
        n_acc = n_acc + jnp.where(accept, 1, 0)
        n_rej = n_rej + jnp.where(accept, 0, 1)
        return (t_new, y_new, dt_next, save_idx, n_acc, n_rej), buf

    def cond_with_buf(carry):
        (t, y, dt, save_idx, n_acc, n_rej), _ = carry
        return (t < t_final - time_tol) & (n_acc + n_rej < max_steps)

    init = (
        (
            jnp.asarray(t0, dtype=jnp.result_type(ts.dtype, jnp.float32)),
            y0,
            jnp.asarray(dt0, dtype=jnp.result_type(ts.dtype, jnp.float32)),
            jnp.asarray(1, dtype=jnp.int32),
            jnp.asarray(0, dtype=jnp.int32),
            jnp.asarray(0, dtype=jnp.int32),
        ),
        ys_buf,
    )
    (tf, yf, dtf, save_idx, n_acc, n_rej), ys = jax.lax.while_loop(
        cond_with_buf, body_with_buf, init
    )
    # Backstop for max_steps exhaustion ONLY: on a normal exit the final
    # accepted step always writes the last slot (its wcond tolerance is
    # twice the loop-exit tolerance, see time_tol above; property-tested on
    # adversarial f32 save grids in tests/test_solvers.py).  If the loop
    # died on the step budget mid-run, the final slot holds the last state
    # reached rather than zeros.
    ys = ys.at[n_save - 1].set(
        jnp.where(save_idx >= n_save, ys[n_save - 1], yf)
    )
    if return_stats:
        return ys, {"accepted_steps": n_acc, "rejected_steps": n_rej}
    return ys
