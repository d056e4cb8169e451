"""Levenberg-Marquardt for small parameter vectors.

On-device replacement for ``optimistix.least_squares(LevenbergMarquardt)``
(reference ``pde_model.py:410-423``), used for fitting few-coefficient
parameterizations (Legendre expansions, scalar physics constants) by
differentiating *through the rollout*.

Design: the Jacobian of the flattened residual vector w.r.t. the flattened
parameter vector is built with ``jax.jacfwd`` — forward-mode through the
``lax.scan`` rollout, the analog of the reference's diffrax ``ForwardMode``
adjoint (``pde_model.py:74``).  With p parameters this costs p JVP rollouts,
batched by XLA.  The normal equations (JᵀJ + λ·diag(JᵀJ))δ = Jᵀr are solved
densely (p is small).  λ follows the classic accept/reject trust-region
schedule.  The accept/reject inner step is one jitted function; the outer
loop is a host loop (it carries only scalars and enables verbose logging).
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

__all__ = ["least_squares_lm", "least_squares_lm_jitted", "LMResult"]


class LMResult(NamedTuple):
    params: jax.Array  # flat optimized parameters
    loss: jax.Array
    steps: int
    converged: bool


def least_squares_lm(
    residual_fn: Callable,
    theta0,
    args=(),
    max_steps: int = 100,
    rtol: float = 1e-8,
    atol: float = 1e-8,
    lambda0: float = 1e-3,
    lambda_up: float = 4.0,
    lambda_down: float = 3.0,
    max_damping_tries: int = 15,
    verbose: bool = False,
):
    """Minimize ``0.5 * ||residual_fn(theta)||²`` over a flat vector ``theta0``.

    ``residual_fn`` may return any pytree; leaves are flattened into one
    residual vector (matching optimistix semantics, where the reference's
    ``(batch_residuals, reg)`` tuple contributes the scalar reg as one more
    residual element).

    ``args``: extra pytree arguments forwarded as ``residual_fn(theta,
    *args)`` and threaded through the jitted inner functions as real
    arguments.  Pass device-array data (trajectories, targets) here rather
    than closing over it — closure arrays get baked into the executable as
    constants, which both bloats compilation and requires a device->host
    fetch at trace time.
    """
    theta0 = jnp.asarray(theta0)
    args = tuple(args)

    def flat_residual(theta, *a):
        res = residual_fn(theta, *a)
        leaves = jax.tree_util.tree_leaves(res)
        return jnp.concatenate([jnp.ravel(l) for l in leaves])

    @jax.jit
    def compute_jac(theta, *a):
        r = flat_residual(theta, *a)
        J = jax.jacfwd(flat_residual)(theta, *a)
        return r, J

    @jax.jit
    def solve_step(theta, r, J, lam):
        JtJ = J.T @ J
        diag = jnp.diag(jnp.diag(JtJ))
        # Floor the damping diagonal so zero-gradient directions stay solvable.
        diag = jnp.where(jnp.abs(diag) < 1e-12, 1e-12, diag)
        g = J.T @ r
        delta = jnp.linalg.solve(JtJ + lam * diag, g)
        return theta - delta

    @jax.jit
    def loss_of(theta, *a):
        r = flat_residual(theta, *a)
        return 0.5 * jnp.sum(r**2)

    theta = theta0
    lam = lambda0
    loss = float(loss_of(theta, *args))
    converged = False
    step = 0
    for step in range(1, max_steps + 1):
        r, J = compute_jac(theta, *args)
        accepted = False
        # Escalate damping until the step shrinks into the trust region.
        for _ in range(max_damping_tries):
            theta_new = solve_step(theta, r, J, lam)
            loss_new = float(loss_of(theta_new, *args))
            if jnp.isfinite(loss_new) and loss_new < loss:
                accepted = True
                break
            lam *= lambda_up
        if verbose:
            print(
                f"[LM] step={step} loss={loss:.6e} -> {loss_new:.6e} "
                f"lambda={lam:.2e} accepted={accepted}"
            )
        if not accepted:
            # No step at max damping improved the loss: the solve STALLED.
            # Report it as non-convergence (matching optimistix semantics)
            # rather than claiming success.
            converged = False
            break
        improvement = loss - loss_new
        theta, loss = theta_new, loss_new
        lam = max(lam / lambda_down, 1e-12)
        if improvement < rtol * abs(loss) + atol:
            converged = True
            break
    return LMResult(params=theta, loss=jnp.asarray(loss), steps=step, converged=converged)


def least_squares_lm_jitted(
    residual_fn: Callable,
    theta0,
    args=(),
    max_steps: int = 100,
    rtol: float = 1e-8,
    atol: float = 1e-8,
    lambda0: float = 1e-3,
    lambda_up: float = 4.0,
    lambda_down: float = 3.0,
    max_damping_tries: int = 15,
):
    """Device-resident Levenberg-Marquardt: the whole solve is ONE jitted
    ``lax.while_loop`` — no per-iteration host sync (the host-loop variant
    fetches a scalar loss every step, which serializes against the device).

    Same accept/reject trust-region schedule and convergence semantics as
    :func:`least_squares_lm` (stall at max damping reports
    ``converged=False``).  Verbose logging is the host loop's job; use this
    variant for training loops that must stay on device.
    """
    theta0 = jnp.asarray(theta0)
    args = tuple(args)

    def flat_residual(theta, *a):
        res = residual_fn(theta, *a)
        leaves = jax.tree_util.tree_leaves(res)
        return jnp.concatenate([jnp.ravel(l) for l in leaves])

    def solve_step(theta, r, J, lam):
        JtJ = J.T @ J
        diag = jnp.diag(jnp.diag(JtJ))
        diag = jnp.where(jnp.abs(diag) < 1e-12, 1e-12, diag)
        g = J.T @ r
        return theta - jnp.linalg.solve(JtJ + lam * diag, g)

    def loss_of(theta, *a):
        r = flat_residual(theta, *a)
        return 0.5 * jnp.sum(r**2)

    @jax.jit
    def run(theta0, *a):
        loss0 = loss_of(theta0, *a)

        # carry: (theta, lam, loss, step, done, converged)
        def outer_cond(c):
            _, _, _, step, done, _ = c
            return (~done) & (step < max_steps)

        def outer_body(c):
            theta, lam, loss, step, _, _ = c
            r = flat_residual(theta, *a)
            J = jax.jacfwd(flat_residual)(theta, *a)

            # Damping escalation: accept the first lambda whose step
            # improves the loss, up to max_damping_tries.
            def damp_cond(d):
                _, _, _, accepted, tries = d
                return (~accepted) & (tries < max_damping_tries)

            def damp_body(d):
                lam_d, th_best, loss_best, _, tries = d
                th_new = solve_step(theta, r, J, lam_d)
                loss_new = loss_of(th_new, *a)
                ok = jnp.isfinite(loss_new) & (loss_new < loss)
                th_best = jnp.where(ok, th_new, th_best)
                loss_best = jnp.where(ok, loss_new, loss_best)
                lam_d = jnp.where(ok, lam_d, lam_d * lambda_up)
                return (lam_d, th_best, loss_best, ok, tries + 1)

            lam_f, th_new, loss_new, accepted, _ = jax.lax.while_loop(
                damp_cond, damp_body,
                (lam, theta, loss, jnp.asarray(False), jnp.asarray(0)),
            )
            improvement = loss - loss_new
            small = improvement < rtol * jnp.abs(loss_new) + atol
            theta = jnp.where(accepted, th_new, theta)
            loss = jnp.where(accepted, loss_new, loss)
            lam = jnp.where(accepted,
                            jnp.maximum(lam_f / lambda_down, 1e-12), lam_f)
            done = (~accepted) | (accepted & small)
            converged = accepted & small
            return (theta, lam, loss, step + 1, done, converged)

        init = (theta0, jnp.asarray(lambda0, theta0.dtype), loss0,
                jnp.asarray(0), jnp.asarray(False), jnp.asarray(False))
        theta, lam, loss, step, done, converged = jax.lax.while_loop(
            outer_cond, outer_body, init
        )
        return theta, loss, step, converged

    theta, loss, step, converged = run(theta0, *args)
    return LMResult(params=theta, loss=loss, steps=int(step),
                    converged=bool(converged))
