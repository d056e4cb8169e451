"""Scalar minimization over parameter pytrees.

On-device replacement for ``optimistix.minimise(BFGS)`` (reference
``pde_model.py:443-456,532-546``): optax L-BFGS with zoom linesearch for
NN-sized parameter pytrees, plus a plain Adam loop as the robust fallback.
Loss functions differentiate in reverse mode through checkpointed rollouts
(the ``jax.checkpoint``-segmented scan in :mod:`pde_opt_jax.ops.integrate`).
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import jax
import jax.numpy as jnp
import optax

__all__ = ["minimize_lbfgs", "minimize_adam", "MinimizeResult"]


class MinimizeResult(NamedTuple):
    params: Any
    loss: jax.Array
    steps: int
    converged: bool


def minimize_lbfgs(
    fn: Callable,
    params,
    args=(),
    max_steps: int = 100,
    rtol: float = 1e-8,
    atol: float = 1e-8,
    memory_size: int = 10,
    verbose: bool = False,
):
    """Minimize ``fn(params, *args)`` with L-BFGS (+ zoom linesearch).

    ``args`` are threaded through the jitted step as real arguments (see
    :func:`pde_opt_jax.optim.lm.least_squares_lm` for why closures over
    device data are avoided).
    """
    args = tuple(args)
    opt = optax.lbfgs(memory_size=memory_size)
    state = opt.init(params)

    @jax.jit
    def step_fn(params, state, *a):
        bound = lambda q: fn(q, *a)
        value, grad = optax.value_and_grad_from_state(bound)(params, state=state)
        updates, state = opt.update(
            grad, state, params, value=value, grad=grad, value_fn=bound
        )
        params = optax.apply_updates(params, updates)
        return params, state, value, optax.global_norm(grad)

    prev_value = jnp.inf
    value = jnp.inf
    converged = False
    step = 0
    for step in range(1, max_steps + 1):
        params, state, value, gnorm = step_fn(params, state, *args)
        if verbose:
            print(f"[LBFGS] step={step} loss={float(value):.6e} |g|={float(gnorm):.3e}")
        if not bool(jnp.isfinite(value)):
            break
        if bool(jnp.abs(prev_value - value) < rtol * jnp.abs(value) + atol):
            converged = True
            break
        prev_value = value
    return MinimizeResult(params=params, loss=value, steps=step, converged=converged)


def minimize_adam(
    fn: Callable,
    params,
    args=(),
    max_steps: int = 100,
    learning_rate: float = 1e-2,
    rtol: float = 0.0,
    atol: float = 0.0,
    verbose: bool = False,
):
    """Minimize ``fn(params, *args)`` with Adam (fixed step budget)."""
    args = tuple(args)
    opt = optax.adam(learning_rate)
    state = opt.init(params)

    @jax.jit
    def step_fn(params, state, *a):
        value, grad = jax.value_and_grad(fn)(params, *a)
        updates, state = opt.update(grad, state)
        params = optax.apply_updates(params, updates)
        return params, state, value

    value = jnp.inf
    prev_value = jnp.inf
    converged = False
    step = 0
    for step in range(1, max_steps + 1):
        params, state, value = step_fn(params, state, *args)
        if verbose:
            print(f"[Adam] step={step} loss={float(value):.6e}")
        if rtol or atol:
            if bool(jnp.abs(prev_value - value) < rtol * jnp.abs(value) + atol):
                converged = True
                break
        prev_value = value
    return MinimizeResult(params=params, loss=value, steps=step, converged=converged)
