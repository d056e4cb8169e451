"""PDEModel — forward solving, parameter estimation, and optimal control.

API parity with ``/root/reference/pde_opt/pde_model.py`` (class ``PDEModel``
:15-551: ``solve`` :68-136, ``residual_single`` :138-171, ``regularization``
:173-224, ``residuals`` :226-272, ``mse`` :274-322, ``train`` :325-460,
``optimize`` :462-551), rebuilt on the on-device stack:

* rollouts are ``lax.scan`` integrations (:mod:`pde_opt_jax.ops.integrate`),
  forward-differentiable for Levenberg-Marquardt and reverse-differentiable
  through ``jax.checkpoint`` segments for L-BFGS — replacing diffrax's
  ForwardMode / RecursiveCheckpointAdjoint;
* the residual batch is evaluated **natively batched** — equations are
  batch-transparent, so the whole ``(B, ...)`` set of initial conditions
  integrates in one fused rollout instead of a vmap of per-trajectory
  diffeqsolves (reference ``pde_model.py:266-268``);
* optimizers are this framework's LM (:mod:`pde_opt_jax.optim.lm`) and optax
  L-BFGS/Adam (:mod:`pde_opt_jax.optim.minimize`) — replacing optimistix.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Type

import jax
import jax.numpy as jnp
import numpy as np

from .. import grid as domains
from ..ops.integrate import (
    ConstantStepSize,
    PIDController,
    integrate,
    integrate_adaptive,
)
from ..optim.lm import least_squares_lm, least_squares_lm_jitted
from ..optim.minimize import minimize_adam, minimize_lbfgs
from ..utils.compat import check_equation_solver_compatibility, prepare_solver_params
from ..utils import ptree
from .base import BaseEquation

__all__ = ["PDEModel", "OptimizationModel"]


class PDEModel:
    """Manage solving and optimization of PDEs.

    Args:
        equation_type: equation class (subclass of
            :class:`pde_opt_jax.models.base.BaseEquation`).
        domain: spatial :class:`pde_opt_jax.grid.Domain`.
        solver_type: stepper class from :mod:`pde_opt_jax.ops.steppers`.
            Solver↔equation compatibility is validated at construction
            (required-attribute contract, reference ``utils.py:6-31``).
    """

    def __init__(
        self,
        equation_type: Type[BaseEquation],
        domain: domains.Domain,
        solver_type,
    ):
        self.equation_type = equation_type
        self.domain = domain
        self.solver_type = solver_type
        check_equation_solver_compatibility(solver_type, equation_type)

    # ------------------------------------------------------------------
    def _build(self, parameters: Dict[str, Any], solver_parameters: Dict[str, Any]):
        equation = self.equation_type(domain=self.domain, **parameters)
        full = prepare_solver_params(self.solver_type, solver_parameters, equation)
        solver = self.solver_type(**full)
        return equation, solver

    def solve(
        self,
        parameters: Dict[str, Any],
        y0,
        ts,
        solver_parameters: Optional[Dict[str, Any]] = None,
        adjoint: str = "forward",
        dt0: float = 0.000001,
        max_steps: int = 1_000_000,
        stepsize_controller=None,
    ):
        """Forward-simulate; returns solution of shape ``(len(ts), *y0.shape)``.

        ``y0`` may carry leading batch axes — the whole batch integrates in
        one rollout.  ``adjoint``: ``"forward"`` (jvp-friendly) or
        ``"checkpoint"`` (reverse-mode memory O(saves+segment)).
        ``stepsize_controller``: ``None``/:class:`ConstantStepSize` for fixed
        dt (lockstep, batchable) or a :class:`PIDController` for the adaptive
        driver (single-instance paths).
        """
        solver_parameters = solver_parameters or {}
        equation, solver = self._build(parameters, solver_parameters)
        rhs = equation.rhs

        # The rollout always runs under jit (nested jit is fine when solve()
        # is itself being traced): the compiled rollout is what every hot
        # caller wants anyway.
        if stepsize_controller is None or isinstance(stepsize_controller, ConstantStepSize):
            ts_np = np.asarray(ts, dtype=np.float64)
            n_total = int(np.sum(np.maximum(1, np.round(np.diff(ts_np) / dt0))))
            if n_total > max_steps:
                raise ValueError(
                    f"rollout needs {n_total} steps > max_steps={max_steps}; "
                    "raise max_steps or dt0"
                )
            rollout = jax.jit(
                lambda y: integrate(solver, rhs, y, ts_np, dt0, adjoint=adjoint)
            )
            return rollout(y0)
        if isinstance(stepsize_controller, PIDController):
            rollout = jax.jit(
                lambda y: integrate_adaptive(
                    solver, rhs, y, jnp.asarray(ts), dt0,
                    rtol=stepsize_controller.rtol,
                    atol=stepsize_controller.atol,
                    max_steps=max_steps,
                )
            )
            return rollout(y0)
        raise ValueError(f"unknown stepsize_controller: {stepsize_controller!r}")

    # ------------------------------------------------------------------
    def residual_single(
        self,
        parameters,
        solver_parameters,
        y0,
        values,
        ts,
        adjoint: str = "forward",
        dt0: float = 0.000001,
    ):
        """Residuals for one trajectory: ``values - pred[1:]``.

        (``values`` excludes the initial condition; reference
        ``pde_model.py:166-171``.)
        """
        pred = self.solve(parameters, y0, ts, solver_parameters, adjoint=adjoint, dt0=dt0)
        return values - pred[1:]

    def regularization(self, parameters, weights, lambda_reg):
        """Weighted L2 penalty: λ·Σᵢ wᵢ pᵢ² over matching pytree leaves.

        ``weights`` mirrors ``parameters``; ``None`` weights are skipped
        (reference ``pde_model.py:173-224``).
        """
        reg = 0.0

        def safe_weighted_square(w, v):
            if ptree.is_inexact_array_like(w) and ptree.is_inexact_array_like(v):
                return jnp.sum(w * jnp.asarray(v) ** 2)
            return 0.0

        for key in weights.keys():
            reg = reg + lambda_reg * jax.tree_util.tree_reduce(
                jnp.add,
                jax.tree_util.tree_map(
                    safe_weighted_square,
                    weights[key],
                    parameters[key],
                    is_leaf=lambda x: x is None,
                ),
                0.0,
            )
        return reg

    def residuals(
        self,
        parameters,
        y0s__values,
        solver_parameters,
        ts,
        weights,
        lambda_reg,
        adjoint: str = "forward",
        dt0: float = 0.000001,
    ):
        """Batched residuals + regularization.

        The batch of initial conditions integrates as one natively-batched
        rollout (equations are batch-transparent), replacing the reference's
        ``eqx.filter_vmap`` over per-trajectory solves.
        """
        y0s, values = y0s__values
        pred = self.solve(
            parameters, y0s, ts, solver_parameters, adjoint=adjoint, dt0=dt0
        )  # (T, B, ...)
        pred = jnp.moveaxis(pred, 0, 1)  # (B, T, ...)
        batch_residuals = values - pred[:, 1:]
        reg = self.regularization(parameters, weights, lambda_reg)
        return batch_residuals, reg

    def mse(
        self,
        parameters,
        y0s__values,
        solver_parameters,
        ts,
        weights,
        lambda_reg,
        adjoint: str = "checkpoint",
        dt0: float = 0.000001,
    ):
        """Mean squared error + regularization (the ``train(method="mse")`` loss)."""
        batch_residuals, reg = self.residuals(
            parameters, y0s__values, solver_parameters, ts, weights, lambda_reg,
            adjoint=adjoint, dt0=dt0,
        )
        return jnp.mean(batch_residuals**2) + reg

    # ------------------------------------------------------------------
    def train(
        self,
        data,
        inds,
        opt_parameters,
        other_parameters,
        solver_parameters,
        weights,
        lambda_reg,
        method: str = "least_squares",
        max_steps: int = 100,
        dt0: float = 0.000001,
        verbose: bool = False,
        learning_rate: float = 1e-2,
    ):
        """Fit ``opt_parameters`` to observed trajectories.

        Data slicing semantics match the reference exactly
        (``pde_model.py:378-390``): ``inds[k] = [i0, i1, ...]`` selects
        ``data["ys"][i0]`` as the k-th initial condition and the remaining
        indices as its observations; all trajectories share the time offsets
        of ``inds[0]``.

        ``method``: ``"least_squares"`` (Levenberg-Marquardt, forward-mode —
        small parameter vectors; runs device-resident inside one jitted
        ``lax.while_loop`` unless ``verbose=True``, which switches to the
        host outer loop for per-iteration logging — the host loop pays a
        sync every LM iteration),
        ``"least_squares_jit"`` (force the jitted loop regardless of
        ``verbose``), ``"mse"`` (L-BFGS, checkpointed reverse-mode —
        NN-sized parameters), or ``"adam"`` (first-order, robust for long
        rollouts).
        """
        y0s = jnp.array([data["ys"][ind[0]] for ind in inds])
        values = jnp.array(
            [
                jnp.array([data["ys"][ind[i]] for i in range(1, len(ind))])
                for ind in inds
            ]
        )
        ts = np.array(
            [
                float(data["ts"][inds[0][i]]) - float(data["ts"][inds[0][0]])
                for i in range(len(inds[0]))
            ]
        )

        opt_params, opt_static = ptree.partition(opt_parameters)
        opt_params = ptree.as_arrays(opt_params)

        if method in ("least_squares", "least_squares_jit"):
            flat0, unravel = ptree.ravel_params(opt_parameters)

            def residuals_flat(theta, y0s_, values_):
                full = unravel(theta)
                res, reg = self.residuals(
                    {**full, **other_parameters},
                    (y0s_, values_),
                    solver_parameters,
                    ts,
                    weights,
                    lambda_reg,
                    adjoint="forward",
                    dt0=dt0,
                )
                return (res, reg)

            # Data enters as jit *arguments* (not closures) so trajectory
            # arrays are never baked into the executable as constants.
            if method == "least_squares_jit" or not verbose:
                sol = least_squares_lm_jitted(
                    residuals_flat, flat0, args=(y0s, values),
                    max_steps=max_steps, rtol=1e-8, atol=1e-8,
                )
            else:
                sol = least_squares_lm(
                    residuals_flat, flat0, args=(y0s, values),
                    max_steps=max_steps, rtol=1e-8, atol=1e-8,
                    verbose=verbose,
                )
            res = unravel(sol.params)
            return {**res, **other_parameters}

        if method in ("mse", "adam"):

            def loss_fn(_opt_params, y0s_, values_):
                full = ptree.combine(_opt_params, opt_static)
                return self.mse(
                    {**full, **other_parameters},
                    (y0s_, values_),
                    solver_parameters,
                    ts,
                    weights,
                    lambda_reg,
                    adjoint="checkpoint",
                    dt0=dt0,
                )

            if method == "mse":
                sol = minimize_lbfgs(
                    loss_fn, opt_params, args=(y0s, values),
                    max_steps=max_steps, rtol=1e-8, atol=1e-8, verbose=verbose,
                )
            else:
                sol = minimize_adam(
                    loss_fn, opt_params, args=(y0s, values),
                    max_steps=max_steps, learning_rate=learning_rate,
                    verbose=verbose,
                )
            res = ptree.combine(sol.params, opt_static)
            return {**res, **other_parameters}

        raise ValueError(f"unknown train method: {method!r}")

    # ------------------------------------------------------------------
    def optimize(
        self,
        objective_function: Callable,
        y0,
        ts,
        opt_parameters,
        other_parameters,
        solver_parameters,
        weights,
        lambda_reg,
        max_steps: int = 100,
        dt0: float = 0.000001,
        method: str = "lbfgs",
        verbose: bool = False,
        learning_rate: float = 1e-2,
    ):
        """Minimize a scalar function of the solution over parameters.

        The differentiable-rollout control path (reference
        ``pde_model.py:462-551``): reverse-mode through a checkpointed scan.
        """
        ts = np.asarray(ts, dtype=np.float64)
        opt_params, opt_static = ptree.partition(opt_parameters)
        opt_params = ptree.as_arrays(opt_params)

        def objective(_opt_params, y0_):
            full = ptree.combine(_opt_params, opt_static)
            all_params = {**full, **other_parameters}
            solution = self.solve(
                all_params, y0_, ts, solver_parameters,
                adjoint="checkpoint", dt0=dt0,
            )
            return objective_function(solution) + self.regularization(
                all_params, weights, lambda_reg
            )

        if method == "lbfgs":
            sol = minimize_lbfgs(
                objective, opt_params, args=(y0,), max_steps=max_steps,
                rtol=1e-8, atol=1e-8, verbose=verbose,
            )
        elif method == "adam":
            sol = minimize_adam(
                objective, opt_params, args=(y0,), max_steps=max_steps,
                learning_rate=learning_rate, verbose=verbose,
            )
        else:
            raise ValueError(f"unknown optimize method: {method!r}")
        res = ptree.combine(sol.params, opt_static)
        return {**res, **other_parameters}


# Ghost/legacy alias: old name used by reference notebooks
# (`notebooks/tmp.py:6-8`, `test_optimization_model.ipynb` cell 0).
OptimizationModel = PDEModel
