"""Gymnasium adapters over the jitted env cores.

``PDEEnv`` keeps full API parity with the reference environment
(``/root/reference/pde_opt/pde_env.py:22-317``, registered ``"PDEEnv-v0"``
:16-19) for SB3-style host training loops, but the per-step work runs through
a single jitted, donated device function — the reference instead rebuilt the
equation + solver objects and re-entered diffrax every step
(``pde_env.py:281-303``).  ``AdvectionDiffusionEnv`` restores the ghost
``"AdvectionDiffusion-v0"`` env the reference notebooks train against
(``notebooks/test_pde_env.ipynb`` cells 3-4, ``test_pde_RL.ipynb`` cells 3-6)
but which is absent from the reference package.

The adapters are deliberately thin: the scalable path is
:class:`pde_opt_jax.envs.vector_env.VectorPDEEnv` (batched, shardable); these
exist so a reference user's Gym/SB3 code runs unchanged.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Type

import gymnasium as gym
import numpy as np
import jax
import jax.numpy as jnp
from gymnasium import spaces
from gymnasium.envs.registration import register, registry

from .. import grid as domains
from ..models.advection_diffusion import AdvectionDiffusion2D
from ..ops.integrate import evolve
from ..ops.steppers import RK4
from ..utils.compat import check_equation_solver_compatibility, prepare_solver_params

__all__ = ["PDEEnv", "AdvectionDiffusionEnv"]


def _register_once(env_id: str, entry_point: str):
    if env_id not in registry:
        register(id=env_id, entry_point=entry_point)


_register_once("PDEEnv-v0", "pde_opt_jax.envs.gym_adapter:PDEEnv")
_register_once("AdvectionDiffusion-v0", "pde_opt_jax.envs.gym_adapter:AdvectionDiffusionEnv")


class PDEEnv(gym.Env):
    """Gymnasium RL environment controlling one PDE parameter.

    Constructor signature matches the reference (``pde_env.py:43-138``).
    ``reset_func(domain[, seed])`` runs host-side at reset (as in the
    reference); the step path is one jitted call whose control value is a
    traced argument, so new control values never retrace.
    """

    metadata = {"render_modes": []}

    def __init__(
        self,
        equation_type,
        domain: domains.Domain,
        solver_type,
        end_time: float,
        step_dt: float,
        numeric_dt: float,
        state_to_observation_func: Callable,
        reward_function: Callable,
        reset_func: Callable,
        reset_control_value,
        update_control_value: Callable,
        update_control_parameter: Callable,
        action_space_config: Dict[str, Any],
        static_equation_parameters: Dict[str, Any],
        control_equation_parameter_name: str,
        solver_parameters: Dict[str, Any],
    ):
        super().__init__()
        self.equation_type = equation_type
        self.domain = domain
        self.solver_type = solver_type
        check_equation_solver_compatibility(solver_type, equation_type)

        self.end_time = end_time
        self.step_dt = step_dt
        self.numeric_dt = numeric_dt
        self.n_substeps = max(1, int(round(step_dt / numeric_dt)))
        self.dt_sub = step_dt / self.n_substeps
        self.reward_function = reward_function
        self.reset_func = reset_func
        self.state_to_observation_func = state_to_observation_func

        self.observation_space = spaces.Box(
            low=0.0, high=255.0, shape=(1, *self.domain.points), dtype=np.uint8
        )
        self._setup_action_space(action_space_config)

        self.reset_control_value = reset_control_value
        self.update_control_value = update_control_value
        self.update_control_parameter = update_control_parameter
        self.static_equation_parameters = static_equation_parameters
        self.control_equation_parameter_name = control_equation_parameter_name
        self.solver_parameters = solver_parameters

        # One jitted macro-step: (y, old_cv, new_cv, t) -> (y1, reward).
        # Equation/solver construction happens once at trace time; the
        # control values are traced arguments.
        @jax.jit
        def _step_core(y, old_cv, new_cv, t0):
            control_param = self.update_control_parameter(old_cv, new_cv)
            eq = self.equation_type(
                domain=self.domain,
                **{
                    **self.static_equation_parameters,
                    self.control_equation_parameter_name: control_param,
                },
            )
            solver = self.solver_type(
                **prepare_solver_params(self.solver_type, self.solver_parameters, eq)
            )
            y1 = evolve(solver, eq.rhs, y, t0, self.dt_sub, self.n_substeps)
            return y1

        self._step_core = _step_core

    def _setup_action_space(self, config: Dict[str, Any]):
        """Continuous Box or Discrete with mapping (reference ``pde_env.py:140-170``)."""
        action_type = config.get("type", "continuous")
        if action_type == "discrete":
            num_actions = config.get("num_actions", 5)
            self.action_space = spaces.Discrete(num_actions)
            self._action_to_direction = config.get("action_mapping", {})
        else:
            action_shape = config.get("shape", (2,))
            low = config.get("low", -1.0)
            high = config.get("high", 1.0)
            self.action_space = spaces.Box(low=low, high=high, shape=action_shape)
            self._action_to_direction = None

    def _get_obs(self):
        return np.asarray(self.state_to_observation_func(self._state))

    def _get_info(self):
        return {}

    def _terminate(self):
        return self._time >= self.end_time

    def reset(self, seed: Optional[int] = None, options: Optional[dict] = None):
        super().reset(seed=seed)
        if seed is not None:
            self._state = self.reset_func(self.domain, seed=seed)
        else:
            self._state = self.reset_func(self.domain)
        self._time = 0.0
        self._control_value = self.reset_control_value
        return self._get_obs(), self._get_info()

    def step(self, action):
        offset = (
            action
            if not self._action_to_direction
            else self._action_to_direction[action]
        )
        old_cv = self._control_value
        self._control_value = self.update_control_value(offset, old_cv)

        self._state = self._step_core(
            self._state,
            jnp.asarray(old_cv, dtype=jnp.float32),
            jnp.asarray(self._control_value, dtype=jnp.float32),
            jnp.float32(self._time),
        )
        self._time += self.step_dt

        obs = self._get_obs()
        reward = float(self.reward_function(self._state))
        return obs, reward, self._terminate(), False, self._get_info()


class AdvectionDiffusionEnv(PDEEnv):
    """``AdvectionDiffusion-v0``: agent steers a uniform advection velocity.

    Restores the legacy env surface the reference notebooks use
    (kwargs ``reset_func, diffusion_coefficient, max_control_step, end_time,
    step_dt, numeric_dt, domain, field_dim, reward_function,
    discrete_action_space`` — ``test_pde_env.ipynb`` cell 3).  The control
    value is the 2-vector velocity ``(vx, vy)``; actions nudge it by up to
    ``max_control_step`` (continuous) or by fixed offsets (discrete 5-way:
    no-op / ±x / ±y).
    """

    def __init__(
        self,
        reset_func: Callable,
        diffusion_coefficient: float,
        max_control_step: float,
        end_time: float,
        step_dt: float,
        numeric_dt: float,
        domain: domains.Domain,
        field_dim: int = 1,
        reward_function: Callable = lambda x: 0.0,
        discrete_action_space: bool = False,
    ):
        m = float(max_control_step)
        if discrete_action_space:
            action_space_config = {
                "type": "discrete",
                "num_actions": 5,
                "action_mapping": {
                    0: np.array([0.0, 0.0], np.float32),
                    1: np.array([m, 0.0], np.float32),
                    2: np.array([-m, 0.0], np.float32),
                    3: np.array([0.0, m], np.float32),
                    4: np.array([0.0, -m], np.float32),
                },
            }
            update_control_value = lambda offset, old: np.asarray(old) + np.asarray(offset)
        else:
            action_space_config = {"type": "continuous", "shape": (2,),
                                   "low": -1.0, "high": 1.0}
            update_control_value = (
                lambda offset, old: np.asarray(old) + m * np.asarray(offset)
            )

        def update_control_parameter(old_cv, new_cv):
            # Velocity field callable from the traced control 2-vector.
            return lambda t, X, Y: (new_cv[..., 0], new_cv[..., 1])

        def obs_fn(state):
            return jnp.clip(state * 255.0, 0, 255).astype(jnp.uint8)[None]

        super().__init__(
            equation_type=AdvectionDiffusion2D,
            domain=domain,
            solver_type=RK4,
            end_time=end_time,
            step_dt=step_dt,
            numeric_dt=numeric_dt,
            state_to_observation_func=obs_fn,
            reward_function=reward_function,
            reset_func=reset_func,
            reset_control_value=np.zeros(2, np.float32),
            update_control_value=update_control_value,
            update_control_parameter=update_control_parameter,
            action_space_config=action_space_config,
            static_equation_parameters={"diffusion_coeff": diffusion_coefficient},
            control_equation_parameter_name="velocity",
            solver_parameters={},
        )
