"""Vectorized pure-JAX PDE control environments.

The on-device re-design of the reference RL loop
(``/root/reference/pde_opt/pde_env.py:217-317``).  The reference holds one
env instance on the host and, **every RL step**, rebuilds the equation and
solver objects, re-jits the rhs, and calls a fresh ``diffeqsolve``
(``pde_env.py:281-303``) — with numpy crossing the host↔device boundary both
ways.  Here the whole environment is two pure functions over a batched state
pytree:

    ``reset(key)                -> (EnvState, obs)``
    ``step(state, actions)      -> (EnvState, obs, reward, terminated, truncated, info)``

jitted once; the control enters as a *traced* value (changing it never
retraces), an RL macro-step of ``step_dt/numeric_dt`` substeps is one
``lax.scan``, and thousands of envs step in lockstep through the
batch-transparent equations.  ``rollout`` fuses entire episodes on device —
zero host round-trips.
Sharding over a device mesh wraps these same functions with ``shard_map``
(:mod:`pde_opt_jax.parallel.sharded_env`).
"""

from __future__ import annotations

from functools import partial
from typing import Any, Callable, Dict, NamedTuple, Optional, Type

import jax
import jax.numpy as jnp
import numpy as np

from .. import grid as domains
from ..ops.integrate import evolve
from ..utils.compat import check_equation_solver_compatibility, prepare_solver_params

__all__ = ["EnvState", "VectorPDEEnv"]


class EnvState(NamedTuple):
    """Per-env state pytree (leading axis = env batch)."""

    y: jax.Array            # (B, *points[, channels]) PDE field
    t: jax.Array            # (B,) episode time
    control_value: Any      # (B, ...) current control value(s)
    key: jax.Array          # (B,) PRNG keys
    step_count: jax.Array   # (B,) int32
    done: jax.Array         # (B,) bool — episode ended at previous step


class VectorPDEEnv:
    """Batched PDE control environment (pure functions, jit/vmap/shard-ready).

    Constructor mirrors the reference ``PDEEnv.__init__``
    (``pde_env.py:43-138``) with the host-side callables replaced by
    jax-pure ones:

    Args:
        equation_type, domain, solver_type: as in :class:`PDEModel`.
        end_time: episode length in simulation time.
        step_dt: simulation time per RL step.
        numeric_dt: substep size; ``round(step_dt/numeric_dt)`` substeps are
            fused into one scan per RL step.
        state_to_observation_func: ``state -> obs`` (jax, pointwise/batched).
        reward_function: ``state -> scalar`` per env (jax).
        reset_func: ``(domain, key) -> y0`` (jax; key-seeded, vmapped).
        reset_control_value: initial control value (any pytree of arrays).
        update_control_value: ``(action_offset, old_value) -> new_value``.
        update_control_parameter: ``(old_value, new_value) -> equation param``
            — may return a traced array or a callable capturing traced
            values (e.g. a ``lights(t,x,y)`` control field).
        action_space_config: ``{"type": "continuous"|"discrete", ...}`` as in
            the reference (``pde_env.py:140-170``); discrete mappings become
            a device-side lookup table.
        static_equation_parameters: fixed equation params.
        control_equation_parameter_name: the equation kwarg the agent drives.
        solver_parameters: stepper kwargs (auto-completed from the equation).
        num_envs: batch size B.
        auto_reset: if True, envs that terminate are reset in the same call
            (lockstep fleets never stall); the pre-reset terminal observation
            is returned in ``info["final_observation"]``.
    """

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
        num_envs: int = 1,
        auto_reset: bool = True,
        vectorized_control: bool = False,
        fused_epilogue: Optional[Dict[str, Any]] = None,
    ):
        self.equation_type = equation_type
        self.domain = domain
        self.solver_type = solver_type
        check_equation_solver_compatibility(solver_type, equation_type)

        self.end_time = float(end_time)
        self.step_dt = float(step_dt)
        self.numeric_dt = float(numeric_dt)
        self.n_substeps = max(1, int(round(self.step_dt / self.numeric_dt)))
        self.dt_sub = self.step_dt / self.n_substeps
        self.max_episode_steps = int(np.ceil(self.end_time / self.step_dt))

        self.state_to_observation_func = state_to_observation_func
        self.reward_function = reward_function
        self.reset_func = reset_func
        self.reset_control_value = reset_control_value
        self.update_control_value = update_control_value
        self.update_control_parameter = update_control_parameter
        self.static_equation_parameters = static_equation_parameters
        self.control_equation_parameter_name = control_equation_parameter_name
        self.solver_parameters = solver_parameters
        self.num_envs = num_envs
        self.auto_reset = auto_reset
        # vectorized_control: advance the whole fleet through ONE
        # batch-transparent equation instead of vmapping a per-env core.
        # Requires (a) update_control_value/update_control_parameter to be
        # batch-aware (e.g. reshape a (B,) control to (B,1,1) so it
        # broadcasts against (B,H,W) fields) and (b) a time-autonomous rhs.
        # This is the fast path: it admits fused whole-fleet kernels.
        self.vectorized_control = vectorized_control
        # fused_epilogue: opt-in fast path — the fused kernel itself
        # emits per-env [sum, sumsq, n_finite] stats and the uint8
        # observation while the final field is still on chip, and the
        # step derives reward/divergence/obs from those instead of
        # re-reading the full field from device memory 2-3 more times.
        # Keys: obs_scale, obs_offset, obs_downsample, stats_center (kernel
        # contract, ops/cas_spectral.make_ch_cas_fused_macro),
        # reward_from_stats: (s1, s2, n_finite, n_px) -> per-env reward,
        # obs_transform: kernel obs -> observation pytree (default adds the
        # leading channel axis).  The preset that installs this MUST keep
        # reward_function / state_to_observation_func semantically
        # equivalent: they still serve reset() and the auto-reset branch.
        if fused_epilogue is not None and not vectorized_control:
            raise ValueError("fused_epilogue requires vectorized_control")
        self.fused_epilogue = fused_epilogue

        cfg = dict(action_space_config)
        self.action_type = cfg.get("type", "continuous")
        if self.action_type == "discrete":
            self.num_actions = cfg.get("num_actions", 5)
            mapping = cfg.get("action_mapping", {})
            if mapping:
                self._action_table = jnp.stack(
                    [jnp.asarray(mapping[i], dtype=jnp.float32)
                     for i in range(len(mapping))]
                )
            else:
                self._action_table = jnp.zeros((self.num_actions, 1), jnp.float32)
        else:
            self.action_shape = tuple(cfg.get("shape", (2,)))
            self.action_low = cfg.get("low", -1.0)
            self.action_high = cfg.get("high", 1.0)
        self.action_space_config = cfg

        # jit once; donate the state for in-place HBM reuse across steps.
        self._reset = jax.jit(self._reset_impl)
        self._step = jax.jit(self._step_impl, donate_argnums=(0,))

    # ------------------------------------------------------------------
    # single-env cores (vmapped over the env batch)
    # ------------------------------------------------------------------
    def _reset_single(self, key):
        reset_key, carry_key = jax.random.split(key)
        y0 = self.reset_func(self.domain, reset_key)
        cv = jax.tree_util.tree_map(
            lambda v: jnp.asarray(v, dtype=jnp.float32), self.reset_control_value
        )
        return y0, cv, carry_key

    def _advance_single(self, y, cv, action, t0):
        """One RL macro-step for one env: control update + fused substeps."""
        offset = action
        if self.action_type == "discrete":
            offset = self._action_table[action]
        new_cv = self.update_control_value(offset, cv)
        control_param = self.update_control_parameter(cv, new_cv)
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
        return y1, new_cv

    # ------------------------------------------------------------------
    # batched implementations
    # ------------------------------------------------------------------
    def _reset_impl(self, key) -> tuple:
        keys = jax.random.split(key, self.num_envs)
        y0, cv, carry_keys = jax.vmap(self._reset_single)(keys)
        B = self.num_envs
        state = EnvState(
            y=y0,
            t=jnp.zeros((B,), jnp.float32),
            control_value=cv,
            key=carry_keys,
            step_count=jnp.zeros((B,), jnp.int32),
            done=jnp.zeros((B,), bool),
        )
        return state, self.state_to_observation_func(state.y)

    def _check_control_batch(self, new_cv, old_cv, B):
        """Trace-time contract check on ``update_control_value`` output.

        The control value is a scan-carry: its leaf shapes MUST be stable
        step to step, and the reset path already batches it to
        ``(B, ...)``.  Checking new-vs-old shape equality catches the
        classic mis-broadcast — ``old + off`` instead of
        ``old + off[..., 0]`` turning a ``(B,)`` control into ``(B, B)``
        (whose leading dim still equals ``B``, so a leading-dim-only
        check passes it) — while permitting arbitrary legitimate
        multi-component controls (e.g. a ``(B, 2)`` stirrer position),
        which simply keep the shape their reset gave them.  ``B`` is the
        leading dim of the state actually being advanced (a per-device
        shard under ``shard_map`` — not ``self.num_envs``).
        """
        new_td = jax.tree_util.tree_structure(new_cv)
        old_td = jax.tree_util.tree_structure(old_cv)
        if new_td != old_td:
            raise ValueError(
                "update_control_value changed the control pytree "
                f"structure ({old_td} -> {new_td}); the control is a "
                "scan carry and must keep its structure."
            )
        new_leaves = jax.tree_util.tree_leaves(new_cv)
        old_leaves = jax.tree_util.tree_leaves(old_cv)
        for new, old in zip(new_leaves, old_leaves):
            ns, os_ = jnp.shape(new), jnp.shape(old)
            if ns != os_:
                raise ValueError(
                    f"update_control_value produced shape {ns} from a "
                    f"{os_} control (env batch {B}).  The control value "
                    "is a scan carry and must keep its per-env shape; a "
                    "common cause is broadcasting the raw (B, k) action "
                    "offset against the (B,) control (use off[..., 0])."
                )

    def _advance_batched(self, y, cv, actions, ep_cfg=None):
        """Whole-fleet macro-step through one batch-transparent equation.

        With ``ep_cfg`` (the ``fused_epilogue`` config) the solver's
        ``evolve_with_epilogue`` hook is used and ``(y1, new_cv, stats,
        obs)`` is returned; otherwise ``(y1, new_cv)``.
        """
        offset = actions
        if self.action_type == "discrete":
            offset = self._action_table[actions]
        new_cv = self.update_control_value(offset, cv)
        self._check_control_batch(new_cv, cv, y.shape[0])
        control_param = self.update_control_parameter(cv, new_cv)
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
        if ep_cfg is not None:
            own = getattr(solver, "evolve_with_epilogue", None)
            if own is None:
                raise TypeError(
                    f"{type(solver).__name__} does not support "
                    "fused_epilogue (no evolve_with_epilogue hook)"
                )
            y1, stats, obs = own(
                eq.rhs, y, 0.0, self.dt_sub, self.n_substeps, ep_cfg
            )
            if y1.shape != y.shape:
                raise ValueError(
                    f"macro-step changed the state shape {y.shape} -> "
                    f"{y1.shape} (check update_control_parameter)"
                )
            return y1, new_cv, stats, obs
        y1 = evolve(solver, eq.rhs, y, 0.0, self.dt_sub, self.n_substeps)
        if y1.shape != y.shape:
            raise ValueError(
                f"macro-step changed the state shape {y.shape} -> "
                f"{y1.shape}: a control parameter broadcast against the "
                "fleet (check update_control_parameter's output shape)"
            )
        return y1, new_cv

    def _step_impl(self, state: EnvState, actions):
        ep = self.fused_epilogue
        if ep is not None:
            # Fused epilogue: the kernel itself emitted per-env
            # [sum, sumsq, n_finite] and the uint8 obs — reward and the
            # divergence flag are derived from those scalars, so the step
            # adds NO extra full-field passes over the state write.
            y1, cv1, stats, obs_k = self._advance_batched(
                state.y, state.control_value, actions, ep_cfg=ep
            )
            # n_px: what the kernel's finite-count counts — H*W grid
            # pixels by default; states with extra trailing axes (e.g. the
            # GPE real-stacked (H, W, 2)) override it in the config.
            n_px = ep.get("n_px") or (y1.shape[-2] * y1.shape[-1])
            s1, s2, cnt = stats[..., 0], stats[..., 1], stats[..., 2]
            diverged = cnt < (n_px - 0.5)
            reward = ep["reward_from_stats"](s1, s2, cnt, n_px)
            reward = jnp.where(diverged, jnp.zeros_like(reward), reward)
            obs = ep.get("obs_transform", lambda o: o[..., None, :, :])(obs_k)
            t1 = state.t + self.step_dt
            steps1 = state.step_count + 1
            terminated = (t1 >= self.end_time - 1e-9) | diverged
            if not self.auto_reset:
                # Without auto-reset the caller keeps stepping the fleet:
                # scrub NaN fields as the XLA path does.  (Under
                # auto_reset the reset branch below replaces diverged
                # fields wholesale — no scrub pass needed.)
                y1 = jnp.where(
                    diverged.reshape((-1,) + (1,) * (y1.ndim - 1)),
                    jnp.zeros_like(y1), y1,
                )
            info = {"diverged": diverged}
        else:
            if self.vectorized_control:
                y1, cv1 = self._advance_batched(
                    state.y, state.control_value, actions
                )
            else:
                y1, cv1 = jax.vmap(self._advance_single)(
                    state.y, state.control_value, actions, state.t
                )
            t1 = state.t + self.step_dt
            steps1 = state.step_count + 1
            # Per-env divergence mask: a non-finite field terminates (and,
            # under auto_reset, resets) that env without stalling the
            # lockstep fleet — the env-fleet analog of elastic failure
            # recovery.
            diverged = ~jnp.isfinite(y1).reshape(y1.shape[0], -1).all(axis=1)
            terminated = (t1 >= self.end_time - 1e-9) | diverged
            reward = jax.vmap(self.reward_function)(y1)
            reward = jnp.where(diverged, jnp.zeros_like(reward), reward)
            # Scrub NaNs so downstream obs/learner code never sees them.
            y1 = jnp.where(
                diverged.reshape((-1,) + (1,) * (y1.ndim - 1)),
                jnp.zeros_like(y1), y1,
            )
            obs = self.state_to_observation_func(y1)
            info = {"diverged": diverged}

        if self.auto_reset:
            # The reset work (fleet-wide RNG field generation + selects +
            # re-observation) is by far the most expensive non-physics part
            # of a step, yet terminations are rare in lockstep fleets (once
            # per episode, plus divergences).  Gate it behind a fleet-level
            # cond: per-env outputs are bitwise identical either way (when
            # ``terminated[i]`` is False the env takes the ``y1`` path), so
            # the common no-termination step skips the entire block.
            def _with_resets(_):
                new_keys = jax.vmap(lambda k: jax.random.split(k)[0])(state.key)
                reset_y, reset_cv, carry_keys = jax.vmap(self._reset_single)(
                    new_keys
                )

                def where_done(a, b):
                    d = terminated.reshape((-1,) + (1,) * (a.ndim - 1))
                    return jnp.where(d, a, b)

                y_next = where_done(reset_y, y1)
                cv_next = jax.tree_util.tree_map(where_done, reset_cv, cv1)
                key_next = where_done(carry_keys, state.key)
                # Observe ONLY the reset fields and select against the
                # step's own obs: non-terminated envs keep the exact obs
                # this step emitted (bitwise — under the fused epilogue
                # the kernel's pooled obs differs from the XLA pooling by
                # up to 1 uint8 LSB, so re-observing y_next wholesale
                # would let one env's termination perturb every other
                # env's observation).
                obs_reset = self.state_to_observation_func(reset_y)
                obs_next = jax.tree_util.tree_map(where_done, obs_reset, obs)
                return (y_next, cv_next, key_next, obs_next)

            def _no_resets(_):
                return y1, cv1, state.key, obs

            y_next, cv_next, key_next, obs_next = jax.lax.cond(
                terminated.any(), _with_resets, _no_resets, None
            )
            t_next = jnp.where(terminated, 0.0, t1)
            steps_next = jnp.where(terminated, 0, steps1)
            info = {"final_observation": obs, "diverged": diverged}
            obs = obs_next
            next_state = EnvState(
                y=y_next, t=t_next, control_value=cv_next,
                key=key_next, step_count=steps_next,
                done=jnp.zeros_like(terminated),
            )
        else:
            next_state = EnvState(
                y=y1, t=t1, control_value=cv1,
                key=state.key, step_count=steps1, done=terminated,
            )

        truncated = jnp.zeros_like(terminated)
        # Pin dtypes to the incoming state so scan carries stay type-stable
        # regardless of action dtype / x64 promotion.
        next_state = jax.tree_util.tree_map(
            lambda new, old: new.astype(old.dtype), next_state, state
        )
        # Pin the observation the same way: obs was computed from the
        # pre-pinning field, but rollout scans carry it alongside the pinned
        # state, so it must match what observing the pinned state yields.
        obs_sd = jax.eval_shape(self.state_to_observation_func, next_state.y)
        obs = jax.tree_util.tree_map(
            lambda o, s: o.astype(s.dtype), obs, obs_sd
        )
        return next_state, obs, reward, terminated, truncated, info

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------
    def reset(self, key):
        """Reset all envs from one PRNG key. Returns ``(EnvState, obs)``."""
        return self._reset(key)

    def step(self, state: EnvState, actions):
        """Advance all envs one RL step (jitted, donated state)."""
        return self._step(state, actions)

    def sample_actions(self, key):
        """Uniform random actions for the whole batch (for benchmarks/tests)."""
        if self.action_type == "discrete":
            return jax.random.randint(key, (self.num_envs,), 0, self.num_actions)
        return jax.random.uniform(
            key, (self.num_envs, *self.action_shape),
            minval=self.action_low, maxval=self.action_high,
        )

    def make_rollout(self, policy_fn: Callable, n_steps: int):
        """Compile an ``n_steps`` on-device rollout: zero host round-trips.

        ``policy_fn(obs, key) -> actions``.  Returns a jitted
        ``rollout(state, key) -> (state, rewards, terminateds)`` with the
        state buffer donated — steady-state HBM use is one fleet.
        """

        def body(carry, _):
            st, obs, k = carry
            k, ak = jax.random.split(k)
            actions = policy_fn(obs, ak)
            st, obs, reward, terminated, truncated, _ = self._step_impl(st, actions)
            return (st, obs, k), (reward, terminated)

        @partial(jax.jit, donate_argnums=(0,))
        def run(state, key):
            # The obs a step returns IS the next state's observation; carry
            # it so each state is observed exactly once per step.
            obs0 = self.state_to_observation_func(state.y)
            (state, _, _), (rewards, terms) = jax.lax.scan(
                body, (state, obs0, key), None, length=n_steps
            )
            return state, rewards, terms

        return run

    def rollout(self, state: EnvState, policy_fn: Callable, n_steps: int,
                key: Optional[jax.Array] = None):
        """Run ``n_steps`` on device (cached compile per (policy_fn, n_steps))."""
        if key is None:
            key = jax.random.PRNGKey(0)
        cache_key = (id(policy_fn), n_steps)
        cache = getattr(self, "_rollout_cache", None)
        if cache is None:
            cache = self._rollout_cache = {}
        if cache_key not in cache:
            # Hold a reference to policy_fn so its id stays unique; bound
            # the cache so per-iteration lambdas (fresh id every call)
            # cannot leak one compiled executable + closure per step —
            # use make_rollout directly for long-lived reuse.
            while len(cache) >= 8:
                cache.pop(next(iter(cache)))
            cache[cache_key] = (self.make_rollout(policy_fn, n_steps), policy_fn)
        run, _ = cache[cache_key]
        return run(state, key)
