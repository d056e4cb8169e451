"""RL environments: batched pure-JAX core + Gymnasium adapters.

The Gymnasium adapters (``PDEEnv``, ``AdvectionDiffusionEnv``) are imported
on first access, so only their users need ``gymnasium`` installed.
"""

from .vector_env import EnvState, VectorPDEEnv
from .presets import (
    make_allen_cahn_control_env,
    make_butler_volmer_control_env,
    make_cahn_hilliard_control_env,
    make_gpe_control_env,
    make_gpe_rot_control_env,
    make_sbm_butler_volmer_control_env,
)

__all__ = [
    "EnvState",
    "VectorPDEEnv",
    "PDEEnv",
    "AdvectionDiffusionEnv",
    "make_allen_cahn_control_env",
    "make_butler_volmer_control_env",
    "make_cahn_hilliard_control_env",
    "make_gpe_control_env",
    "make_gpe_rot_control_env",
    "make_sbm_butler_volmer_control_env",
]


_GYM_ADAPTERS = ("PDEEnv", "AdvectionDiffusionEnv")


def __getattr__(name):
    if name in _GYM_ADAPTERS:
        from . import gym_adapter

        return getattr(gym_adapter, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
