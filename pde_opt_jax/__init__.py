"""pde_opt_jax — an accelerator-native PDE-control / PDE-optimization framework.

A from-scratch re-imagining of the capabilities of ``acoh64/pde-opt``
(phase-field and quantum PDE solvers, differentiable inverse problems /
optimal control, RL environments over PDEs) designed accelerator-first:

* every RHS/stepper is a pure function over batched state pytrees — spatial
  axes trail, batch axes lead, one fused XLA region steps thousands of env
  instances in lockstep;
* time integration is ``lax.scan``/``while_loop`` based (no host loop), with
  forward-mode and checkpointed reverse-mode differentiation through rollouts;
* env fleets shard across a ``jax.sharding.Mesh`` via ``shard_map``
  (:mod:`pde_opt_jax.parallel`), with a co-located learner;
* the flagship Cahn-Hilliard macro-step has a Pallas (Triton) kernel for
  the GPU (:mod:`pde_opt_jax.ops.cas_spectral`); everything else is XLA.

The public API covers everything a user of the reference package finds in
``pde_opt`` (same class names and call surfaces; reference file:line
citations in each docstring), plus the batched/sharded on-device layers.
"""

from .grid import Domain, Grid
from .geometry import Shape
from .models import (
    AdvectionDiffusion2D,
    AllenCahn2DPeriodic,
    AllenCahn2DSmoothedBoundary,
    AllenCahn2DPeriodicButlerVolmer,
    AllenCahn2DPeriodicButlerVolmerConstantCurrent,
    AllenCahn2DSmoothedBoundaryButlerVolmerConstantCurrent,
    BaseEquation,
    CahnHilliard2DPeriodic,
    CahnHilliard2DSmoothedBoundary,
    CahnHilliard3DPeriodic,
    GPE2DTSControl,
    GPE2DTSRot,
    TimeSplittingEquation,
)
from .models.functions import (
    ChemicalPotentialLegendrePolynomials,
    DiffusionLegendrePolynomials,
    LegendrePolynomialExpansion,
    LegendrePolynomialExpansion2D,
    Mixer2d,
    PeriodicCNN,
)
from .ops import (
    DirectionalSplitting,
    Euler,
    Heun,
    ImplicitEuler,
    RK4,
    SemiImplicitFourierSpectral,
    StrangSplitting,
    Tsit5,
    evolve,
    integrate,
    integrate_adaptive,
)
from .models.pde_model import PDEModel, OptimizationModel
from .envs import VectorPDEEnv
from . import rl

__all__ = [
    # Core classes
    "PDEModel",
    "OptimizationModel",
    "PDEEnv",
    "VectorPDEEnv",
    # Equations
    "BaseEquation",
    "TimeSplittingEquation",
    "AdvectionDiffusion2D",
    "AllenCahn2DPeriodic",
    "AllenCahn2DSmoothedBoundary",
    "AllenCahn2DPeriodicButlerVolmer",
    "AllenCahn2DPeriodicButlerVolmerConstantCurrent",
    "AllenCahn2DSmoothedBoundaryButlerVolmerConstantCurrent",
    "CahnHilliard2DPeriodic",
    "CahnHilliard3DPeriodic",
    "CahnHilliard2DSmoothedBoundary",
    "GPE2DTSControl",
    "GPE2DTSRot",
    # Domains and Shapes
    "Domain",
    "Grid",
    "Shape",
    # Functions
    "PeriodicCNN",
    "LegendrePolynomialExpansion",
    "LegendrePolynomialExpansion2D",
    "DiffusionLegendrePolynomials",
    "ChemicalPotentialLegendrePolynomials",
    "Mixer2d",
    # Solvers / integration
    "Euler",
    "Heun",
    "RK4",
    "Tsit5",
    "SemiImplicitFourierSpectral",
    "StrangSplitting",
    "DirectionalSplitting",
    "ImplicitEuler",
    "evolve",
    "integrate",
    "integrate_adaptive",
]

__version__ = "0.1.0"


def __getattr__(name):
    # The Gymnasium adapter loads on first use: only its users need gymnasium.
    if name == "PDEEnv":
        from .envs import PDEEnv

        return PDEEnv
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
