"""Numerical kernels: stencils, spectral ops, steppers, integration drivers."""

from . import stencils, spectral, boundary
from .steppers import (
    Euler,
    Heun,
    RK4,
    Tsit5,
    SemiImplicitFourierSpectral,
    FusedSemiImplicitSpectral,
    FusedMobilitySpectral,
    StrangSplitting,
    DirectionalSplitting,
    FusedRotatingSplitting,
    ImplicitEuler,
)
from .integrate import evolve, integrate, integrate_adaptive

__all__ = [
    "stencils",
    "spectral",
    "boundary",
    "Euler",
    "Heun",
    "RK4",
    "Tsit5",
    "SemiImplicitFourierSpectral",
    "FusedSemiImplicitSpectral",
    "FusedMobilitySpectral",
    "StrangSplitting",
    "DirectionalSplitting",
    "FusedRotatingSplitting",
    "ImplicitEuler",
    "evolve",
    "integrate",
    "integrate_adaptive",
]
