"""Base equation protocols.

Mirrors the abstract surface of the reference
(``/root/reference/pde_opt/numerics/equations/base_eq.py:11-51``) with one
One rule added: **an equation's ``rhs`` must be a pure function of
``(state, t)`` that treats all leading axes of ``state`` as batch axes.**
Equations are constructed at trace time (cheap Python; spectral meshes fold
into compile-time constants under jit) and their ``rhs`` inlines into
``lax.scan`` steppers — never re-jitted per call the way the reference
re-jits per diffeqsolve (``pde_model.py:122``, ``pde_env.py:294``).
"""

from __future__ import annotations

from typing import TypeVar

State = TypeVar("State")


class BaseEquation:
    """Time-dependent PDE: ``d(state)/dt = rhs(state, t)``.

    Subclasses implement ``rhs`` (pure, batch-transparent).  Spectral
    equations additionally expose ``fourier_symbol``, ``fft``, ``ifft`` for
    the semi-implicit stepper contract; split equations expose ``A_term`` /
    ``B_terms`` (see :mod:`pde_opt_jax.utils.compat`).
    """

    def rhs(self, state: State, t: float) -> State:
        """Right-hand side of the equation (batch axes lead, spatial trail)."""
        raise NotImplementedError("rhs method not implemented")


class TimeSplittingEquation(BaseEquation):
    """Equation with separable operators: ``d(state)/dt = A(state,t) + B(state,t)``.

    ``A`` is diagonal in Fourier space (handled exactly by the split-step
    exponential), ``B`` is pointwise in real space.
    """

    def A_terms(self, state: State, t: float) -> State:
        raise NotImplementedError("A_terms method not implemented")

    def B_terms(self, state: State, t: float) -> State:
        raise NotImplementedError("B_terms method not implemented")
