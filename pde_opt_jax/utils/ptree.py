"""Pytree partition/combine utilities.

Replacement for the pytree bookkeeping the reference delegates to
``equinox`` (``eqx.partition`` / ``eqx.combine`` / ``eqx.is_inexact_array_like``,
used at ``/root/reference/pde_opt/pde_model.py:400-401,425,458`` and
``:527-529``).  Parameter dictionaries here may mix jax arrays, python floats,
callables and module pytrees; optimizers must see only the inexact-array
leaves while everything else is carried through statically.
"""

from __future__ import annotations

from typing import Any, Callable

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "as_arrays",
    "is_array_like",
    "is_inexact_array_like",
    "partition",
    "combine",
    "tree_size",
    "ravel_params",
]


def is_array_like(x: Any) -> bool:
    """True for jax/numpy arrays and python numbers."""
    return isinstance(x, (jax.Array, np.ndarray, float, complex, int, bool, np.generic))


def is_inexact_array_like(x: Any) -> bool:
    """True for floating/complex arrays and python floats/complex.

    Mirrors the filter the reference uses to split trainable leaves from
    static structure (``eqx.is_inexact_array_like``).
    """
    if isinstance(x, (jax.Array, np.ndarray, np.generic)):
        return jnp.issubdtype(x.dtype, jnp.inexact)
    return isinstance(x, (float, complex))


def partition(tree: Any, filter_fn: Callable[[Any], bool] = is_inexact_array_like):
    """Split ``tree`` into (dynamic, static) trees of the same structure.

    Leaves passing ``filter_fn`` stay in the dynamic tree (static side gets
    ``None``); all other leaves go to the static tree (dynamic side ``None``).
    ``combine(dynamic, static)`` inverts this.
    """
    dynamic = jax.tree_util.tree_map(
        lambda x: x if filter_fn(x) else None, tree, is_leaf=lambda x: x is None
    )
    static = jax.tree_util.tree_map(
        lambda x: None if filter_fn(x) else x, tree, is_leaf=lambda x: x is None
    )
    return dynamic, static


def as_arrays(tree: Any) -> Any:
    """Convert every non-None leaf to a jax array (optimizers need .shape)."""
    return jax.tree_util.tree_map(
        lambda x: None if x is None else jnp.asarray(x),
        tree,
        is_leaf=lambda x: x is None,
    )


def combine(dynamic: Any, static: Any) -> Any:
    """Inverse of :func:`partition`: take the non-None leaf at each position."""

    def _pick(d, s):
        return s if d is None else d

    return jax.tree_util.tree_map(
        _pick, dynamic, static, is_leaf=lambda x: x is None
    )


def tree_size(tree: Any) -> int:
    """Total number of scalar elements across array leaves."""
    return sum(
        np.size(leaf)
        for leaf in jax.tree_util.tree_leaves(tree)
        if is_array_like(leaf)
    )


def ravel_params(tree: Any):
    """Flatten the inexact-array leaves of ``tree`` into one 1D vector.

    Returns ``(vector, unravel)`` where ``unravel(vector)`` reconstructs the
    full tree (static leaves included).  Used by the Levenberg-Marquardt
    optimizer, which works on a flat parameter vector.
    """
    dynamic, static = partition(tree)
    flat, unflatten = jax.flatten_util.ravel_pytree(dynamic)

    def unravel(vec):
        return combine(unflatten(vec), static)

    return flat, unravel
