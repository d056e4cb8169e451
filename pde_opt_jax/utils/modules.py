"""Minimal pytree-module system.

The reference builds its learnable coefficient functions as ``equinox.Module``s
(``/root/reference/pde_opt/numerics/functions/*``) so that parameters are
pytree leaves the optimizer can see.  equinox is not part of this framework's
dependency set; this module provides the one primitive actually needed: a
class decorator registering instances as pytrees with declared data (leaf)
and static (aux) fields.

Usage::

    @module(data_fields=("params",), static_fields=("max_degree",))
    class LegendrePolynomialExpansion:
        def __init__(self, params):
            self.params = params
            self.max_degree = len(params) - 1

Instances then flow through ``jit``/``grad``/``vmap``/optax untouched; static
fields become hashable aux data (part of the jit cache key).  Unflattening
bypasses ``__init__`` so tree transforms never re-run constructor logic (and
tolerate ``None`` leaves during :func:`pde_opt_jax.utils.ptree.partition`).
"""

from __future__ import annotations

from typing import Sequence

import jax

__all__ = ["module"]


def module(data_fields: Sequence[str], static_fields: Sequence[str] = ()):
    """Class decorator: register as a pytree with the given leaf/static fields."""
    data_fields = tuple(data_fields)
    static_fields = tuple(static_fields)

    def wrap(cls):
        def flatten(obj):
            children = tuple(getattr(obj, f) for f in data_fields)
            aux = tuple(getattr(obj, f) for f in static_fields)
            return children, aux

        def flatten_with_keys(obj):
            children = tuple(
                (jax.tree_util.GetAttrKey(f), getattr(obj, f)) for f in data_fields
            )
            aux = tuple(getattr(obj, f) for f in static_fields)
            return children, aux

        def unflatten(aux, children):
            obj = object.__new__(cls)
            for f, v in zip(data_fields, children):
                object.__setattr__(obj, f, v)
            for f, v in zip(static_fields, aux):
                object.__setattr__(obj, f, v)
            return obj

        jax.tree_util.register_pytree_with_keys(
            cls, flatten_with_keys, unflatten, flatten_func=flatten
        )
        cls.__pde_opt_module__ = True
        cls.__module_data_fields__ = data_fields
        cls.__module_static_fields__ = static_fields
        return cls

    return wrap
