"""Device-mesh construction and sharding helpers.

The reference has no multi-device support whatsoever (grep census in
SURVEY.md §2.3).  Here the scaling axis for PDE control workloads is the
**env batch**: thousands of lockstep env instances shard over a 1D ``"env"``
mesh axis (pure data parallelism over the interconnect); the learner is co-located
and reduces gradients with ``psum``.  Spatial decomposition of a single huge
grid — the PDE analog of sequence parallelism — lives in
:mod:`pde_opt_jax.parallel.halo`.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from jax import shard_map as _shard_map


def shard_map(f, mesh, in_specs, out_specs, check_vma: bool = True):
    """``jax.shard_map`` with an opt-out of the varying-manual-axes checker.

    Pass ``check_vma=False`` ONLY for regions whose *gradient* flows
    through ``jnp.fft.rfft``/``irfft``: the VMA checker has a bug in the
    transpose rule of the rfft/irfft primitives (cotangent vma mismatch:
    "expected ShapedArray(c64[...]) but got JitTracer(c64[...]{V:env})"),
    which breaks ``jax.grad`` through any rfft-based spectral stepper inside
    ``shard_map``.  Disabling the checker there restores classic shard_map
    semantics (out_specs trusted, collectives still correct).  Everywhere
    else the checker stays ON.
    """
    return _shard_map(
        f, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
        check_vma=check_vma,
    )


__all__ = ["make_mesh", "env_sharding", "replicated_sharding", "shard_map"]


def init_distributed(coordinator_address=None, num_processes=None,
                     process_id=None, **kwargs):
    """Initialize multi-host JAX (thin ``jax.distributed.initialize`` wrapper).

    The multi-host entry point for pod-scale runs (SURVEY.md §5: the
    reference has no distributed backend at all).  No-op when already
    initialized or when called single-process with no coordinator — so the
    same training script runs unchanged on one host.  After this,
    ``jax.devices()`` spans the slice and :func:`make_mesh` can lay a global
    mesh over it (env-fleet axis over the interconnect).
    """
    import jax as _jax

    if coordinator_address is None and num_processes is None:
        return  # single-process run
    try:
        _jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
            **kwargs,
        )
    except RuntimeError as e:  # already initialized
        if "already" not in str(e).lower():
            raise


def make_mesh(
    devices: Optional[Sequence[jax.Device]] = None,
    axis_names: Sequence[str] = ("env",),
    shape: Optional[Sequence[int]] = None,
) -> Mesh:
    """Build a named device mesh (default: all devices on one ``"env"`` axis)."""
    if devices is None:
        devices = jax.devices()
    devices = np.asarray(devices)
    if shape is None:
        shape = (len(devices),) + (1,) * (len(axis_names) - 1)
    return Mesh(devices.reshape(shape), axis_names=tuple(axis_names))


def env_sharding(mesh: Mesh, axis: str = "env") -> NamedSharding:
    """Sharding that splits the leading (env-batch) axis across ``axis``."""
    return NamedSharding(mesh, P(axis))


def replicated_sharding(mesh: Mesh) -> NamedSharding:
    """Fully replicated sharding (policy/learner parameters)."""
    return NamedSharding(mesh, P())
