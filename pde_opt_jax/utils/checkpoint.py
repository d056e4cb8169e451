"""Checkpoint / resume.

The reference has no checkpointing (SURVEY.md §5: notebooks ``np.save`` raw
arrays and SB3 saves policies).  For resumable multi-host training the
framework checkpoints the full pytree — (params, optimizer state, env-state
batch, PRNG keys) — via orbax, the standard JAX checkpointing stack.
"""

from __future__ import annotations

import os
from typing import Any, Optional

import jax

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step"]


def _manager(directory: str, max_to_keep: int = 3):
    import orbax.checkpoint as ocp

    return ocp.CheckpointManager(
        os.path.abspath(directory),
        options=ocp.CheckpointManagerOptions(max_to_keep=max_to_keep),
    )


def save_checkpoint(directory: str, step: int, tree: Any,
                    max_to_keep: int = 3) -> None:
    """Save a pytree (arrays, scalars, nested containers) at ``step``."""
    import orbax.checkpoint as ocp

    mngr = _manager(directory, max_to_keep)
    mngr.save(step, args=ocp.args.StandardSave(tree))
    mngr.wait_until_finished()
    mngr.close()


def restore_checkpoint(directory: str, step: Optional[int] = None,
                       template: Any = None) -> Any:
    """Restore the pytree saved at ``step`` (default: latest).

    ``template`` (a matching pytree of arrays/ShapeDtypeStructs) restores
    with the original structure; without it, orbax returns plain nested
    dicts/lists of arrays.
    """
    import orbax.checkpoint as ocp

    mngr = _manager(directory)
    if step is None:
        step = mngr.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    if template is not None:
        out = mngr.restore(step, args=ocp.args.StandardRestore(template))
    else:
        out = mngr.restore(step)
    mngr.close()
    return out


def latest_step(directory: str) -> Optional[int]:
    """Latest checkpoint step under ``directory`` (None if empty)."""
    import orbax.checkpoint as ocp

    mngr = _manager(directory)
    step = mngr.latest_step()
    mngr.close()
    return step
