"""One place decides how a Pallas kernel of this package runs.

Every ``pallas_call`` here names the Triton route and asks
:func:`pallas_interpret` whether to interpret it:

* on ``"gpu"`` the kernel compiles for the card (never interpreted);
* on ``"cpu"`` it runs in Pallas interpret mode, which is how the tests
  exercise kernel arithmetic without a card;
* any other platform raises: there is no kernel for it, and the caller
  should pick the plain-XLA path instead (e.g. ``spectral_solve="fft"``).
"""

from __future__ import annotations

import jax

__all__ = ["pallas_interpret"]


def pallas_interpret() -> bool:
    """``False`` on the GPU (compiled), ``True`` on the CPU (interpreted)."""
    platform = jax.default_backend()
    if platform == "gpu":
        return False
    if platform == "cpu":
        return True
    raise RuntimeError(
        f"no Pallas kernel route for platform {platform!r}: kernels compile "
        "for 'gpu' (Triton) and are interpreted on 'cpu' for tests; use the "
        "plain-XLA path on this platform"
    )
