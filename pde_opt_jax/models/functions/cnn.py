"""Periodic (torus) convolutional networks for learnable PDE coefficients.

Capability parity with ``/root/reference/pde_opt/numerics/functions/cnn.py``
(``PeriodicConvBlock`` :13-45, ``PeriodicCNN`` :48-102): stride-1 circularly
padded convolutions, hence translation-equivariant on the periodic domain —
the right inductive bias for learning a chemical-potential field μ(u).

Differences from the reference:

* **Batch-transparent**: the reference ``__call__`` accepts exactly one
  ``(H, W)`` field; here any ``(..., H, W)`` (or ``(..., C, H, W)`` for
  multi-channel) batch maps through a single ``lax.conv_general_dilated``
  call — convolutions are matmul-unit ops and want large batches.
* Circular padding is explicit ``jnp.pad(mode="wrap")`` + VALID conv, which
  XLA fuses; the layout is NCHW with the spatial dims minor.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import jax
import jax.numpy as jnp
from jax import lax

from ...utils.modules import module

__all__ = ["PeriodicCNN", "conv2d_circular"]


def conv2d_circular(x, w, b=None):
    """2D convolution with periodic padding.

    Args:
        x: (..., C_in, H, W) input.
        w: (C_out, C_in, kh, kw) kernel (odd kh/kw).
        b: optional (C_out,) bias.
    Returns:
        (..., C_out, H, W).
    """
    *batch, c, h, wd = x.shape
    xb = x.reshape((-1, c, h, wd))
    ph, pw = w.shape[-2] // 2, w.shape[-1] // 2
    xb = jnp.pad(xb, ((0, 0), (0, 0), (ph, ph), (pw, pw)), mode="wrap")
    out = lax.conv_general_dilated(
        xb, w, window_strides=(1, 1), padding="VALID",
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
    )
    if b is not None:
        out = out + b[None, :, None, None]
    return out.reshape((*batch, w.shape[0], h, wd))


def _conv_init(key, out_c, in_c, k):
    """Torch/equinox-style uniform init: lim = 1/sqrt(in_c·k·k)."""
    wkey, bkey = jax.random.split(key)
    lim = 1.0 / (in_c * k * k) ** 0.5
    w = jax.random.uniform(wkey, (out_c, in_c, k, k), minval=-lim, maxval=lim)
    b = jax.random.uniform(bkey, (out_c,), minval=-lim, maxval=lim)
    return w, b


@module(
    data_fields=("weights", "biases"),
    static_fields=("in_channels", "out_channels", "kernel_size", "act"),
)
class PeriodicCNN:
    """Stack of circular conv blocks; final conv linear (no activation).

    With ``in_channels == 1`` (the μ(u)-field use case) the call signature is
    field-in/field-out: ``(..., H, W) -> (..., H, W)``; leading axes are
    batch.  With ``in_channels > 1`` inputs are ``(..., C, H, W)``.
    """

    def __init__(
        self,
        in_channels: int,
        hidden_channels: Sequence[int] = (32, 64, 64),
        out_channels: Optional[int] = None,
        kernel_size: int = 3,
        act: Callable = jax.nn.gelu,
        *,
        key,
    ):
        assert kernel_size % 2 == 1, "Use odd kernels to avoid off-by-one alignment."
        if out_channels is None:
            out_channels = in_channels
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.kernel_size = kernel_size
        self.act = act

        keys = jax.random.split(key, len(hidden_channels) + 1)
        weights, biases = [], []
        c_prev = in_channels
        for i, c_next in enumerate(hidden_channels):
            w, b = _conv_init(keys[i], c_next, c_prev, kernel_size)
            weights.append(w)
            biases.append(b)
            c_prev = c_next
        w, b = _conv_init(keys[-1], out_channels, c_prev, kernel_size)
        weights.append(w)
        biases.append(b)
        self.weights = tuple(weights)
        self.biases = tuple(biases)

    def __call__(self, x):
        squeeze_channel = False
        if self.in_channels == 1 and (
            x.ndim == 2 or x.shape[-3] != 1
        ):
            # Field-style input (..., H, W): add the channel axis.
            x = x[..., None, :, :]
            squeeze_channel = self.out_channels == 1
        for w, b in zip(self.weights[:-1], self.biases[:-1]):
            x = self.act(conv2d_circular(x, w, b))
        x = conv2d_circular(x, self.weights[-1], self.biases[-1])
        if squeeze_channel:
            x = x[..., 0, :, :]
        return x
