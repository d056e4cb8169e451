"""MLP-Mixer for 2D fields.

Capability parity with ``/root/reference/pde_opt/numerics/functions/mixer_mlp.py``
(``MixerBlock`` :13-38, ``Mixer2d`` :40-86): patchify with a strided
projection, alternate token(patch)-mixing and channel-mixing MLPs with
LayerNorms, un-patchify with the transposed projection.

Construction: patchify/unpatchify are written as reshapes +
``einsum`` (kernel size == stride, so the conv is exactly a matmul) — the
whole network is matmuls over a fused batch, no gather/scatter.  Inputs
are ``(..., H, W)`` fields (leading axes batch), matching how equations call
their coefficient modules.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ...utils.modules import module

__all__ = ["MixerBlock", "Mixer2d"]


def _linear_init(key, out_f, in_f):
    wkey, bkey = jax.random.split(key)
    lim = 1.0 / in_f**0.5
    w = jax.random.uniform(wkey, (out_f, in_f), minval=-lim, maxval=lim)
    b = jax.random.uniform(bkey, (out_f,), minval=-lim, maxval=lim)
    return w, b


@module(data_fields=("w1", "b1", "w2", "b2"), static_fields=())
class _MLP:
    """Two-layer MLP (ReLU hidden), applied to the last axis."""

    def __init__(self, in_f, out_f, width, *, key):
        k1, k2 = jax.random.split(key)
        self.w1, self.b1 = _linear_init(k1, width, in_f)
        self.w2, self.b2 = _linear_init(k2, out_f, width)

    def __call__(self, x):
        h = jax.nn.relu(x @ self.w1.T + self.b1)
        return h @ self.w2.T + self.b2


@module(data_fields=("weight", "bias"), static_fields=("shape",))
class _LayerNorm:
    """LayerNorm over the trailing ``shape`` axes with learnable affine."""

    def __init__(self, shape):
        self.shape = tuple(shape)
        self.weight = jnp.ones(self.shape)
        self.bias = jnp.zeros(self.shape)

    def __call__(self, x):
        axes = tuple(range(-len(self.shape), 0))
        mean = jnp.mean(x, axis=axes, keepdims=True)
        var = jnp.var(x, axis=axes, keepdims=True)
        return (x - mean) / jnp.sqrt(var + 1e-5) * self.weight + self.bias


@module(
    data_fields=("patch_mixer", "hidden_mixer", "norm1", "norm2"),
    static_fields=(),
)
class MixerBlock:
    """One mixer block: token-mixing MLP then channel-mixing MLP, pre-norm."""

    def __init__(self, num_patches, hidden_size, mix_patch_size, mix_hidden_size, *, key):
        tkey, ckey = jax.random.split(key)
        self.patch_mixer = _MLP(num_patches, num_patches, mix_patch_size, key=tkey)
        self.hidden_mixer = _MLP(hidden_size, hidden_size, mix_hidden_size, key=ckey)
        self.norm1 = _LayerNorm((hidden_size, num_patches))
        self.norm2 = _LayerNorm((num_patches, hidden_size))

    def __call__(self, y):
        # y: (..., hidden_size, num_patches)
        y = y + self.patch_mixer(self.norm1(y))
        y = jnp.swapaxes(y, -1, -2)  # (..., p, c)
        y = y + self.hidden_mixer(self.norm2(y))
        return jnp.swapaxes(y, -1, -2)


@module(
    data_fields=("w_in", "b_in", "w_out", "b_out", "blocks", "norm"),
    static_fields=("img_size", "patch_size", "hidden_size"),
)
class Mixer2d:
    """MLP-Mixer mapping a field (..., H, W) -> (..., H, W).

    Args mirror the reference: ``img_size=(C, H, W)``, ``patch_size``,
    ``hidden_size``, ``mix_patch_size``, ``mix_hidden_size``, ``num_blocks``.
    """

    def __init__(self, img_size, patch_size, hidden_size, mix_patch_size,
                 mix_hidden_size, num_blocks, *, key):
        input_size, height, width = img_size
        assert height % patch_size == 0
        assert width % patch_size == 0
        num_patches = (height // patch_size) * (width // patch_size)
        inkey, outkey, *bkeys = jax.random.split(key, 2 + num_blocks)

        self.img_size = tuple(img_size)
        self.patch_size = patch_size
        self.hidden_size = hidden_size

        # Patchify projection (conv k=s=p == matmul): (hidden, C, p, p)
        lim_in = 1.0 / (input_size * patch_size**2) ** 0.5
        k1, k2 = jax.random.split(inkey)
        self.w_in = jax.random.uniform(
            k1, (hidden_size, input_size, patch_size, patch_size),
            minval=-lim_in, maxval=lim_in,
        )
        self.b_in = jax.random.uniform(
            k2, (hidden_size,), minval=-lim_in, maxval=lim_in
        )
        # Un-patchify (transposed conv k=s=p): (hidden, C, p, p)
        lim_out = 1.0 / (hidden_size * patch_size**2) ** 0.5
        k3, k4 = jax.random.split(outkey)
        self.w_out = jax.random.uniform(
            k3, (hidden_size, input_size, patch_size, patch_size),
            minval=-lim_out, maxval=lim_out,
        )
        self.b_out = jax.random.uniform(
            k4, (input_size,), minval=-lim_out, maxval=lim_out
        )
        self.blocks = tuple(
            MixerBlock(num_patches, hidden_size, mix_patch_size, mix_hidden_size,
                       key=bk)
            for bk in bkeys
        )
        self.norm = _LayerNorm((hidden_size, num_patches))

    def __call__(self, y):
        C, H, W = self.img_size
        p = self.patch_size
        squeeze_channel = False
        if C == 1 and (y.ndim == 2 or y.shape[-3] != 1):
            y = y[..., None, :, :]
            squeeze_channel = True
        *batch, c, h, w = y.shape
        hp, wp = h // p, w // p
        # Patchify: (..., C, hp, p, wp, p) x (hid, C, p, p) -> (..., hid, hp, wp)
        yp = y.reshape((*batch, c, hp, p, wp, p))
        z = jnp.einsum("...ciujv,hcuv->...hij", yp, self.w_in) + self.b_in[
            ..., None, None
        ]
        z = z.reshape((*batch, self.hidden_size, hp * wp))
        for block in self.blocks:
            z = block(z)
        z = self.norm(z)
        z = z.reshape((*batch, self.hidden_size, hp, wp))
        # Un-patchify: (..., hid, hp, wp) x (hid, C, p, p) -> (..., C, H, W)
        out = jnp.einsum("...hij,hcuv->...ciujv", z, self.w_out).reshape(
            (*batch, C, h, w)
        ) + self.b_out[..., None, None]
        if squeeze_channel:
            out = out[..., 0, :, :]
        return out
