"""Policy/value networks for PDE-control RL.

The reference trains stable-baselines3 ``CnnPolicy`` agents against its gym
env (``/root/reference/notebooks/test_pde_RL.ipynb`` cells 0-10).  Here the
networks are plain pytree modules (:func:`pde_opt_jax.utils.modules.module`)
built for the batched on-device envs: circular (torus) convolutions with
stride-2 downsampling — periodic boundary conditions are part of the
physics, so the feature extractor should respect them — followed by dense
heads.  Everything is batch-transparent and jit/vmap/shard_map-safe.
"""

from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp
from jax import lax

from ..utils.modules import module

__all__ = ["Linear", "MLP", "ConvTorso", "ActorCriticConv", "QNetConv",
           "DeterministicActorConv", "QCriticConv"]


def _linear_init(key, out_f, in_f):
    wkey, bkey = jax.random.split(key)
    lim = 1.0 / in_f**0.5
    w = jax.random.uniform(wkey, (out_f, in_f), minval=-lim, maxval=lim)
    b = jax.random.uniform(bkey, (out_f,), minval=-lim, maxval=lim)
    return w, b


@module(data_fields=("w", "b"), static_fields=())
class Linear:
    """Dense layer: ``(..., in) -> (..., out)``."""

    def __init__(self, in_features: int, out_features: int, *, key):
        self.w, self.b = _linear_init(key, out_features, in_features)

    def __call__(self, x):
        return x @ self.w.T + self.b


@module(data_fields=("layers",), static_fields=("act",))
class MLP:
    """Dense stack with activation between layers (linear final layer)."""

    def __init__(self, sizes: Sequence[int], act=jax.nn.tanh, *, key):
        keys = jax.random.split(key, len(sizes) - 1)
        self.layers = tuple(
            Linear(a, b, key=k) for a, b, k in zip(sizes[:-1], sizes[1:], keys)
        )
        self.act = act

    def __call__(self, x):
        for layer in self.layers[:-1]:
            x = self.act(layer(x))
        return self.layers[-1](x)


def conv2d_circular_strided(x, w, b=None, stride: int = 2):
    """Circularly padded conv with stride (downsampling torso block).

    Args: x (..., C_in, H, W); w (C_out, C_in, k, k) with odd k.
    """
    *batch, c, h, wd = x.shape
    xb = x.reshape((-1, c, h, wd)).astype(w.dtype)
    p = w.shape[-1] // 2
    xb = jnp.pad(xb, ((0, 0), (0, 0), (p, p), (p, p)), mode="wrap")
    out = lax.conv_general_dilated(
        xb, w, window_strides=(stride, stride), padding="VALID",
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
    )
    if b is not None:
        out = out + b[None, :, None, None]
    return out.reshape((*batch,) + out.shape[1:])


def _conv_init(key, out_c, in_c, k):
    wkey, bkey = jax.random.split(key)
    lim = 1.0 / (in_c * k * k) ** 0.5
    w = jax.random.uniform(wkey, (out_c, in_c, k, k), minval=-lim, maxval=lim)
    b = jax.random.uniform(bkey, (out_c,), minval=-lim, maxval=lim)
    return w, b


@module(
    data_fields=("conv_w", "conv_b", "head"),
    static_fields=("channels", "kernel", "act", "compute_dtype"),
)
class ConvTorso:
    """Stride-2 circular conv stack -> global mean pool -> dense features.

    ``compute_dtype=jnp.bfloat16`` runs the convolutions and feature head in
    bf16 (params stay f32 for the optimizer; activations cast per layer) —
    the mixed-precision policy for the RL learner hot path.
    """

    def __init__(self, in_channels: int, channels: Sequence[int],
                 features: int, kernel: int = 3, act=jax.nn.gelu,
                 compute_dtype=None, *, key):
        keys = jax.random.split(key, len(channels) + 1)
        conv_w, conv_b = [], []
        c_prev = in_channels
        for i, c in enumerate(channels):
            w, b = _conv_init(keys[i], c, c_prev, kernel)
            conv_w.append(w)
            conv_b.append(b)
            c_prev = c
        self.conv_w = tuple(conv_w)
        self.conv_b = tuple(conv_b)
        self.head = Linear(c_prev, features, key=keys[-1])
        self.channels = tuple(channels)
        self.kernel = kernel
        self.act = act
        self.compute_dtype = compute_dtype

    def __call__(self, obs):
        """obs: (..., C, H, W) uint8 or float -> (..., features)."""
        x = obs.astype(jnp.float32)
        if obs.dtype == jnp.uint8:
            x = x / 255.0
        cd = self.compute_dtype or jnp.float32
        for w, b in zip(self.conv_w, self.conv_b):
            x = self.act(conv2d_circular_strided(
                x, w.astype(cd), b.astype(cd), stride=2))
        x = jnp.mean(x, axis=(-2, -1))          # global average pool
        feat = self.act(x @ self.head.w.T.astype(cd) + self.head.b.astype(cd))
        return feat.astype(jnp.float32)


@module(
    data_fields=("torso", "pi_head", "v_head", "log_std"),
    static_fields=("discrete",),
)
class ActorCriticConv:
    """Shared-torso actor-critic for image-like PDE observations.

    Continuous: ``pi_head`` outputs the Gaussian mean, ``log_std`` is a
    state-independent learned vector.  Discrete: ``pi_head`` outputs logits
    and ``log_std`` is unused (kept as an empty array leaf).
    """

    def __init__(self, action_dim: int, *, in_channels: int = 1,
                 channels: Sequence[int] = (16, 32), features: int = 64,
                 discrete: bool = False, compute_dtype=None, key):
        k1, k2, k3 = jax.random.split(key, 3)
        self.torso = ConvTorso(in_channels, channels, features,
                               compute_dtype=compute_dtype, key=k1)
        self.pi_head = Linear(features, action_dim, key=k2)
        self.v_head = Linear(features, 1, key=k3)
        self.log_std = (jnp.zeros(()) if discrete
                        else jnp.full((action_dim,), -0.5))
        self.discrete = discrete

    def __call__(self, obs):
        """Returns ``(dist_params, value)``: Gaussian ``(mean, log_std)`` or
        categorical ``logits``; value ``(...,)``."""
        feat = self.torso(obs)
        v = self.v_head(feat)[..., 0]
        if self.discrete:
            return self.pi_head(feat), v
        return (self.pi_head(feat), self.log_std), v


@module(data_fields=("layers",), static_fields=("act", "compute_dtype"))
class FlatMLPTorso:
    """Flatten the observation and run a dense stack (matmul fast path).

    For the small downsampled observations the control envs emit (e.g. the
    4x-pooled 16² fields of the PPO bench config), a flattened dense stack
    is a cheap feature extractor: the first layer is one depth-256
    matmul, whereas a conv torso's first layer contracts only
    ``C_in·k² = 9`` inputs per output.  Global
    statistics rewards (variance, ψ-weighted uniformity, L_z) don't need
    translation equivariance, so the learning-gated tests pass with either
    torso.
    """

    def __init__(self, in_features: int, widths: Sequence[int],
                 features: int, act=jax.nn.gelu, compute_dtype=None, *, key):
        sizes = (in_features, *widths, features)
        keys = jax.random.split(key, len(sizes) - 1)
        self.layers = tuple(
            Linear(a, b, key=k)
            for a, b, k in zip(sizes[:-1], sizes[1:], keys)
        )
        self.act = act
        self.compute_dtype = compute_dtype

    def __call__(self, obs):
        """obs: (..., C, H, W) or (..., F) uint8/float -> (..., features)."""
        x = obs.astype(jnp.float32)
        if obs.dtype == jnp.uint8:
            x = x / 255.0
        in_f = self.layers[0].w.shape[1]
        # Collapse ONLY a trailing (C, H, W) group into the feature axis.
        # Guard on the last dim not already being in_f: otherwise an
        # already-flat obs whose batch dims happen to multiply to in_f
        # (e.g. (2, 8, 16) with in_f=256) would silently flatten its
        # batch axes instead of erroring downstream.
        if (x.ndim >= 3 and x.shape[-1] != in_f
                and x.shape[-3] * x.shape[-2] * x.shape[-1] == in_f):
            x = x.reshape(x.shape[:-3] + (in_f,))
        cd = self.compute_dtype or jnp.float32
        for layer in self.layers:
            x = self.act(x.astype(cd) @ layer.w.T.astype(cd)
                         + layer.b.astype(cd))
        return x.astype(jnp.float32)


@module(
    data_fields=("torso", "pi_head", "v_head", "log_std"),
    static_fields=("discrete",),
)
class ActorCriticMLP:
    """Actor-critic over a :class:`FlatMLPTorso` (the dense learner).

    Same head structure and distribution contract as
    :class:`ActorCriticConv`; swaps the conv torso for full-depth dense
    matmuls.  ``in_features`` must equal the flattened observation size
    (e.g. ``16*16`` for the 4x-downsampled flagship obs).
    """

    def __init__(self, action_dim: int, in_features: int, *,
                 widths: Sequence[int] = (256,), features: int = 64,
                 discrete: bool = False, compute_dtype=None, key):
        k1, k2, k3 = jax.random.split(key, 3)
        self.torso = FlatMLPTorso(in_features, widths, features,
                                  compute_dtype=compute_dtype, key=k1)
        self.pi_head = Linear(features, action_dim, key=k2)
        self.v_head = Linear(features, 1, key=k3)
        self.log_std = (jnp.zeros(()) if discrete
                        else jnp.full((action_dim,), -0.5))
        self.discrete = discrete

    def __call__(self, obs):
        feat = self.torso(obs)
        v = self.v_head(feat)[..., 0]
        if self.discrete:
            return self.pi_head(feat), v
        return (self.pi_head(feat), self.log_std), v


@module(data_fields=("torso", "a_head", "scale"), static_fields=())
class DeterministicActorConv:
    """Deterministic policy for DDPG: ``obs -> scale * tanh(head(torso))``."""

    def __init__(self, action_dim: int, *, in_channels: int = 1,
                 channels: Sequence[int] = (16, 32), features: int = 64,
                 action_scale: float = 1.0, key):
        k1, k2 = jax.random.split(key)
        self.torso = ConvTorso(in_channels, channels, features, key=k1)
        self.a_head = Linear(features, action_dim, key=k2)
        self.scale = jnp.asarray(action_scale, jnp.float32)

    def __call__(self, obs):
        return self.scale * jnp.tanh(self.a_head(self.torso(obs)))


@module(data_fields=("torso", "a_proj", "q_mlp"), static_fields=())
class QCriticConv:
    """State-action critic for DDPG: conv state features + action -> Q."""

    def __init__(self, action_dim: int, *, in_channels: int = 1,
                 channels: Sequence[int] = (16, 32), features: int = 64, key):
        k1, k2, k3 = jax.random.split(key, 3)
        self.torso = ConvTorso(in_channels, channels, features, key=k1)
        self.a_proj = Linear(action_dim, features, key=k2)
        self.q_mlp = MLP((features, features, 1), act=jax.nn.gelu, key=k3)

    def __call__(self, obs, action):
        feat = self.torso(obs) + self.a_proj(action.astype(jnp.float32))
        return self.q_mlp(feat)[..., 0]


@module(data_fields=("torso", "q_head"), static_fields=())
class QNetConv:
    """Conv Q-network for discrete-action PDE control (DQN)."""

    def __init__(self, num_actions: int, *, in_channels: int = 1,
                 channels: Sequence[int] = (16, 32), features: int = 64, key):
        k1, k2 = jax.random.split(key)
        self.torso = ConvTorso(in_channels, channels, features, key=k1)
        self.q_head = Linear(features, num_actions, key=k2)

    def __call__(self, obs):
        return self.q_head(self.torso(obs))
