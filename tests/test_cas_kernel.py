"""The cas kernel (``ops/cas_spectral.py``) and what surrounds it.

On the CPU the kernel runs in Pallas interpret mode: these tests pin its
arithmetic to the XLA oracle across grid sizes, batch sizes, operand
precisions and the env epilogue, plus its gradient rule, its grid checks,
the backend helper that decides how every kernel runs, the compile-cache
helper, and the package's import surface.  Tests marked ``gpu`` compile
the kernel for the card at the flagship size (4096 envs, 64², 10
substeps) and skip elsewhere.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pde_opt_jax.ops import kernel_backend
from pde_opt_jax.ops.cas_spectral import SUPPORTED_GRIDS, make_ch_cas_fused_macro
from pde_opt_jax.ops.spectral_reference import ch_sif_macro_reference

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def MU(c):
    return c**3 - c


def _field(B, H, W, seed=0, amp=0.05, dtype=jnp.float32):
    u = 0.5 + amp * jax.random.normal(jax.random.PRNGKey(seed), (B, H, W))
    kap = jax.random.uniform(jax.random.PRNGKey(seed + 1), (B,),
                             minval=0.002, maxval=0.01)
    return u.astype(dtype), kap.astype(dtype)


def _oracle(H, W, n, hx=0.01, hy=0.01, dt=1e-3):
    return ch_sif_macro_reference(MU, hx, hy, 1.0, dt, n)


# Tolerances (absolute, on a field of amplitude 0.05 about 0.5, 3 substeps):
# * f32 operands (exact IEEE products): f32 rounding only -> 5e-5.
# * bf16 (3-pass head*head + head*tail + tail*head): each operand keeps
#   ~16 significant bits, ~1e-5 relative to the field's deviation from its
#   mean (the kernel transforms deviations) -> 5e-6.
PRECISIONS = {
    "f32": (dict(mats_dtype=jnp.float32), 5e-5),
    "bf16x3": (dict(mats_dtype=jnp.bfloat16), 5e-6),
}


@pytest.mark.parametrize("prec", sorted(PRECISIONS))
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("H,W", [(16, 16), (32, 16), (64, 64)])
def test_kernel_matches_oracle(H, W, B, prec):
    kw, atol = PRECISIONS[prec]
    u, kap = _field(B, H, W, seed=H + W + B)
    out = make_ch_cas_fused_macro(MU, H, W, 0.01, 0.01, 1.0, 1e-3, 3,
                                  **kw)(u, kap)
    ref = _oracle(H, W, 3)(u, kap)
    assert out.shape == u.shape and out.dtype == u.dtype
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               rtol=0, atol=atol)
    assert float(jnp.max(jnp.abs(out - u))) > 1e-4      # the field moved


@pytest.mark.parametrize("H,ds", [(16, 1), (32, 2), (64, 1), (64, 4)])
def test_kernel_epilogue_matches_oracle(H, ds):
    """Stats and obs of the advanced field equal the XLA reward/observe
    quantities of the oracle's field (obs within 1 uint8 LSB: matmul
    pooling vs reshape-mean, and f32 vs oracle rounding at a bin edge)."""
    B, c = 2, 0.5
    u, kap = _field(B, H, H, seed=H + ds, dtype=jnp.float32)
    macro = make_ch_cas_fused_macro(
        MU, H, H, 0.01, 0.01, 1.0, 1e-3, 3, mats_dtype=jnp.float32,
        epilogue={"obs_downsample": ds, "stats_center": c},
    )
    u1, stats, obs = macro(u, kap)
    ref = np.asarray(_oracle(H, H, 3)(u, kap), np.float64)
    np.testing.assert_allclose(np.asarray(u1), ref, rtol=0, atol=5e-5)
    uz = ref - c
    np.testing.assert_allclose(np.asarray(stats[:, 0]), uz.sum((1, 2)),
                               rtol=0, atol=1e-3)
    np.testing.assert_allclose(np.asarray(stats[:, 1]),
                               (uz**2).sum((1, 2)), rtol=1e-4)
    np.testing.assert_array_equal(np.asarray(stats[:, 2]), H * H)
    Hd = H // ds
    pooled = ref.reshape(B, Hd, ds, Hd, ds).mean(axis=(2, 4))
    obs_ref = np.clip(pooled * 255.0, 0, 255).astype(np.uint8)
    assert obs.shape == (B, Hd, Hd) and obs.dtype == jnp.uint8
    diff = np.abs(np.asarray(obs, np.int32) - obs_ref.astype(np.int32))
    assert int(diff.max()) <= 1


@pytest.mark.parametrize("epilogue", [None, {"stats_center": 0.5}])
def test_kernel_vjp_is_the_oracle_vjp(epilogue):
    """The custom VJP's backward pass IS the oracle's VJP at the same
    primal inputs (the epilogue's stats cotangent folds into the field's
    first)."""
    B, H = 3, 16
    u, kap = _field(B, H, H, seed=11)
    macro = make_ch_cas_fused_macro(MU, H, H, 0.01, 0.01, 1.0, 1e-3, 3,
                                    mats_dtype=jnp.float32,
                                    epilogue=epilogue)
    oracle = ch_sif_macro_reference(MU, 0.01, 0.01, 1.0, 1e-3, 3,
                                    remat=True)
    g = jax.random.normal(jax.random.PRNGKey(12), (B, H, H), jnp.float32)
    if epilogue is None:
        _, vjp = jax.vjp(macro, u, kap)
        got = vjp(g)
    else:
        (u1, stats, obs), vjp = jax.vjp(macro, u, kap)
        zero_obs = np.zeros(obs.shape, jax.dtypes.float0)
        got = vjp((g, jnp.zeros_like(stats), zero_obs))
    _, vjp_o = jax.vjp(oracle, u, kap)
    want = vjp_o(g)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("H,W", [(8, 8), (48, 48), (128, 128), (24, 64)])
def test_unsupported_grid_raises(H, W):
    with pytest.raises(ValueError, match="spectral_solve='fft'"):
        make_ch_cas_fused_macro(MU, H, W, 0.01, 0.01, 1.0, 1e-3, 2)


def test_pooled_observation_narrower_than_16_raises():
    with pytest.raises(ValueError, match=">= 16"):
        make_ch_cas_fused_macro(MU, 32, 32, 0.01, 0.01, 1.0, 1e-3, 2,
                                epilogue={"obs_downsample": 4})


def test_preset_fused_on_unsupported_grid_raises():
    from pde_opt_jax.envs import make_cahn_hilliard_control_env

    env = make_cahn_hilliard_control_env(num_envs=2, grid_size=48,
                                         substeps=2)
    state, _ = env.reset(jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match="spectral_solve='fft'"):
        env.step(state, jnp.zeros((2, 1)))


def test_supported_grids_are_triton_tiles():
    for n in SUPPORTED_GRIDS:
        assert n >= 16 and n & (n - 1) == 0


# --------------------------------------------------------------------------
# Backend helper: one place decides how every Pallas kernel runs.
# --------------------------------------------------------------------------


@pytest.mark.parametrize("platform,interpret", [("cpu", True), ("gpu", False)])
def test_pallas_interpret_per_platform(monkeypatch, platform, interpret):
    monkeypatch.setattr(kernel_backend.jax, "default_backend",
                        lambda: platform)
    assert kernel_backend.pallas_interpret() is interpret


def test_pallas_interpret_unknown_platform_raises(monkeypatch):
    monkeypatch.setattr(kernel_backend.jax, "default_backend",
                        lambda: "someaccel")
    with pytest.raises(RuntimeError, match="someaccel"):
        kernel_backend.pallas_interpret()


# --------------------------------------------------------------------------
# Compile-cache helper.
# --------------------------------------------------------------------------


def test_compile_cache_follows_env_var(monkeypatch, tmp_path):
    from pde_opt_jax.utils import compile_cache

    calls = []
    monkeypatch.setattr(compile_cache.jax.config, "update",
                        lambda *a: calls.append(a))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert calls == []                      # JAX reads the variable itself


def test_compile_cache_defaults_to_repo_dir(monkeypatch):
    from pde_opt_jax.utils import compile_cache

    calls = []
    monkeypatch.setattr(compile_cache.jax.config, "update",
                        lambda *a: calls.append(a))
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.enable_compile_cache()
    assert path == os.path.join(REPO, ".jax_cache")
    assert calls == [("jax_compilation_cache_dir", path)]


# --------------------------------------------------------------------------
# Import surface: the main path needs only JAX, numpy, scipy, optax, chex
# and einops.
# --------------------------------------------------------------------------

_IMPORT_PROBE = """
import sys
for name in ("gymnasium", "sympy", "orbax", "matplotlib", "flax"):
    sys.modules[name] = None            # any import of them now fails
import pde_opt_jax
from pde_opt_jax import PDEModel, VectorPDEEnv, rl, parallel
from pde_opt_jax.envs import make_cahn_hilliard_control_env
from pde_opt_jax.parallel import ShardedVectorPDEEnv
try:
    pde_opt_jax.PDEEnv
except ImportError:
    pass
else:
    raise SystemExit("PDEEnv resolved without gymnasium")
print("ok")
"""


def test_import_without_optional_packages():
    env = {**os.environ, "PYTHONPATH": REPO, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": ""}
    proc = subprocess.run([sys.executable, "-c", _IMPORT_PROBE],
                          capture_output=True, text=True, timeout=300,
                          env=env, cwd=REPO)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


def test_gym_adapters_resolve_lazily():
    pytest.importorskip("gymnasium")
    import pde_opt_jax
    from pde_opt_jax import envs
    from pde_opt_jax.envs.gym_adapter import AdvectionDiffusionEnv, PDEEnv

    assert pde_opt_jax.PDEEnv is PDEEnv
    assert envs.PDEEnv is PDEEnv
    assert envs.AdvectionDiffusionEnv is AdvectionDiffusionEnv


# --------------------------------------------------------------------------
# On the card: the compiled kernel at the flagship size.
# --------------------------------------------------------------------------


@pytest.mark.gpu
def test_compiled_kernel_matches_oracle_at_flagship_size():
    """4096 envs x 64² x 10 substeps, 3-pass bf16 operands, epilogue on,
    against the f32 oracle at HIGHEST matmul precision."""
    B, H, n = 4096, 64, 10
    u = jnp.clip(0.5 + 0.01 * jax.random.normal(jax.random.PRNGKey(0),
                                                (B, H, H), jnp.float32), 0, 1)
    kap = jax.random.uniform(jax.random.PRNGKey(1), (B,), jnp.float32,
                             minval=0.002, maxval=0.01)
    macro = jax.jit(make_ch_cas_fused_macro(
        MU, H, H, 0.01, 0.01, 1.0, 1e-3, n,
        epilogue={"obs_downsample": 1, "stats_center": 0.5}))
    u1, stats, obs = macro(u, kap)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jax.jit(ch_sif_macro_reference(
            MU, 0.01, 0.01, 1.0, 1e-3, n))(u, kap), np.float64)
    np.testing.assert_allclose(np.asarray(u1), ref, rtol=0, atol=1e-5)
    uz = ref - 0.5
    np.testing.assert_allclose(np.asarray(stats[:, 1]), (uz**2).sum((1, 2)),
                               rtol=1e-3)
    obs_ref = np.clip(ref * 255.0, 0, 255).astype(np.uint8)
    diff = np.abs(np.asarray(obs, np.int32) - obs_ref.astype(np.int32))
    assert int(diff.max()) <= 1


@pytest.mark.gpu
def test_compiled_kernel_gradient_matches_oracle_at_flagship_size():
    B, H, n = 4096, 64, 10
    u = jnp.clip(0.5 + 0.01 * jax.random.normal(jax.random.PRNGKey(2),
                                                (B, H, H), jnp.float32), 0, 1)
    kap = jax.random.uniform(jax.random.PRNGKey(3), (B,), jnp.float32,
                             minval=0.002, maxval=0.01)
    macro = make_ch_cas_fused_macro(MU, H, H, 0.01, 0.01, 1.0, 1e-3, n)
    oracle = ch_sif_macro_reference(MU, 0.01, 0.01, 1.0, 1e-3, n)

    def loss(m):
        return lambda uu, kk: jnp.mean((m(uu, kk) - 0.5) ** 2)

    _, (du, dk) = jax.jit(jax.value_and_grad(loss(macro), (0, 1)))(u, kap)
    with jax.default_matmul_precision("highest"):
        _, (du_o, dk_o) = jax.jit(
            jax.value_and_grad(loss(oracle), (0, 1)))(u, kap)
    assert float(jnp.max(jnp.abs(du - du_o)) / jnp.max(jnp.abs(du_o))) < 1e-3
    assert float(jnp.max(jnp.abs(dk - dk_o)) / jnp.max(jnp.abs(dk_o))) < 1e-3
