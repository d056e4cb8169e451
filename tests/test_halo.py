"""Spatial decomposition tests: halo-exchange stencils and distributed FFT."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P

from pde_opt_jax.ops import stencils as st
from pde_opt_jax.parallel.halo import (
    distributed_fft2,
    distributed_ifft2,
    halo_pad_rows,
    sharded_lap_2nd_2d,
)
from pde_opt_jax.parallel.mesh import shard_map

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 2, reason="needs multi-device (virtual) platform"
)


def _mesh():
    return Mesh(np.array(jax.devices()), ("space",))


def test_sharded_laplacian_matches_global():
    mesh = _mesh()
    n_dev = len(jax.devices())
    N, M = 4 * n_dev, 16
    u = jax.random.normal(jax.random.PRNGKey(0), (N, M))

    f = jax.jit(
        shard_map(
            lambda ul: sharded_lap_2nd_2d(ul, 0.1, 0.2, "space"),
            mesh=mesh, in_specs=P("space"), out_specs=P("space"),
        )
    )
    np.testing.assert_allclose(
        np.asarray(f(u)), np.asarray(st.lap_2nd_2d(u, 0.1, 0.2)), rtol=1e-12
    )


def test_halo_pad_width2():
    mesh = _mesh()
    n_dev = len(jax.devices())
    N, M = 4 * n_dev, 8
    u = jnp.arange(N * M, dtype=jnp.float32).reshape(N, M)

    f = jax.jit(
        shard_map(
            lambda ul: halo_pad_rows(ul, "space", halo=2),
            mesh=mesh, in_specs=P("space"), out_specs=P("space"),
        )
    )
    padded = np.asarray(f(u))  # concatenated per-shard padded blocks
    rows_local = N // n_dev
    blk = padded.reshape(n_dev, rows_local + 4, M)
    un = np.asarray(u)
    for d in range(n_dev):
        lo = (d * rows_local - 2) % N
        want_top = np.stack([un[(lo + i) % N] for i in range(2)])
        np.testing.assert_array_equal(blk[d, :2], want_top)
        np.testing.assert_array_equal(blk[d, 2:-2], un[d * rows_local:(d + 1) * rows_local])
        want_bot = np.stack([un[((d + 1) * rows_local + i) % N] for i in range(2)])
        np.testing.assert_array_equal(blk[d, -2:], want_bot)


def test_distributed_fft2_matches_global():
    mesh = _mesh()
    n_dev = len(jax.devices())
    N = 4 * n_dev
    u = jax.random.normal(jax.random.PRNGKey(1), (N, N))

    f = jax.jit(
        shard_map(
            lambda ul: distributed_fft2(ul.astype(jnp.complex128), "space"),
            mesh=mesh, in_specs=P("space"), out_specs=P(None, "space"),
        )
    )
    got = np.asarray(f(u))
    want = np.fft.fftn(np.asarray(u))
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)


def test_distributed_fft_roundtrip_and_spectral_multiply():
    """fft → spectral Laplacian multiply → ifft, sharded vs global."""
    mesh = _mesh()
    n_dev = len(jax.devices())
    N = 4 * n_dev
    u = jax.random.normal(jax.random.PRNGKey(2), (N, N))
    k = np.fft.fftfreq(N)
    KX, KY = np.meshgrid(k, k, indexing="ij")
    symbol = -(2 * np.pi) ** 2 * (KX**2 + KY**2)

    def shard_fn(ul, sym_cols):
        fhat = distributed_fft2(ul.astype(jnp.complex128), "space")
        fhat = fhat * sym_cols  # symbol pre-sharded to the column layout
        return distributed_ifft2(fhat, "space").real

    f = jax.jit(
        shard_map(
            shard_fn, mesh=mesh,
            in_specs=(P("space"), P(None, "space")),
            out_specs=P("space"),
        )
    )
    got = np.asarray(f(u, jnp.asarray(symbol)))
    want = np.real(np.fft.ifftn(symbol * np.fft.fftn(np.asarray(u))))
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)


def test_sharded_sif_ch_macro_matches_single_device():
    from pde_opt_jax.ops.spectral_reference import ch_sif_macro_reference
    from pde_opt_jax.parallel.halo import make_sharded_sif_ch_macro

    mesh = _mesh()
    P_dev = len(jax.devices())
    N = M = 8 * P_dev
    hx, hy = 0.01, 0.015
    A, dt, n = 1.0, 1e-3, 3
    mu = lambda c: c**3 - c
    kappa = 0.004

    u = 0.5 + 0.05 * jax.random.normal(jax.random.PRNGKey(0), (N, M))
    u = u.astype(jnp.float64)

    macro = make_sharded_sif_ch_macro(mu, N, M, hx, hy, A, dt, n)
    sharded = jax.jit(
        shard_map(
            lambda ul: macro(ul, kappa),
            mesh=mesh, in_specs=P("space", None), out_specs=P("space", None),
        )
    )
    out = sharded(u)
    expect = ch_sif_macro_reference(mu, hx, hy, A, dt, n)(u, kappa)
    np.testing.assert_allclose(np.asarray(out), np.asarray(expect),
                               rtol=1e-10, atol=1e-10)


def test_sharded_laplacian_3d_matches_global():
    mesh = _mesh()
    n_dev = len(jax.devices())
    N, M, K = 2 * n_dev, 12, 8
    u = jax.random.normal(jax.random.PRNGKey(11), (N, M, K))
    from pde_opt_jax.parallel.halo import sharded_lap_2nd_3d

    f = jax.jit(shard_map(
        lambda ul: sharded_lap_2nd_3d(ul, 0.1, 0.2, 0.3, "space"),
        mesh=mesh, in_specs=P("space"), out_specs=P("space"),
    ))
    np.testing.assert_allclose(
        np.asarray(f(u)), np.asarray(st.lap_2nd_3d(u, 0.1, 0.2, 0.3)),
        rtol=1e-12,
    )


def test_distributed_fft3_roundtrip_and_matches_global():
    mesh = _mesh()
    n_dev = len(jax.devices())
    N, M, K = 2 * n_dev, 2 * n_dev, 4
    u = jax.random.normal(jax.random.PRNGKey(12), (N, M, K))
    from pde_opt_jax.parallel.halo import distributed_fft3, distributed_ifft3

    fwd = jax.jit(shard_map(
        lambda ul: distributed_fft3(ul.astype(jnp.complex128), "space"),
        mesh=mesh, in_specs=P("space"), out_specs=P(None, "space", None),
    ))
    got = np.asarray(fwd(u))
    np.testing.assert_allclose(got, np.fft.fftn(np.asarray(u)),
                               rtol=1e-10, atol=1e-10)

    rt = jax.jit(shard_map(
        lambda ul: distributed_ifft3(
            distributed_fft3(ul.astype(jnp.complex128), "space"), "space"
        ).real,
        mesh=mesh, in_specs=P("space"), out_specs=P("space"),
    ))
    np.testing.assert_allclose(np.asarray(rt(u)), np.asarray(u),
                               rtol=1e-12, atol=1e-12)


def test_sharded_sif_ch3d_macro_matches_single_device():
    """Spatially-sharded 3D semi-implicit CH == the single-device rollout
    (same FD-symbol update evaluated with jnp.fft on one device)."""
    mesh = _mesh()
    n_dev = len(jax.devices())
    N = M = 2 * n_dev
    K = 8
    from pde_opt_jax.parallel.halo import make_sharded_sif_ch3d_macro

    mu = lambda c: c**3 - c
    hx = hy = hz = 0.01
    kappa, A, dt, n = 2e-3, 0.5, 1e-5, 6
    u0 = 0.5 + 0.05 * jax.random.normal(jax.random.PRNGKey(13), (N, M, K))

    macro = make_sharded_sif_ch3d_macro(mu, N, M, K, hx, hy, hz, A, dt, n)
    got = jax.jit(shard_map(
        lambda ul: macro(ul, kappa),
        mesh=mesh, in_specs=P("space"), out_specs=P("space"),
    ))(u0)

    # Single-device oracle: identical FD-symbol update with jnp.fft.
    lam = (
        (2 * jnp.cos(2 * jnp.pi * jnp.arange(N) / N) - 2)[:, None, None] / hx**2
        + (2 * jnp.cos(2 * jnp.pi * jnp.arange(M) / M) - 2)[None, :, None] / hy**2
        + (2 * jnp.cos(2 * jnp.pi * jnp.arange(K) / K) - 2)[None, None, :] / hz**2
    )
    denom = 1.0 / (1.0 + A * dt * kappa * lam**2)
    u = u0
    for _ in range(n):
        incr = denom * (lam * jnp.fft.fftn(mu(u))
                        - kappa * lam**2 * jnp.fft.fftn(u))
        u = u + dt * jnp.fft.ifftn(incr).real
    np.testing.assert_allclose(np.asarray(got), np.asarray(u),
                               rtol=0, atol=1e-10)
