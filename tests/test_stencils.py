"""Stencil kernels vs independent numpy references, incl. batch transparency."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pde_opt_jax.ops import stencils as st


@pytest.fixture
def field():
    rng = np.random.default_rng(0)
    return jnp.asarray(rng.normal(size=(16, 24)))


def np_roll_lap(u, hx, hy):
    u = np.asarray(u)
    return (np.roll(u, -1, 0) - 2 * u + np.roll(u, 1, 0)) / hx**2 + (
        np.roll(u, -1, 1) - 2 * u + np.roll(u, 1, 1)
    ) / hy**2


def test_laplacian_2d_matches_numpy(field):
    got = st.lap_2nd_2d(field, 0.1, 0.2)
    np.testing.assert_allclose(got, np_roll_lap(field, 0.1, 0.2), rtol=1e-12)


def test_laplacian_generic_matches_2d(field):
    got = st.laplacian(field, (0.1, 0.2))
    np.testing.assert_allclose(got, st.lap_2nd_2d(field, 0.1, 0.2), rtol=1e-12)


def test_3d_laplacian():
    rng = np.random.default_rng(1)
    u = rng.normal(size=(6, 7, 8))
    got = st.lap_2nd_3d(jnp.asarray(u), 0.1, 0.2, 0.3)
    want = (
        (np.roll(u, -1, 0) - 2 * u + np.roll(u, 1, 0)) / 0.1**2
        + (np.roll(u, -1, 1) - 2 * u + np.roll(u, 1, 1)) / 0.2**2
        + (np.roll(u, -1, 2) - 2 * u + np.roll(u, 1, 2)) / 0.3**2
    )
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_face_grad_avg_div_adjointness(field):
    """div_f2c is the (negative transpose) adjoint of grad_c2f on the torus."""
    hx = 0.1
    g = st.grad_c2f(field, hx, -2)
    d = st.div_f2c(g, hx, -2)
    # On a periodic grid, sum of divergence of any flux is 0.
    np.testing.assert_allclose(float(jnp.sum(d)), 0.0, atol=1e-10)


def test_centered_gradient(field):
    got = st.grad_c(field, 0.1, -2)
    u = np.asarray(field)
    want = 0.5 * (np.roll(u, -1, 0) - np.roll(u, 1, 0)) / 0.1
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_mixed_second_derivative(field):
    got = st.grad2_cross_c(field, 0.1, 0.2, -2, -1)
    u = np.asarray(field)
    want = (
        np.roll(np.roll(u, -1, 0), -1, 1)
        + np.roll(np.roll(u, 1, 0), 1, 1)
        - np.roll(np.roll(u, -1, 0), 1, 1)
        - np.roll(np.roll(u, 1, 0), -1, 1)
    ) / (4.0 * 0.1 * 0.2)
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_batch_transparency(field):
    """A leading batch axis must not change per-sample results."""
    batch = jnp.stack([field, 2 * field, field**2])
    for fn in [
        lambda u: st.lap_2nd_2d(u, 0.1, 0.2),
        lambda u: st.grad_c2f(u, 0.1, -2),
        lambda u: st.avg_c2f(u, -1),
        lambda u: st.div_f2c(u, 0.1, -1),
        lambda u: st.grad_c(u, 0.3, -1),
    ]:
        got = fn(batch)
        for i in range(3):
            np.testing.assert_allclose(got[i], fn(batch[i]), rtol=1e-12)


def test_spatial_accuracy_second_order():
    """Stencils converge at 2nd order on a smooth periodic function."""
    errs = []
    for n in (32, 64, 128):
        x = (jnp.arange(n) + 0.5) / n * 2 * jnp.pi
        X, Y = jnp.meshgrid(x, x, indexing="ij")
        u = jnp.sin(X) * jnp.cos(2 * Y)
        h = float(2 * jnp.pi / n)
        lap = st.lap_2nd_2d(u, h, h)
        exact = -5 * u
        errs.append(float(jnp.max(jnp.abs(lap - exact))))
    order = np.log2(errs[0] / errs[1])
    assert 1.9 < order < 2.1
    order = np.log2(errs[1] / errs[2])
    assert 1.9 < order < 2.1
