"""Configurable boundary-condition operators (restored ghost API)."""

import jax.numpy as jnp
import numpy as np

from pde_opt_jax.ops.boundary import get_neighbor_indices, laplacian


def test_periodic_1d_matches_circulant():
    """The reference notebook's 1D check (test_boundary_conditions.ipynb cell 4)."""
    lap = laplacian(dx=0.1, boundary_conditions={0: ("periodic", None)})
    test = jnp.array([1.0, 2.0, 3.0])
    mat = jnp.array([[-2, 1, 1], [1, -2, 1], [1, 1, -2]]) / 0.1**2
    np.testing.assert_allclose(lap(test), mat @ test, rtol=1e-6, atol=1e-9)


def test_dirichlet_zero_1d():
    lap = laplacian(dx=1.0, boundary_conditions={0: ("dirichlet", 0.0)})
    u = jnp.array([1.0, 1.0, 1.0])
    got = lap(u)
    # ghost = 2*0 - u_edge = -1 -> lap at edges = (-1 - 2*1 + 1)/1 = -2
    np.testing.assert_allclose(got, [-2.0, 0.0, -2.0])


def test_neumann_zero_flux_constant_field():
    """Zero Neumann: a constant field has exactly zero Laplacian."""
    lap = laplacian(
        dx=(0.5, 0.5),
        boundary_conditions={0: ("neumann", 0.0), 1: ("neumann", 0.0)},
    )
    u = 3.0 * jnp.ones((5, 7))
    np.testing.assert_allclose(lap(u), jnp.zeros_like(u), atol=1e-12)


def test_mixed_2d_and_time_arg():
    lap = laplacian(
        dx=(0.1, 0.1),
        boundary_conditions={0: ("dirichlet", 0.0), 1: ("periodic", None)},
    )
    u = jnp.ones((3, 3))
    out = lap(u, 0.0)  # accepts an (ignored) time argument
    assert out.shape == (3, 3)
    # interior row: periodic columns of constant field + dirichlet rows
    assert np.isfinite(np.asarray(out)).all()


def test_dirichlet_array_boundary_values():
    g = jnp.array([1.0, 2.0, 3.0])
    lap = laplacian(
        dx=(0.1, 0.1),
        boundary_conditions={0: ("dirichlet", g), 1: ("periodic", None)},
    )
    u = jnp.zeros((4, 3))
    out = lap(u)
    # Top ghost row = 2g; contribution to row 0: 2g/h^2
    np.testing.assert_allclose(out[0], 2 * np.asarray(g) / 0.01, rtol=1e-6)


def test_batch_transparency():
    lap = laplacian(
        dx=(0.2, 0.3),
        boundary_conditions={0: ("neumann", 0.0), 1: ("dirichlet", 1.0)},
    )
    u = jnp.arange(2 * 4 * 5, dtype=jnp.float64).reshape(2, 4, 5)
    out = lap(u)
    np.testing.assert_allclose(out[1], lap(u[1]), rtol=1e-12)


def test_get_neighbor_indices():
    nb = get_neighbor_indices((4, 4), (0, 2))
    assert (3, 2) in nb  # periodic wrap on axis 0
    nb2 = get_neighbor_indices(
        (4, 4), (0, 2), boundary_conditions={0: ("dirichlet", 0.0)}
    )
    assert None in nb2  # outside a Dirichlet wall
    assert (1, 2) in nb2
