"""Learnable-function modules vs independent numpy references.

Same oracle strategy as the reference (``tests/test_functions.py:22-61``),
plus pytree/batching checks the batched design requires.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from numpy.polynomial.legendre import legval as np_legval

from pde_opt_jax.models.functions import (
    ChemicalPotentialLegendrePolynomials,
    DiffusionLegendrePolynomials,
    LegendrePolynomialExpansion,
    LegendrePolynomialExpansion2D,
    LegendrePolynomials,
    Mixer2d,
    PeriodicCNN,
)


def test_legendre_polynomial_expansion_matches_numpy():
    params = jnp.array([1.0, 0.5, 0.2, 0.1, -0.05, -0.02, 0.01])
    x = jnp.linspace(-1, 1, 20)
    mod = LegendrePolynomialExpansion(params)
    np.testing.assert_allclose(mod(x), np_legval(np.asarray(x), np.asarray(params)),
                               rtol=1e-5, atol=1e-7)


def test_diffusion_legendre_positive_and_matches_exp():
    params = jnp.array([0.2, -0.1, 0.05, -0.02, 0.01, -0.005, 0.002])
    x = jnp.linspace(0, 1, 20)
    mod = DiffusionLegendrePolynomials(params)
    want = np.exp(np_legval(np.asarray(2 * x - 1), np.asarray(params)))
    got = mod(x)
    assert jnp.all(got > 0)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


def test_chemical_potential_matches_legendre():
    params = jnp.array([0.3, 0.1, -0.2, -0.1, 0.45, -2.02, 0.01])
    x = jnp.linspace(0, 1, 20)
    mod = ChemicalPotentialLegendrePolynomials(params)
    want = np_legval(np.asarray(2 * x - 1), np.asarray(params))
    np.testing.assert_allclose(mod(x), want, rtol=1e-5, atol=1e-7)


def test_chemical_potential_with_prior():
    params = jnp.array([0.3, 0.1, -0.2])
    x = jnp.linspace(0, 1, 20)
    mod = ChemicalPotentialLegendrePolynomials(params, prior_fn=lambda x: 2.0 * x)
    want = np_legval(np.asarray(2 * x - 1), np.asarray(params)) + 2.0 * np.asarray(x)
    np.testing.assert_allclose(mod(x), want, rtol=1e-5, atol=1e-7)


def test_legendre_2d_tensor_product():
    params = jnp.array([[1.0, 0.3], [0.5, -0.2], [0.1, 0.0]])
    x = jnp.linspace(-1, 1, 7)
    y = jnp.linspace(-1, 1, 7)
    mod = LegendrePolynomialExpansion2D(params)
    got = mod(x, y)
    want = np.zeros(7)
    for m in range(3):
        for n in range(2):
            cm = np.zeros(m + 1); cm[m] = 1
            cn = np.zeros(n + 1); cn[n] = 1
            want += (
                float(params[m, n])
                * np_legval(np.asarray(x), cm)
                * np_legval(np.asarray(y), cn)
            )
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


def test_legendre_polynomials_hardcoded_equivalent():
    mod = LegendrePolynomials(max_degree=6)
    params = jnp.array([0.3, 0.1, -0.2, -0.1, 0.45, -2.02, 0.01])
    x = jnp.linspace(-1, 1, 15)
    np.testing.assert_allclose(
        mod(params, x), np_legval(np.asarray(x), np.asarray(params)),
        rtol=1e-5, atol=1e-7,
    )


def test_legval_rejects_short_params_at_trace_time():
    # jnp clamps out-of-bounds element indices, so a short params vector
    # would otherwise silently reuse its last coefficient.
    from pde_opt_jax.models.functions.legendre import legval

    with pytest.raises(ValueError, match="at least max_degree"):
        legval(jnp.array([1.0, 2.0]), jnp.linspace(-1, 1, 8), max_degree=4)


def test_modules_are_pytrees_and_optimizable():
    params = jnp.array([0.3, 0.1, -0.2])
    mod = ChemicalPotentialLegendrePolynomials(params)
    leaves = jax.tree_util.tree_leaves(mod)
    assert len(leaves) == 1 and leaves[0].shape == (3,)

    def loss(m):
        x = jnp.linspace(0, 1, 8)
        return jnp.sum(m(x) ** 2)

    g = jax.grad(loss)(mod)
    assert jax.tree_util.tree_leaves(g)[0].shape == (3,)


def test_periodic_cnn_shapes_and_batching():
    cnn = PeriodicCNN(1, (4, 4), 1, 3, key=jax.random.PRNGKey(0))
    x = jax.random.normal(jax.random.PRNGKey(1), (5, 16, 16))
    y = cnn(x)
    assert y.shape == (5, 16, 16)
    np.testing.assert_allclose(y[2], cnn(x[2]), rtol=1e-5, atol=1e-6)


def test_periodic_cnn_translation_equivariance():
    """Circular padding + stride 1 => equivariant to torus translations."""
    cnn = PeriodicCNN(1, (4,), 1, 3, key=jax.random.PRNGKey(0))
    x = jax.random.normal(jax.random.PRNGKey(1), (12, 12))
    shifted = jnp.roll(x, (3, 5), axis=(0, 1))
    np.testing.assert_allclose(
        cnn(shifted), jnp.roll(cnn(x), (3, 5), axis=(0, 1)), rtol=1e-5, atol=1e-6
    )


def test_mixer2d_shapes_and_batching():
    mx = Mixer2d((1, 16, 16), 4, 8, 16, 16, 2, key=jax.random.PRNGKey(0))
    x = jax.random.normal(jax.random.PRNGKey(1), (3, 16, 16))
    y = mx(x)
    assert y.shape == (3, 16, 16)
    np.testing.assert_allclose(y[1], mx(x[1]), rtol=1e-5, atol=1e-6)
