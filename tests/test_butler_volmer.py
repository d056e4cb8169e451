"""Butler-Volmer electrochemistry oracles.

The galvanostatic (constant-current) closure has an exact conservation law:
with α = 1/2, the overpotential v is chosen so the *total* reaction current
equals Crate (reference ``allen_cahn.py:257-270``), i.e. ∫ rhs dA = Crate.
That identity is the oracle here — it holds for any state, so it pins the
closed-form solve, the global reductions, and their batched keepdims forms.
"""

import jax
import jax.numpy as jnp
import numpy as np

import pde_opt_jax as p

N = 32
L = 1.0


def _domain():
    return p.Domain((N, N), ((-L / 2, L / 2), (-L / 2, L / 2)), dtype=jnp.float64)


MU = lambda c: jnp.log(c / (1.0 - c))
J0 = lambda c: jnp.sqrt(c * (1.0 - c) + 1e-6)


def _state(key, batch=()):
    return jnp.clip(
        0.5 + 0.05 * jax.random.normal(key, (*batch, N, N)), 0.05, 0.95
    )


def test_constant_current_conservation():
    domain = _domain()
    eq = p.AllenCahn2DPeriodicButlerVolmerConstantCurrent(
        domain, kappa=0.01, mu=MU, j0=J0, alpha=0.5, Crate=1.7
    )
    u = _state(jax.random.PRNGKey(0))
    total_current = float(jnp.sum(eq.rhs(u, 0.0)) * domain.dx[0] * domain.dx[1])
    np.testing.assert_allclose(total_current, 1.7, rtol=1e-10)


def test_constant_current_batched_per_env():
    domain = _domain()
    eq = p.AllenCahn2DPeriodicButlerVolmerConstantCurrent(
        domain, kappa=0.01, mu=MU, j0=J0, alpha=0.5, Crate=-0.8
    )
    u = _state(jax.random.PRNGKey(1), batch=(4,))
    rhs = eq.rhs(u, 0.0)
    totals = np.asarray(jnp.sum(rhs, axis=(-2, -1)) * domain.dx[0] * domain.dx[1])
    np.testing.assert_allclose(totals, -0.8 * np.ones(4), rtol=1e-10)
    # Batched voltages match per-instance voltages.
    v_b = np.asarray(eq.get_voltage(u))
    for i in range(4):
        np.testing.assert_allclose(v_b[i], float(eq.get_voltage(u[i])), rtol=1e-12)


def test_fixed_voltage_bv_signs():
    """At large negative overpotential the reaction inserts mass (rhs > 0)."""
    domain = _domain()
    eq = p.AllenCahn2DPeriodicButlerVolmer(
        domain, kappa=0.01, mu=lambda c: jnp.zeros_like(c), j0=J0,
        alpha=0.5, v=-2.0,
    )
    u = 0.5 * jnp.ones((N, N))
    assert bool(jnp.all(eq.rhs(u, 0.0) > 0))
    eq2 = p.AllenCahn2DPeriodicButlerVolmer(
        domain, kappa=0.01, mu=lambda c: jnp.zeros_like(c), j0=J0,
        alpha=0.5, v=2.0,
    )
    assert bool(jnp.all(eq2.rhs(u, 0.0) < 0))


def test_sbm_constant_current_conservation():
    """ψ-weighted galvanostatic closure: ∫ ψ·rhs dA = Crate (α = 1/2).

    (The ψ weight appears because the physical current only flows in the
    interior; the reference computes the same ψ-weighted integrals,
    ``allen_cahn.py:340-354``.)
    """
    from pde_opt_jax.geometry import Shape

    mask = np.zeros((N, N))
    yy, xx = np.mgrid[0:N, 0:N]
    mask[(yy - N / 2) ** 2 + (xx - N / 2) ** 2 < (N / 3) ** 2] = 1.0
    shape = Shape(jnp.asarray(mask), dx=(L / N, L / N), smooth_epsilon=L / N * 2,
                  smooth_dt=0.001, smooth_tf=0.01)
    domain = p.Domain((N, N), ((-L / 2, L / 2), (-L / 2, L / 2)),
                      geometry=shape, dtype=jnp.float64)
    eq = p.AllenCahn2DSmoothedBoundaryButlerVolmerConstantCurrent(
        domain, kappa=0.01, f=lambda c: 0.25 * (c**2) * (1 - c) ** 2,
        mu=MU, j0=J0, alpha=0.5, Crate=0.9,
    )
    u = _state(jax.random.PRNGKey(2))
    weighted = float(
        jnp.sum(eq.rhs(u, 0.0) * eq.psi) * domain.dx[0] * domain.dx[1]
    )
    np.testing.assert_allclose(weighted, 0.9, rtol=1e-8)
