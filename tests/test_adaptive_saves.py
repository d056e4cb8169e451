"""Property tests: adaptive-driver save capture on adversarial f32 save grids.

An earlier ``integrate_adaptive`` save cursor had a bug: its absolute
``1e-12`` time tolerance was below one f32 ulp for t ~ O(1) runs (and far
below it at large t), so save points could be deferred past loop exit and
only a final-slot backstop papered over it.  The tolerance is now relative to
the time dtype and grid magnitude (``ops/integrate.py``); these tests drive
f32 save grids with tiny, irregular, and large-offset intervals and assert
every interior point is captured correctly — the backstop only ever fires on
max_steps exhaustion.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pde_opt_jax.ops.integrate import integrate_adaptive
from pde_opt_jax.ops.steppers import Heun, Tsit5


def _exp_decay_rhs(y, t):
    return -y


def _linear_rhs(y, t):
    return jnp.full_like(y, 0.5)


def _check_capture(ts, dt0, rtol=1e-6, atol=1e-9, tol=1e-2):
    """Integrate dy/dt = -y from ts[0] with y(ts[0]) = 1 and assert every
    save slot matches exp(-(t - ts[0])) — a zero (unwritten) slot or a
    mis-indexed write fails by construction since the solution stays in
    [0.2, 1].  The tolerance budgets for the driver's documented linear
    save interpolation (O(dt^2) between accepted steps), not just solver
    error."""
    y0 = jnp.asarray(1.0, jnp.float32)
    ys = integrate_adaptive(Tsit5(), _exp_decay_rhs, y0, ts, dt0,
                            rtol=rtol, atol=atol)
    expect = np.exp(-(np.asarray(ts, np.float64) - float(ts[0])))
    np.testing.assert_allclose(np.asarray(ys, np.float64), expect,
                               rtol=tol, atol=tol)


def _check_capture_exact(ts, dt0, atol=1e-5):
    """Integrate dy/dt = 1/2 (linear solution, so the driver's linear
    save interpolation is EXACT and every stepper stage is error-free):
    each save slot must equal 1 + (t - ts[0])/2 to f32 roundoff.  Any
    unwritten slot (0), duplicated write, or mis-indexed cursor fails —
    this isolates the capture logic from interpolation accuracy."""
    y0 = jnp.asarray(1.0, jnp.float32)
    ys = integrate_adaptive(Tsit5(), _linear_rhs, y0, ts, dt0,
                            rtol=1e-6, atol=1e-9)
    t_np = np.asarray(ts, np.float64)
    expect = 1.0 + 0.5 * (t_np - t_np[0])
    np.testing.assert_allclose(np.asarray(ys, np.float64), expect,
                               rtol=0, atol=atol)


def test_f32_grid_unit_scale():
    ts = jnp.linspace(0.0, 1.0, 17, dtype=jnp.float32)
    _check_capture(ts, dt0=0.05)
    _check_capture_exact(ts, dt0=0.05)


def test_f32_grid_large_time_offset():
    # At t ~ 1e4 one f32 ulp is ~1e-3: the old absolute 1e-12 slack was 9
    # orders of magnitude below the grid's own resolution.
    base = np.float32(16384.0)
    ts = base + np.linspace(0.0, 1.0, 9, dtype=np.float32)
    ts = jnp.asarray(np.asarray(ts, np.float32))
    y0 = jnp.asarray(1.0, jnp.float32)
    ys = integrate_adaptive(Tsit5(), _exp_decay_rhs, y0, ts, 0.1,
                            rtol=1e-6, atol=1e-9)
    expect = np.exp(-(np.asarray(ts, np.float64) - float(ts[0])))
    np.testing.assert_allclose(np.asarray(ys, np.float64), expect,
                               rtol=5e-3, atol=5e-3)


def test_f32_grid_tiny_irregular_intervals():
    # Irregular spacing with intervals spanning 3 orders of magnitude,
    # accumulated in f32 (so the grid itself carries rounding error).
    rng = np.random.default_rng(7)
    deltas = rng.choice([1e-4, 3e-4, 1e-3, 1e-2, 0.05], size=24).astype(
        np.float32)
    ts = np.concatenate([[np.float32(0.0)], np.cumsum(deltas)]).astype(
        np.float32)
    _check_capture(jnp.asarray(ts), dt0=1e-3)


def test_f32_many_saves_per_step():
    # On the error-free linear problem the controller grows dt by
    # factor_max each step, so dt quickly exceeds the save spacing: one
    # accepted step must flush MANY pending save points at once, exactly.
    ts = jnp.linspace(0.0, 2.0, 101, dtype=jnp.float32)
    _check_capture_exact(ts, dt0=0.5)


def test_f32_save_points_on_step_boundaries():
    # Save points that land exactly on accepted-step endpoints (the
    # equality-comparison corner the tolerance guards).
    ts = jnp.asarray(np.arange(33, dtype=np.float32) * np.float32(0.03125))
    _check_capture_exact(ts, dt0=0.03125)


@pytest.mark.parametrize("n_save", [2, 3, 64])
def test_final_slot_written_without_backstop(n_save):
    """The final save slot must be written by the cursor itself (correct
    interpolated value), not merely patched to SOME state by the backstop:
    for dy/dt = -y the backstop value (the final carry y) and the
    interpolated save value coincide, so instead integrate a state whose
    final carry differs measurably from the exact save value — a stiff
    oscillator sampled mid-phase — and check against the analytic solution."""
    w = 40.0

    def rhs(y, t):
        return jnp.stack([-w * y[1], w * y[0]])

    t_end = np.float32(0.7853982)  # ~pi/4: cos/sin well away from 0/1
    ts = jnp.linspace(np.float32(0.0), t_end, n_save, dtype=jnp.float32)
    y0 = jnp.asarray([1.0, 0.0], jnp.float32)
    ys = integrate_adaptive(Heun(), rhs, y0, ts, 1e-3, rtol=1e-5, atol=1e-8)
    th = w * np.asarray(ts, np.float64)
    expect = np.stack([np.cos(th), np.sin(th)], axis=-1)
    np.testing.assert_allclose(np.asarray(ys, np.float64), expect,
                               rtol=0, atol=5e-3)


def test_stats_and_batched_capture_f32():
    # Batched state + stats path still captures every point on an f32 grid.
    y0 = jnp.asarray([1.0, 2.0, 0.5], jnp.float32)
    ts = jnp.linspace(0.0, 1.0, 11, dtype=jnp.float32)
    ys, stats = integrate_adaptive(
        Tsit5(), _exp_decay_rhs, y0, ts, 0.05, rtol=1e-6, atol=1e-9,
        return_stats=True, batch_ndim=1,
    )
    expect = np.asarray(y0)[None] * np.exp(-np.asarray(ts, np.float64))[:, None]
    np.testing.assert_allclose(np.asarray(ys, np.float64), expect,
                               rtol=1e-2, atol=1e-2)
    assert int(stats["accepted_steps"]) > 0
