"""Auxiliary subsystems: checkpoint/resume, metrics, ptree tools."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pde_opt_jax.utils import checkpoint as ckpt
from pde_opt_jax.utils import metrics
from pde_opt_jax.utils import ptree
from pde_opt_jax.utils.modules import module
from pde_opt_jax.models.functions import DiffusionLegendrePolynomials


def test_checkpoint_roundtrip(tmp_path):
    tree = {
        "params": {"w": jnp.arange(6.0).reshape(2, 3), "b": jnp.zeros(3)},
        "step": 7,
        "env_state": jnp.ones((4, 8, 8)),
    }
    d = str(tmp_path / "ckpt")
    ckpt.save_checkpoint(d, 7, tree)
    assert ckpt.latest_step(d) == 7
    out = ckpt.restore_checkpoint(d, template=tree)
    np.testing.assert_array_equal(np.asarray(out["params"]["w"]),
                                  np.asarray(tree["params"]["w"]))
    assert out["step"] == 7


def test_checkpoint_resume_latest(tmp_path):
    d = str(tmp_path / "ckpt")
    for step in (1, 2, 3):
        ckpt.save_checkpoint(d, step, {"x": jnp.full((2,), float(step))})
    out = ckpt.restore_checkpoint(d, template={"x": jnp.zeros(2)})
    np.testing.assert_array_equal(np.asarray(out["x"]), [3.0, 3.0])


def test_metric_logger(tmp_path):
    path = str(tmp_path / "metrics.jsonl")
    log = metrics.MetricLogger(path, flush_every=2)
    log.log(0, loss=1.5, reward=-0.2)
    log.log(1, loss=1.2, reward=-0.1)
    log.flush()
    import json

    lines = [json.loads(l) for l in open(path)]
    assert lines[0]["loss"] == 1.5 and lines[1]["step"] == 1
    assert log.history("loss") == [(0, 1.5), (1, 1.2)]


def test_throughput_counter():
    t = metrics.Throughput()
    t.update(1000)
    assert t.rate > 0


def test_partition_combine_roundtrip():
    mod = DiffusionLegendrePolynomials(jnp.array([0.1, 0.2]))
    tree = {"kappa": 0.5, "mu": lambda c: c, "D": mod, "name": "x"}
    dyn, static = ptree.partition(tree)
    back = ptree.combine(dyn, static)
    assert back["kappa"] == 0.5
    assert back["name"] == "x"
    assert callable(back["mu"])
    np.testing.assert_array_equal(
        np.asarray(back["D"].expansion.params), [0.1, 0.2]
    )
    # Dynamic side holds only the inexact leaves.
    leaves = [l for l in jax.tree_util.tree_leaves(dyn)]
    assert len(leaves) == 2  # kappa float + params array


def test_ravel_params():
    tree = {"a": jnp.array([1.0, 2.0]), "b": 3.0, "fn": lambda x: x}
    flat, unravel = ptree.ravel_params(tree)
    assert flat.shape == (3,)
    out = unravel(flat * 2)
    np.testing.assert_array_equal(np.asarray(out["a"]), [2.0, 4.0])
    assert float(out["b"]) == 6.0
    assert callable(out["fn"])


def test_module_decorator_static_fields_in_jit_cache():
    @module(data_fields=("w",), static_fields=("n",))
    class Toy:
        def __init__(self, w, n):
            self.w = w
            self.n = n

        def __call__(self, x):
            return self.w * x * self.n

    t = Toy(jnp.array(2.0), 3)
    g = jax.grad(lambda m, x: m(x))(t, 1.0)
    np.testing.assert_allclose(float(g.w), 3.0)


def test_vortex_winding_analytic_charges():
    """A singly-quantized vortex at the grid center carries winding +1
    exactly once; its conjugate carries −1; a vortex-free cloud carries
    nothing (amplitude gating suppresses the vacuum tail)."""
    import numpy as np
    import jax.numpy as jnp
    from pde_opt_jax.utils.rl import detect_vortices, vortex_winding

    N = 32
    x = np.arange(N) - (N - 1) / 2
    X, Y = np.meshgrid(x, x, indexing="xy")
    r2 = X**2 + Y**2
    env = np.exp(-r2 / (2 * 4.0**2)) * np.sqrt(r2 / (r2 + 2.0))
    psi = jnp.asarray(env * np.exp(1j * np.arctan2(Y, X)))

    census = detect_vortices(psi, amp_thresh=1e-4)
    assert census["num_vortices"] == 1
    assert census["total_topological_charge"] == 1

    anti = detect_vortices(jnp.conj(psi), amp_thresh=1e-4)
    assert anti["total_topological_charge"] == -1

    plain = jnp.asarray(np.exp(-r2 / (2 * 4.0**2)) + 0j)
    assert int(np.abs(np.asarray(vortex_winding(plain, amp_thresh=1e-4))).sum()) == 0

    # Batch axes lead: the batched call matches per-element calls.
    batch = jnp.stack([psi, jnp.conj(psi)])
    w = np.asarray(vortex_winding(batch, amp_thresh=1e-4))
    np.testing.assert_array_equal(w[0], np.asarray(vortex_winding(psi, amp_thresh=1e-4)))
    np.testing.assert_array_equal(w[1], np.asarray(vortex_winding(jnp.conj(psi), amp_thresh=1e-4)))
