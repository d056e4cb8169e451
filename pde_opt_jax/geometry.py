"""Smoothed-boundary geometry.

Capability parity with ``/root/reference/pde_opt/numerics/shapes.py``: a
binary mask becomes a smooth level-set ψ by integrating a curvature-
regularized Allen-Cahn flow (:39-79), clamped away from zero (:34-37); the
mask's 4-neighbour graph Laplacian and its low eigenmodes provide a shape
basis (:81-203).

Implementation notes: the smoothing flow runs through this framework's own
adaptive Tsit5 driver (:mod:`pde_opt_jax.ops.integrate`) instead of diffrax —
one compiled ``while_loop`` on device.  The eigenmode computation is a
one-time host-side preprocessing step: the Laplacian is assembled from the
mask's directed link field (roll + seam cut) and its lowest modes come from
a direct dense symmetric solve (LOBPCG past ``_DENSE_EIG_LIMIT`` nodes);
the output ships to device as a constant basis.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .ops import stencils as st
from .ops.integrate import integrate_adaptive
from .ops.steppers import Tsit5

Array = jax.Array

__all__ = ["Shape"]


@dataclasses.dataclass
class Shape:
    """Geometry for the smoothed-boundary method.

    Args:
        binary: 0/1 mask of the domain interior.
        dx: grid spacings.
        smooth_epsilon: interface width of the smoothing flow.
        smooth_curvature: blend between full Laplacian (1.0) and
            curvature-free normal diffusion (0.0).
        smooth_dt: initial step of the adaptive smoothing integration.
        smooth_tf: final time of the smoothing flow.
    """

    binary: Array
    dx: Optional[Tuple[float, float]] = (1.0, 1.0)
    smooth_epsilon: float = 1.0
    smooth_curvature: float = 0.0
    smooth_dt: float = 0.1
    smooth_tf: float = 1.0

    def __post_init__(self):
        self.binary = jnp.asarray(self.binary)
        smooth = self.smooth_shape()
        smooth = jnp.where(smooth < 0.001, 0.001, smooth)
        smooth = jnp.where(smooth > 0.99, 1.0, smooth)
        self.smooth = smooth

    def smooth_shape(self) -> Array:
        """Run the curvature-regularized Allen-Cahn smoothing flow.

        Same flow as reference ``shapes.py:39-77`` (double-well potential
        18/ε·u(1−u)(1−2u), grad-norm floor 1e-7), integrated by this
        framework's adaptive Tsit5 + PID driver at rtol=1e-4/atol=1e-6.
        """
        eps = self.smooth_epsilon
        curv = self.smooth_curvature
        hx, hy = self.dx

        def potential(u):
            return 18.0 / eps * u * (1.0 - u) * (1.0 - 2.0 * u)

        def rhs(u, t):
            gx = st.grad_c(u, hx, -2)
            gy = st.grad_c(u, hy, -1)
            uxx = st.grad2_c(u, hx, -2)
            uyy = st.grad2_c(u, hy, -1)
            uxy = st.grad2_cross_c(u, hx, hy, -2, -1)
            mag2 = jnp.where(gx * gx + gy * gy < 1e-7, 1.0, gx * gx + gy * gy)
            # Second derivative along the interface normal, nᵀ·H·n.
            along_normal = (uxx * gx * gx + uyy * gy * gy
                            + 2.0 * uxy * gx * gy) / mag2
            blend = curv * (uxx + uyy) + (1.0 - curv) * along_normal
            return 2.0 * blend - potential(u) / eps

        y0 = self.binary.astype(jnp.result_type(float))
        ys = integrate_adaptive(
            Tsit5(), rhs, y0,
            ts=jnp.array([0.0, self.smooth_tf]),
            dt0=self.smooth_dt, rtol=1e-4, atol=1e-6,
        )
        return ys[-1]

    # ---- graph-Laplacian shape modes (host-side preprocessing) ---------

    def laplacian_from_mask(self, periodic: bool = False):
        """4-neighbour unnormalized graph Laplacian of the 0/1 mask.

        Host-side, one-time.  Returns ``(L, ids)`` where ``L`` is CSR of
        shape (n_nodes, n_nodes) and ``ids`` maps pixels to node index
        (−1 outside the mask).  Same operator as reference
        ``shapes.py:81-143`` (capability parity), assembled here from the
        directed *link field*: nodes are numbered in raster order by a
        cumulative sum over the flat mask, each axis contributes the links
        ``ids → roll(ids, −1)`` wherever both endpoints are in the mask
        (with the roll's wrap-around seam cut unless ``periodic``), and
        ``L = diag(degree) − (A + Aᵀ)`` symmetrizes in one shot.
        """
        from scipy import sparse

        mask = np.asarray(self.binary) > 0
        H, W = mask.shape
        n = int(mask.sum())
        ids = np.where(
            mask, np.cumsum(mask.ravel()).reshape(H, W) - 1, -1
        ).astype(np.int64)
        if n == 0:
            return sparse.csr_matrix((0, 0)), ids

        rows, cols = [], []
        for axis in (0, 1):
            ahead = np.roll(ids, -1, axis=axis)
            link = (ids >= 0) & (ahead >= 0)
            if not periodic:
                seam = [slice(None)] * 2
                seam[axis] = -1
                link[tuple(seam)] = False
            rows.append(ids[link])
            cols.append(ahead[link])
        r = np.concatenate(rows)
        c = np.concatenate(cols)
        adj = sparse.coo_matrix(
            (np.ones(r.size), (r, c)), shape=(n, n)
        )
        adj = (adj + adj.T).tocsr()
        degree = np.asarray(adj.sum(axis=1)).ravel()
        lap = (sparse.diags(degree) - adj).tocsr()
        return lap, ids

    # Above this node count, fall back from the dense symmetric
    # eigensolver to block-iterative LOBPCG (dense eigh is O(n³)/O(n²)
    # memory; 8192 nodes ≈ 0.5 GiB f64 and a few seconds — fine for a
    # one-time preprocessing step, past that iterate).
    _DENSE_EIG_LIMIT = 8192

    def get_shape_modes(self, N: Optional[int] = None):
        """First ``N`` graph-Laplacian eigenmodes of the mask (all if None).

        Smallest-eigenvalue modes of the operator from
        :meth:`laplacian_from_mask` — capability parity with reference
        ``shapes.py:145-203``, computed by a direct dense symmetric
        solve (``scipy.linalg.eigh`` on the lowest ``N`` indices) for
        typical mask sizes, with a LOBPCG block iteration beyond
        ``_DENSE_EIG_LIMIT`` nodes.  Results stored as
        ``self.shape_basis`` ((H, W, N) device array, zero off-mask) and
        ``self.shape_basis_evals``.
        """
        lap, node_ids = self.laplacian_from_mask()
        n = lap.shape[0]
        k = n if N is None else int(min(N, n))
        if k <= 0 or n == 0:
            raise ValueError("mask has no nodes or N <= 0")

        if n <= self._DENSE_EIG_LIMIT:
            import scipy.linalg

            evals, vecs = scipy.linalg.eigh(
                lap.toarray(), subset_by_index=(0, k - 1)
            )
        else:
            import scipy.sparse.linalg

            rng = np.random.default_rng(0)
            block = rng.standard_normal((n, k))
            block[:, 0] = 1.0  # seed the known constant kernel mode
            evals, vecs = scipy.sparse.linalg.lobpcg(
                lap, block, largest=False, tol=1e-7, maxiter=500
            )
            # lobpcg returns whatever it has at maxiter with only a warning;
            # an unconverged pair would silently hand downstream physics an
            # inaccurate shape basis.  Check the residuals ourselves and
            # retry harder once before giving up loudly.
            def _accepted(evals_, vecs_):
                # NaN-rejecting acceptance: lobpcg can return NaN pairs on
                # degenerate masks, and ``NaN > tol`` is False — the guard
                # must demand finite AND small residuals, not "not large".
                if not (np.isfinite(evals_).all()
                        and np.isfinite(vecs_).all()):
                    return False, np.inf, np.nan
                res_ = np.linalg.norm(
                    lap @ vecs_ - vecs_ * evals_[None, :], axis=0
                )
                tol_ = 1e-5 * max(1.0, float(np.abs(evals_).max()))
                return bool((res_ <= tol_).all()), float(res_.max()), tol_

            ok, res_max, tol = _accepted(evals, vecs)
            if not ok:
                rng2 = np.random.default_rng(1)
                block2 = rng2.standard_normal((n, k))
                block2[:, 0] = 1.0
                start = vecs if np.isfinite(vecs).all() else block2
                evals, vecs = scipy.sparse.linalg.lobpcg(
                    lap, start, largest=False, tol=1e-9, maxiter=2000
                )
                ok, res_max, tol = _accepted(evals, vecs)
                if not ok:
                    detail = (
                        "returned non-finite eigenpairs"
                        if not np.isfinite(tol)
                        else f"max residual {res_max:.3e} > {tol:.3e}"
                    )
                    raise RuntimeError(
                        "LOBPCG failed to converge the shape-mode basis: "
                        f"{detail} after retry (reduce N or coarsen the "
                        "mask)"
                    )
            order = np.argsort(evals)
            evals, vecs = evals[order], vecs[:, order]

        # Scatter node values back onto the grid: node numbering is raster
        # order, so the in-mask flat positions line up with vecs' rows.
        H, W = node_ids.shape
        grid = np.zeros((H * W, k))
        grid[np.flatnonzero(node_ids.ravel() >= 0)] = vecs
        self.shape_basis = jnp.asarray(grid.reshape(H, W, k))
        self.shape_basis_evals = evals
        return self.shape_basis, self.shape_basis_evals
