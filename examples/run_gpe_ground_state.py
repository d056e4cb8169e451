"""GPE imaginary-time ground state (reference: run_gpe notebooks / data asset).

Computes the 2D BEC ground state via imaginary-time Strang splitting and can
regenerate the ``pde_opt_jax/data/ground_state.npy`` asset (the reference
ships the same artifact, ``pde_opt/data/ground_state.npy``).
"""

import argparse

import jax.numpy as jnp
import numpy as np

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import pde_opt_jax as p
from pde_opt_jax.utils import density, initialize_Psi


def compute_ground_state(N=256, save=None):
    atoms = 5e5
    hbar = 1.05e-34
    omega = 2 * np.pi * 10
    omega_z = np.sqrt(8) * omega
    mass = 3.8175406e-26
    a0 = 5.29177210903e-11
    a_s = 100 * a0
    x_s = np.sqrt(hbar / (mass * omega))
    t_s = 1 / omega
    Lx_ = 150e-6 / x_s
    k = 4 * np.pi * a_s * atoms * np.sqrt((mass * omega_z) / (2 * np.pi * hbar))

    domain = p.Domain((N, N), ((-Lx_ / 2, Lx_ / 2), (-Lx_ / 2, Lx_ / 2)))
    Psi0 = initialize_Psi(N, width=100, vortexnumber=0) * x_s
    Psi0 = Psi0 / jnp.sqrt(jnp.sum(density(Psi0)) * domain.dx[0] ** 2)

    eq = p.GPE2DTSControl(domain, k, 0.0, lambda t, x, y: 0.0, trap_factor=1.0)
    solver = p.StrangSplitting(eq.A_term, domain.dx[0], eq.fft, eq.ifft, -1j)
    y0 = jnp.stack([Psi0.real, Psi0.imag], axis=-1)
    yT = p.evolve(solver, eq.B_terms, y0, 0.0, 1e-5 / t_s, 10000)
    out = np.asarray(yT, dtype=np.float32)
    print(f"ground state {out.shape}; norm "
          f"{float((out[...,0]**2+out[...,1]**2).sum()*domain.dx[0]**2):.6f}")
    if save:
        np.save(save, out)
        print(f"saved to {save}")
    return out


if __name__ == "__main__":
    from pde_opt_jax.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    ap = argparse.ArgumentParser()
    ap.add_argument("--grid", type=int, default=256)
    ap.add_argument("--save", type=str, default=None)
    args = ap.parse_args()
    compute_ground_state(args.grid, args.save)
