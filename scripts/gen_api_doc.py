"""Regenerate docs/api.md from package docstrings."""
import inspect
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")

import pde_opt_jax as p                      # noqa: E402
import pde_opt_jax.envs as envs              # noqa: E402
import pde_opt_jax.ops as ops                # noqa: E402
import pde_opt_jax.parallel as par           # noqa: E402
import pde_opt_jax.rl as rl                  # noqa: E402
import pde_opt_jax.utils as utils            # noqa: E402


def one_liner(obj, name=""):
    doc = inspect.getdoc(obj) or ""
    line = doc.split("\n")[0].strip()
    if not line or line.startswith(name + "("):
        return "configuration dataclass" if "Config" in name else (
            "state named-tuple" if "State" in name else line)
    return line[:120]


HEADER = """# API reference

The complete public surface.  Every class docstring cites the reference
`file:line` it is capability-parity with; symbols marked *(new)* are
capabilities beyond the reference.  Generated from the package
docstrings (`python scripts/gen_api_doc.py` regenerates this file).
"""

FOOTER = """## Extra (documented, not in `__all__`)

- **`pde_opt_jax.ops.cas_spectral.make_ch_cas_fused_macro`** — the
  whole-macro-step Cahn-Hilliard kernel (Pallas, Triton; interpreted on
  the CPU), with its optional env epilogue.
- **`pde_opt_jax.ops.spectral_reference`** — plain-XLA oracles of the
  semi-implicit macro-steps (`ch_sif_macro_reference`,
  `ac_sif_macro_reference`).
- **`pde_opt_jax.ops.dft`** — dense/separable matmul spectral solves.
- **`pde_opt_jax.parallel.halo`** — `halo_pad_rows`, `sharded_lap_2nd_2d`,
  `distributed_fft2/ifft2`, `make_sharded_sif_ch_macro`.
- **`pde_opt_jax.utils.checkpoint`** — orbax save/restore/latest_step.
- **`pde_opt_jax.utils.metrics`** — `MetricLogger`, `Throughput`, `trace_scope`.
- **`pde_opt_jax.utils.rl`** — `density`, `detect_vortices` (plaquette winding).
- **`pde_opt_jax.utils.testing`** — `l2_rel_err`, `check_convergence`,
  `fit_order`, `plot_convergence` (MMS harness).
- **`pde_opt_jax.models.symbolic`** — sympy manufactured-solution twins.
"""


def main():
    out = [HEADER]
    sections = [
        ("pde_opt_jax", p, "Top-level: equations, grids, geometry, model, steppers"),
        ("pde_opt_jax.ops", ops, "Numerical kernels and integration drivers"),
        ("pde_opt_jax.envs", envs, "Batched envs, presets, Gymnasium adapters"),
        ("pde_opt_jax.rl", rl, "Co-located RL learners *(new)*"),
        ("pde_opt_jax.parallel", par,
         "Meshes, sharded fleets, spatial decomposition *(new)*"),
        ("pde_opt_jax.utils", utils, "Compat contract, pytrees, ICs, testing, aux"),
    ]
    for modname, mod, blurb in sections:
        out.append(f"## `{modname}` — {blurb}\n")
        for name in getattr(mod, "__all__", []):
            obj = getattr(mod, name, None)
            out.append(f"- **`{name}`** — {one_liner(obj, name)}")
        out.append("")
    out.append(FOOTER)
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "docs", "api.md")
    with open(path, "w") as f:
        f.write("\n".join(out))
    print(f"wrote {path}")


if __name__ == "__main__":
    main()
