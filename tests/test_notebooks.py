"""Execute the generated tutorial notebooks end-to-end.

The reference's tutorial surface is ~18 notebooks that nothing executes in
CI (``/root/reference/.github/workflows/python-package.yml`` runs pytest
only, and ``pyproject.toml:38-39`` excludes notebooks even from lint) — so
they can silently rot.  Here the tutorials are generated from
``scripts/gen_notebooks.py`` and re-executed in a fresh kernel per notebook,
making the docs part of the test suite.

The full suite is ~minutes of CPU; by default this module executes a
representative fast subset and verifies the *generator* is in sync with the
committed notebooks for all of them.  Set ``PDE_OPT_NB_ALL=1`` to
execute every notebook (CI does).
"""

import os
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NB_DIR = os.path.join(REPO, "docs", "notebooks")
sys.path.insert(0, os.path.join(REPO, "scripts"))

import gen_notebooks  # noqa: E402

ALL = sorted(gen_notebooks.NOTEBOOKS)
# Fast, dependency-light subset for the default test run: covers forward
# solves, MMS, BCs, inverse problems, env + PPO, sharding + checkpoint.
FAST = [
    "01_solving_pdes",
    "04_convergence_mms",
    "05_boundary_conditions",
    "09_implicit_and_adaptive",
    "10_inverse_problems",
    "13_rl_environments",
    "14_rl_ppo",
    "15_fleets_sharding_checkpoint",
    "16_spatial_decomposition",
]
RUN = ALL if os.environ.get("PDE_OPT_NB_ALL") else FAST


def test_all_notebooks_committed_and_in_sync():
    """Every registered notebook exists on disk with the generated sources."""
    import nbformat

    for name in ALL:
        path = os.path.join(NB_DIR, f"{name}.ipynb")
        assert os.path.exists(path), f"missing {path}; run scripts/gen_notebooks.py"
        on_disk = nbformat.read(path, as_version=4)
        generated = gen_notebooks.build(name)
        disk_src = [c.source for c in on_disk.cells]
        gen_src = [c.source for c in generated.cells]
        assert disk_src == gen_src, (
            f"{name}.ipynb is out of sync with scripts/gen_notebooks.py; "
            "re-run scripts/gen_notebooks.py --execute"
        )


@pytest.mark.parametrize("name", RUN)
def test_notebook_executes(name):
    """Run the notebook top-to-bottom in a fresh CPU kernel."""
    nb = gen_notebooks.build(name)
    gen_notebooks.execute(nb, NB_DIR, timeout=600)
    # Any raised error fails execute(); also assert no error outputs slipped
    # through (e.g. from allow-errors style configs).
    for cell in nb.cells:
        for out in getattr(cell, "outputs", []):
            assert out.get("output_type") != "error", out
