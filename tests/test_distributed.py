"""Multi-host entry path: 2 real processes through ``init_distributed``.

Round-1 left ``parallel.mesh.init_distributed`` unexercised; this launches
two OS processes that initialize a distributed CPU JAX runtime against a
local coordinator, verify the global device view spans both processes, and
run a real cross-process collective (allgather).  This is the single-machine
stand-in for the multi-host pod entry (SURVEY.md §5: the reference has no
distributed backend at all).
"""

import os
import socket
import subprocess
import sys
import textwrap

import pytest

_WORKER = textwrap.dedent(
    """
    import os, sys
    # Scrub the single-process test env so each worker owns its backend:
    # an inherited platform choice or the 8-device flag would fight the
    # distributed CPU client.
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ.pop("XLA_FLAGS", None)
    os.environ["PYTHONPATH"] = ""

    import jax
    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, {repo!r})
    from pde_opt_jax.parallel.mesh import init_distributed

    coord, nproc, pid = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    init_distributed(coordinator_address=coord, num_processes=nproc,
                     process_id=pid)
    assert jax.process_count() == nproc, jax.process_count()
    assert len(jax.devices()) == nproc * jax.local_device_count()

    import jax.numpy as jnp
    from jax.experimental import multihost_utils

    x = jnp.full((4,), float(pid + 1))
    gathered = multihost_utils.process_allgather(x)
    assert gathered.shape == (nproc, 4), gathered.shape
    assert float(gathered[0, 0]) == 1.0 and float(gathered[1, 0]) == 2.0
    print(f"WORKER_OK {{pid}} devices={{len(jax.devices())}}")
    """
)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# Real timeout protection is the communicate(timeout=240) below (which
# kills both workers on expiry) — pytest-timeout is not installed in the
# image, so a timeout mark would be a silent no-op.
def test_two_process_distributed_init_and_collective(tmp_path):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER.format(repo=repo))
    coord = f"127.0.0.1:{_free_port()}"

    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "PYTHONPATH")}
    env["JAX_PLATFORMS"] = "cpu"

    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), coord, "2", str(pid)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
            text=True,
        )
        for pid in (0, 1)
    ]
    outs = []
    for pr in procs:
        try:
            out, _ = pr.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for p2 in procs:
                p2.kill()
            raise
        outs.append(out)
    for pid, (pr, out) in enumerate(zip(procs, outs)):
        assert pr.returncode == 0, f"worker {pid} failed:\n{out}"
        assert f"WORKER_OK {pid}" in out, out


def test_init_distributed_single_process_noop():
    from pde_opt_jax.parallel.mesh import init_distributed

    # No coordinator, no process count: must be a no-op (same script runs
    # unchanged on one host).
    init_distributed()
