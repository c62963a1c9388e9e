"""Runs the port's parallel code in gloo ranks on the CPU: the counterpart of
the JAX tests' virtual CPU mesh (``tests/conftest.py::run_in_cpu_subprocess``).

:func:`run_ranks` starts ``n`` processes, each ``RANK`` r of ``WORLD_SIZE``
n with ``MASTER_ADDR``/``MASTER_PORT`` on the loopback interface (as
``torchrun`` sets them) and one PyTorch thread, and runs
``tests/torch_parallel_ranks.py::<case>(out, **kwargs)`` in each.  The port's
``make_mesh(..., device='cpu')`` then starts its gloo process group from
those variables.  Every rank has a deadline: a hang fails the test that
started it instead of the whole run, and the first rank to fail stops the
others.  Each call takes a free port; a port taken by another process
between the check and the bind is retried.
"""

import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time

import numpy as np

from nsof_tpu_torch.parallel.mesh import free_port

ROOT = pathlib.Path(__file__).resolve().parent.parent
RANK_TIMEOUT = 180
PORT_TRIES = 3


def _spawn(n: int, case: str, out: pathlib.Path, kwargs: dict, logs: pathlib.Path):
    port = free_port()
    procs = []
    for r in range(n):
        env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(n),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), OMP_NUM_THREADS="1",
                   PYTHONPATH=f"{ROOT}{os.pathsep}{ROOT / 'tests'}{os.pathsep}"
                              f"{os.environ.get('PYTHONPATH', '')}")
        code = ("import sys, json; from tests import torch_parallel_ranks as t; "
                f"t.main({case!r}, {str(out)!r}, json.loads(sys.argv[1]))")
        log = open(logs / f"rank{r}.log", "w")
        procs.append((subprocess.Popen([sys.executable, "-c", code, json.dumps(kwargs)],
                                       cwd=ROOT, env=env, stdout=log,
                                       stderr=subprocess.STDOUT), log))
    return procs


def _wait(procs, timeout: float) -> str | None:
    """None when every rank exits 0; else why not (every rank is stopped)."""
    deadline = time.monotonic() + timeout
    why = None
    while why is None and any(p.poll() is None for p, _ in procs):
        if time.monotonic() > deadline:
            why = f"timed out after {timeout} s"
        elif any(p.poll() not in (None, 0) for p, _ in procs):
            why = "a rank failed"
        else:
            time.sleep(0.05)
    for p, log in procs:
        if p.poll() is None:
            p.kill()
        p.wait()
        log.close()
    if why is None and any(p.returncode for p, _ in procs):
        why = "a rank failed"
    return why


def run_ranks(n: int, case: str, timeout: float = RANK_TIMEOUT, **kwargs) -> dict:
    """Run ``case`` in ``n`` gloo ranks; returns the arrays rank 0 saved."""
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        out = tmp / "out.npz"
        for attempt in range(PORT_TRIES):
            procs = _spawn(n, case, out, kwargs, tmp)
            why = _wait(procs, timeout)
            logs = "\n".join(f"── rank {r} ──\n" + (tmp / f"rank{r}.log").read_text()
                             for r in range(n))
            if why is None:
                with np.load(out) as z:
                    return dict(z)
            if "Address already in use" not in logs or attempt == PORT_TRIES - 1:
                raise AssertionError(f"{case} in {n} gloo ranks: {why}\n{logs}")
    raise AssertionError("unreachable")
