"""Convergence-order error sweep with process-parallel fan-out.

Parity with the reference pipeline (reference lkdvRK/ErrorGenerator.py:11-80
→ subcall.py:16-67 → ErrorPlotter.py:11-46): run Exact/GMRES/CGMRES over a
(degree, tstages, tol) grid of lkdvRK evolutions, in parallel worker
processes capped at ``max_processes``, persist per-run pickles keyed by the
parameter tuple (crash-tolerant: failed runs are skipped at merge, reference
ErrorGenerator.py:62-74), merge, and plot L2 error vs time.

``run_sweep(parallel=False)`` runs the grid serially in this process.  The
process pool is for the CPU backend only: on an accelerator each JAX process
reserves most of the device's memory, so ``parallel=True`` there falls back
to the serial loop (and says so).
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
import time
from typing import List, Optional, Sequence, Tuple

# the reference's grid (lkdvRK/ErrorGenerator.py:28-39)
DEFAULT_GRID: Sequence[Tuple[int, int, float]] = (
    (3, 2, 1e-3),
    (4, 3, 1e-5),
    (5, 4, 1e-7),
)
SOLVERS = ("Exact", "GMRES", "CGMRES")


def _pickle_path(tmpdir, solver, tstages, degree, tol, N, M):
    return os.path.join(
        tmpdir, f"error{solver}{tstages}{degree}{tol}{N}{M}.pickle"
    )


def run_single(
    solver: str,
    degree: int,
    tstages: int,
    tol: float,
    N: int = 10,
    M: int = 400,
    k: int = 50,
    tmpdir: str = "tmp",
    precondition: bool = True,
) -> dict:
    """One evolution run (the reference's ``subcall``); pickles the result."""
    from ..models import lkdvrk
    from . import wrappers
    from .evolve import evolve

    os.makedirs(tmpdir, exist_ok=True)
    solver_fn = {
        "Exact": wrappers.exact,
        "GMRES": wrappers.gmres_wrapper,
        "CGMRES": wrappers.cgmres_wrapper,
    }[solver]

    pre = None
    if precondition and solver != "Exact":
        # the ILU-quality composite (RAS + Neumann acceleration) the timed
        # benchmarks use — the bare element-block preconditioner stalls at
        # reference-scale M (residual 0.4 → 0.01 in 50 iterations at M=400,
        # which blows up the evolution; the reference leans on spilu here,
        # reference lkdvRK/Evolve.py:51-52)
        from .timed_solve import default_pre_builder

        sys0 = lkdvrk.linforms(N=N, M=M, degree=degree, tstages=tstages, T=1.0)
        pre = default_pre_builder("lkdvrk")(sys0)

    if solver == "Exact":
        def solver_wrapped(system, x0=None, k=k, tol=tol, pre=None):
            x, _ = wrappers.exact(system)
            return x, {"steps": -1}
    else:
        def solver_wrapped(system, x0=None, k=k, tol=tol, pre=pre):
            return solver_fn(system, x0=x0, k=k, tol=tol, pre=pre)

    out = evolve(
        "lkdvrk", N=N, M=M, degree=degree, tstages=tstages, T=1.0, k=k,
        tol=tol, solver=solver_wrapped, pre=pre, compute_error=True,
    )
    out.pop("sol", None)  # device array; keep pickles portable
    out["degree"] = degree
    out["tstages"] = tstages
    out["solver"] = solver
    path = _pickle_path(tmpdir, solver, tstages, degree, tol, N, M)
    with open(path, "wb") as fh:
        pickle.dump(out, fh)
    return out


def run_sweep(
    grid: Sequence[Tuple[int, int, float]] = DEFAULT_GRID,
    solvers: Sequence[str] = SOLVERS,
    N: int = 10,
    M: int = 400,
    k: int = 50,
    tmpdir: str = "tmp",
    parallel: bool = False,
    max_processes: int = 12,
) -> List[dict]:
    """Full sweep; merged results are written to ``tmp/error.pickle``."""
    import jax

    os.makedirs(tmpdir, exist_ok=True)
    if parallel and jax.default_backend() != "cpu":
        print(f"sweep: {jax.default_backend()} backend — running the grid "
              "serially in this process (one JAX process per device)")
        parallel = False
    if parallel:
        procs: List[subprocess.Popen] = []

        def running():
            for p in reversed(range(len(procs))):
                if procs[p].poll() is not None:
                    del procs[p]
            return len(procs)

        for degree, tstages, tol in grid:
            for solver in solvers:
                cmd = [
                    sys.executable, "-m",
                    "structurepreservingiterativesolvers_tpu.experiments.error_sweep",
                    solver, str(degree), str(tstages), str(tol), str(N),
                    str(M), str(k), tmpdir,
                ]
                procs.append(subprocess.Popen(cmd))
                while running() >= max_processes:
                    time.sleep(1)
        while running():
            time.sleep(1)
    else:
        for degree, tstages, tol in grid:
            for solver in solvers:
                run_single(solver, degree, tstages, tol, N=N, M=M, k=k,
                           tmpdir=tmpdir)

    # merge (skip failures, reference ErrorGenerator.py:62-74)
    merged = []
    for solver in solvers:
        for degree, tstages, tol in grid:
            path = _pickle_path(tmpdir, solver, tstages, degree, tol, N, M)
            try:
                with open(path, "rb") as fh:
                    merged.append(pickle.load(fh))
            except Exception as e:  # noqa: BLE001
                print(f"Loading {path} failed with: {e}")
    with open(os.path.join(tmpdir, "error.pickle"), "wb") as fh:
        pickle.dump(merged, fh)
    return merged


def error_plot(tmpdir: str = "tmp", filename: Optional[str] = None):
    """L2 error vs time per solver/config (reference ErrorPlotter.py)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    with open(os.path.join(tmpdir, "error.pickle"), "rb") as fh:
        data = pickle.load(fh)

    styles = {"Exact": "solid", "GMRES": "dotted", "CGMRES": "dashed"}
    colors = ["r", "b", "k", "g", "m"]
    fig, ax = plt.subplots(figsize=(7, 5))
    for i, dic in enumerate(data):
        ax.semilogy(
            dic["time"], dic["err"], lw=2, linestyle=styles[dic["solver"]],
            color=colors[i % len(colors)],
            label=f"{dic['solver']}: q={dic['degree']}, s={dic['tstages']}",
        )
    ax.set_xlabel("t")
    ax.set_ylabel("L2 error")
    ax.legend(loc="best", fontsize="small", ncol=3)
    fig.tight_layout()
    out = filename or os.path.join("plots", "lkdvRKError.pdf")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    fig.savefig(out)
    plt.close(fig)
    print(f"Figure saved as {out}")
    return out


if __name__ == "__main__":
    # worker-process entry: solver degree tstages tol N M k tmpdir
    a = sys.argv[1:]
    run_single(a[0], int(a[1]), int(a[2]), float(a[3]), int(a[4]), int(a[5]),
               int(a[6]), a[7])
