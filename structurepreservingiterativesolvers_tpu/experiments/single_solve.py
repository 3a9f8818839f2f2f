"""SingleSolve experiment: one time-step, three solvers, full comparison.

Parity with the reference per-problem drivers (reference
lkdv/SingleSolve.py:14-64 etc.): run GMRES and (prototypical) CGMRES at an
unreachably small tolerance with k iterations, compare both against the
direct solve, print relative errors and every invariant deviation, then
optionally tabulate and plot.
"""

from __future__ import annotations

from typing import Optional

import jax.numpy as jnp
import numpy as np

from . import report, wrappers

_MODELS = {}


def get_model(name: str):
    if not _MODELS:
        from ..models import heat, lkdv, lkdvrk, swe

        _MODELS.update(
            {"lkdv": lkdv, "lkdvrk": lkdvrk, "lkdvRK": lkdvrk, "heat": heat,
             "swe": swe}
        )
    return _MODELS[name]


def single_solve(
    problem: str = "lkdv",
    k: int = 20,
    tol: float = 1e-50,
    pre=None,
    plot: bool = False,
    filename: Optional[str] = None,
    verbose: bool = True,
    **params,
):
    model = get_model(problem)
    system = model.linforms(**params)
    x0 = jnp.zeros_like(system.b)

    if pre == "auto":
        # per-problem defaults mirroring the reference SingleSolve drivers:
        # lkdvRK uses an ILU factor (lkdvRK/SingleSolve.py:19-21) → our
        # batched block-Jacobi; heat's AMG is built but disabled there
        # (heat/SingleSolve.py:33-36) → None
        if problem.lower() == "lkdvrk":
            pre = model.element_block_preconditioner(system)
        else:
            pre = None

    x, solvedict = wrappers.gmres_wrapper(system, x0=x0, k=k, tol=tol, pre=pre,
                                          history=True)
    x_con, geodict = wrappers.cgmres_wrapper(system, x0=x0, k=k, tol=tol,
                                             pre=pre, history=True)
    x_dir, _ = wrappers.exact(system)

    xd = np.asarray(x_dir)
    out = {
        "system": system,
        "gmres": (x, solvedict),
        "cgmres": (x_con, geodict),
        "direct": x_dir,
        "gmres_error": float(np.max(np.abs(np.asarray(x) - xd) / np.abs(xd))),
        "cgmres_error": float(np.max(np.abs(np.asarray(x_con) - xd) / np.abs(xd))),
    }

    devs = {}
    for label, vec in (("gmres", x), ("cgmres", x_con), ("direct", x_dir)):
        inv = system.compute_invariants(jnp.asarray(vec))
        targets = report._targets(system, list(inv.keys()))
        devs[label] = {kk: float(inv[kk]) - targets[kk] for kk in inv}
    out["deviations"] = devs

    if verbose:
        print(f"cgmres error = {out['cgmres_error']:.6e}")
        print(f"gmres error = {out['gmres_error']:.6e}")
        for label in ("gmres", "cgmres", "direct"):
            for inv, d in devs[label].items():
                print(f"{label} {inv} deviation = {d:.6e}")

    if plot:
        table = report.tabulator(system, [solvedict, geodict], filename=filename)
        out["table"] = table
        report.convergence_plot(
            table,
            filename=(filename + ".pdf") if filename else None,
            title=problem,
        )
    return out
