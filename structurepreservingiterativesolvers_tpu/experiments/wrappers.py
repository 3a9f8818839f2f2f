"""Problem-agnostic solver wrappers (parity with the per-problem
``LinearSolver.py`` modules of the reference).

Reference dispatch semantics: ``cgmres_wrapper`` uses the tolerance-driven
CGMRES for realistic tolerances and switches to the prototypical
constraint-by-constraint solver when the tolerance is unrealistically small
(``tol <= 1e-20``; reference lkdv/LinearSolver.py:50-59).  ``exact`` is the
direct-solver oracle (SuperLU in the reference, lkdv/LinearSolver.py:76-83)
— host scipy here, used for validation only.
"""

from __future__ import annotations

import warnings

import jax.numpy as jnp
import numpy as np

from ..solvers import cgmres, cgmres_p, gmres

PROTOTYPICAL_TOL = 1e-20


def reduction_mode(system, tol) -> dict:
    """Solver kwargs for the in-loop constraint-reduction arithmetic.

    The f32 (snap-first) reduction perturbs the constraint manifold by
    ~eps32·|c|, elevating the attainable constrained residual; when ``tol``
    lies between the plain f32 residual floor (≈ eps32·‖A‖·‖x‖ — below it
    nothing terminates and the reduction choice is pure speed) and that
    elevation (≈ 100·eps32·max|c|; swe's |e0| ≈ 2.9e4 puts it at ~5e-3),
    the f32 reduction blocks termination and the solver runs to k with
    ~10× the constrained steps — switch to the double-f32 reduction there.
    The wrapper knows the system, so it can afford the few scalar host
    reads the solver itself cannot (device values fetched once per call)."""
    if system.b.dtype != jnp.float32:
        return {}
    from ..ops.stencil import as_dia

    scale = max(
        [abs(float(np.asarray(c.c))) for c in system.constraints()
         if c.c is not None] or [0.0]
    )
    eps32 = float(np.finfo(np.float32).eps)
    elevation = 100.0 * eps32 * scale
    try:
        anorm = float(jnp.max(jnp.sum(jnp.abs(as_dia(system.A).data), axis=0)))
        xnorm = float(jnp.linalg.norm(system.z0))
        floor = eps32 * anorm * xnorm
    except (AttributeError, TypeError):
        floor = 0.0  # no DIA view / no z0: be conservative, allow dd
    if floor < tol < elevation:
        return {"f32_reduce": False}
    return {}


def cgmres_wrapper(system, x0=None, k=20, tol=1e-50, contol=10.0, pre=None,
                   timing=None, history=False, **solver_opts):
    cons = system.constraints()
    if tol > PROTOTYPICAL_TOL:
        opts = {**reduction_mode(system, tol), **solver_opts}
        return cgmres(system.A, system.b, x0, k=k, tol=tol, contol=contol,
                      constraints=cons, pre=pre, timing=bool(timing),
                      history=history, **opts)
    if timing:
        raise NotImplementedError(
            "Timings are not available for the prototypical solver"
        )
    return cgmres_p(system.A, system.b, x0, k=k, constraints=cons, pre=pre,
                    history=history)


def gmres_wrapper(system, x0=None, k=20, tol=1e-50, contol=None, pre=None,
                  history=False):
    if contol is not None:
        warnings.warn("contol is ignored as not used in GMRES")
    return gmres(system.A, system.b, x0, k=k, tol=tol, pre=pre, history=history)


def exact(system, x0=None, k=None, tol=None, pre=None, contol=None):
    """Direct-solve oracle via host sparse LU; returns (x, -1) like the
    reference's exact wrapper."""
    import scipy.sparse.linalg as spla

    x = spla.spsolve(system.A_csr, np.asarray(system.b, np.float64))
    return jnp.asarray(x, system.b.dtype), -1
