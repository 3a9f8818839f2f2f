"""Evolve experiment: full time-stepping with invariant-drift tracking.

Parity with the reference Evolve drivers (reference lkdv/Evolve.py:18-114,
lkdvRK/Evolve.py:19-146, swe/Evolve.py:18-99) plus the heat equation (the
reference ships no heat Evolve; here it comes for free).  Unlike the
reference — which reassembles the full Firedrake system every step — the
step loop re-seeds b and the invariant targets on device
(``System.step_update``) and reuses the operators, so the whole evolution
stays on the accelerator.

``DeviationPlotter`` runs GMRES then CGMRES at a user tolerance and overlays
the invariant drift (lkdv/Evolve.py:70-114).
"""

from __future__ import annotations

from typing import Optional

import jax.numpy as jnp
import numpy as np

from . import report, wrappers
from .single_solve import get_model


def evolve(
    problem: str = "lkdv",
    N: int = 100,
    M: int = 50,
    degree: int = 1,
    k: int = 50,
    tol: float = 1e-6,
    contol: float = 10.0,
    solver=wrappers.cgmres_wrapper,
    pre=None,
    warm_start: Optional[bool] = None,
    compute_error: bool = False,
    checkpoint: Optional[str] = None,
    checkpoint_every: int = 50,
    **params,
):
    """Run N time steps; returns time series of invariant drift (and L2
    error for lkdvRK, reference lkdvRK/Evolve.py:82).

    ``checkpoint``: optional .npz path — state is saved every
    ``checkpoint_every`` steps and the run resumes from it if present."""
    model = get_model(problem)
    system = model.linforms(N=N, M=M, degree=degree, **params)
    is_rk = problem.lower() == "lkdvrk"

    # warm-start semantics: the reference zeroes x0 for lkdv/swe
    # (lkdv/Evolve.py:43-45 quirk) and warm-starts only lkdvRK with the
    # previous stage vector (lkdvRK/Evolve.py:37,61); warm starting helps,
    # so it is the default here for RK and opt-in elsewhere.
    if warm_start is None:
        warm_start = is_rk

    inv0 = None
    names = []
    series = {}
    time_pts = [0.0]
    steps_hist = []

    if is_rk:
        x = jnp.tile(system.z0, system.prob.ns)  # stage warm start
    else:
        x = system.z0

    # initial invariants
    targets0 = {
        "mass": float(system.m0),
        **({"momentum": float(system.mo0)} if hasattr(system, "mo0") else {}),
        **({"energy": float(system.e0)} if hasattr(system, "e0") else {}),
    }
    names = list(targets0.keys())
    series = {n: [targets0[n]] for n in names}
    errs = [0.0] if compute_error else None

    start_step = 1
    if checkpoint:
        from ..utils.checkpoint import load_state, save_state

        resume = load_state(checkpoint)
        if resume is not None:
            start_step, z_saved, saved_series = resume
            x = jnp.asarray(z_saved, system.b.dtype)
            for nkey in names:
                if nkey in saved_series:
                    series[nkey] = list(saved_series[nkey])
            if compute_error and "err" in saved_series:
                errs = list(saved_series["err"])
            time_pts = list(saved_series.get("time", [0.0]))
            if start_step > 1:
                system = system.step_update(x)
            start_step += 1

    T = getattr(system.prob, "T", 1.0)
    dt_step = float(T) / N

    import jax as _jax

    for i in range(start_step, N + 1):
        x0 = x if warm_start else jnp.zeros_like(system.b)
        x, sdict = solver(system, x0=x0, k=k, tol=tol, pre=pre)
        steps_hist.append(sdict.get("steps", -1) if isinstance(sdict, dict) else -1)
        # ONE batched device→host fetch per step, not one per float(...)
        inv = _jax.device_get(system.compute_invariants(x))
        for n in names:
            if n in inv:
                series[n].append(float(inv[n]))
        t_now = dt_step * i
        time_pts.append(t_now)
        if compute_error and hasattr(system, "compute_error"):
            errs.append(system.compute_error(x, t=t_now))
        if checkpoint and (i % checkpoint_every == 0 or i == N):
            payload = {**series, "time": time_pts}
            if compute_error:
                payload["err"] = errs
            save_state(checkpoint, i, x, payload)
        # device-side next-step system
        if i < N:
            system = system.step_update(x)

    out = {
        "time": np.asarray(time_pts),
        "steps": steps_hist,
        "sol": x,
    }
    key_map = {"mass": "dm", "momentum": "dmo", "energy": "de"}
    for n in names:
        arr = np.asarray(series[n])
        out[key_map[n]] = np.abs(arr - arr[0])
        out[n] = arr
    if compute_error:
        out["err"] = np.asarray(errs)
    return out


def fused_evolve(
    problem: str = "lkdv",
    N: int = 100,
    M: int = 50,
    degree: int = 1,
    k: int = 30,
    tol: float = 1e-6,
    contol: float = 10.0,
    ctol: float = 1e-12,
    pre=None,
    warm_start: bool = True,
    mesh=None,
    loop: str = "while",
    **params,
):
    """Whole time evolution as ONE jitted ``lax.scan``: per step the system is
    re-seeded on device (``System.step_update``) and solved by the fused
    CGMRES core — zero host dispatch inside the loop.  This is the device
    answer to the reference's per-step reassemble-and-solve Python loop
    (lkdv/Evolve.py:55-66).

    ``mesh``: optional ``jax.sharding.Mesh`` — the system is row-sharded over
    it and the whole scan runs distributed (GSPMD collectives).

    Returns drift series identical in meaning to ``evolve``'s.
    """
    import dataclasses as _dc

    import jax
    from jax import lax

    from ..precond.base import is_operand_preconditioner, as_preconditioner
    from ..solvers.cgmres import _build_core

    model = get_model(problem)
    sys0 = model.linforms(N=N, M=M, degree=degree, **params)

    if mesh is not None:
        from ..ops.sparse import DIA, ELL
        from ..ops.stencil import Stencil
        from ..parallel import shard_matrix, shard_vector

        updates = {}
        for f in _dc.fields(sys0):
            val = getattr(sys0, f.name)
            if isinstance(val, (DIA, ELL, Stencil)):
                updates[f.name] = shard_matrix(val, mesh)
            elif isinstance(val, jnp.ndarray) and val.ndim == 1 and val.size > 16:
                updates[f.name] = shard_vector(val, mesh)
        sys0 = _dc.replace(sys0, **updates)
    is_rk = problem.lower() == "lkdvrk"
    cons0 = tuple(sys0.constraints())
    dt = sys0.b.dtype

    if is_operand_preconditioner(pre):
        static_pre, pre_op = None, pre
    else:
        static_pre = as_preconditioner(pre) if pre is not None else None
        pre_op = None

    mixed = dt == jnp.float32 and jax.config.jax_enable_x64
    from ..constraints.projection import snap_supported

    snap = dt == jnp.float32 and len(cons0) > 0 and snap_supported(cons0)
    core = _build_core(int(k), len(cons0), static_pre, False, False, mixed,
                       ("q",) * len(cons0), "cgs2", True, loop, snap,
                       mixed and snap)

    from ..solvers.hostio import dscalar

    tol_ = dscalar(tol, dt)
    contol_ = dscalar(contol, dt)
    ctol_ = dscalar(ctol, dt)

    def step(z_prev, _):
        sys_t = sys0.step_update(z_prev)
        cons = tuple(sys_t.constraints())
        x0 = z_prev if warm_start else jnp.zeros_like(sys_t.b)
        out = core(sys_t.A, sys_t.b, x0, cons, tol_, contol_, ctol_, pre_op)
        inv = sys_t.compute_invariants(out.x)
        metrics = {
            "steps": out.steps,
            "res": out.res[jnp.maximum(out.steps - 1, 0)],
            "safety": out.safety,
            **{nm: v for nm, v in inv.items()},
        }
        return out.x, metrics

    z_init = (jnp.zeros(sys0.prob.ns * sys0.dof, dt) if is_rk else sys0.z0)

    @jax.jit
    def run(z):
        return lax.scan(step, z, None, length=N)

    z_final, metrics = run(z_init)
    metrics = jax.device_get(metrics)  # one batched fetch, not one per leaf

    T = float(getattr(sys0.prob, "T", 1.0))
    out = {
        "time": np.linspace(0.0, T, N + 1)[1:],
        "steps": metrics["steps"],
        "safety": metrics["safety"],
        "sol": z_final,
    }
    key_map = {"mass": "dm", "momentum": "dmo", "energy": "de"}
    targets = {"mass": float(sys0.m0)}
    if hasattr(sys0, "mo0"):
        targets["momentum"] = float(sys0.mo0)
    if hasattr(sys0, "e0"):
        targets["energy"] = float(sys0.e0)
    for nm, key in key_map.items():
        if nm in metrics:
            out[key] = np.abs(metrics[nm] - targets.get(nm, 0.0))
            out[nm] = metrics[nm]
    return out


def deviation_plotter(
    problem: str = "lkdv",
    tol: float = 1e-6,
    filename: Optional[str] = None,
    **kwargs,
):
    """GMRES-vs-CGMRES invariant-drift overlay (reference DeviationPlotter)."""
    standard = evolve(problem, tol=tol, solver=wrappers.gmres_wrapper, **kwargs)
    conserved = evolve(problem, tol=tol, solver=wrappers.cgmres_wrapper, **kwargs)
    path = report.deviation_plot(
        {"GMRES": standard, "CGMRES": conserved}, filename=filename
    )
    return {"GMRES": standard, "CGMRES": conserved, "figure": path}
