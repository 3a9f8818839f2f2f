"""Experiment-layer tests: drivers run end-to-end and reproduce the
reference's qualitative results (drift suppression, conservation gains,
convergence orders)."""

import os

import numpy as np
import pytest

from structurepreservingiterativesolvers_tpu.experiments import (
    evolve,
    single_solve,
    time_cgmres,
    wrappers,
)
from structurepreservingiterativesolvers_tpu.solvers import cg
from structurepreservingiterativesolvers_tpu.models import heat
from structurepreservingiterativesolvers_tpu import precond


def test_single_solve_lkdv(capsys):
    out = single_solve("lkdv", k=20, tol=1e-50, M=50, degree=1, verbose=False)
    assert out["cgmres_error"] < 1e-6
    assert abs(out["deviations"]["cgmres"]["mass"]) < 1e-10
    assert abs(out["deviations"]["direct"]["energy"]) < 1e-10


def test_evolve_lkdv_drift_suppression():
    kw = dict(N=10, M=50, degree=2, k=30, tol=1e-6)
    g = evolve("lkdv", solver=wrappers.gmres_wrapper, **kw)
    c = evolve("lkdv", solver=wrappers.cgmres_wrapper, **kw)
    assert c["dm"][-1] < 1e-10
    assert c["de"][-1] < 1e-8
    assert c["de"][-1] < 1e-3 * max(g["de"][-1], 1e-30)


def test_evolve_heat_runs():
    """Properly-resourced heat evolution (cheb8 converges the midpoint solve
    at dt=0.2 in ~12 iterations): every step certifies both constraints and
    the evolution-level invariant drift stays at roundoff."""
    import warnings

    s0 = heat.linforms(M=16, N=5)
    pre = precond.chebyshev(s0.A, degree=8)
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)  # no degrade warnings
        out = evolve("heat", N=5, M=16, k=25, tol=1e-8,
                     pre=pre, solver=wrappers.cgmres_wrapper)
    assert out["dm"][-1] < 1e-9
    # dissipation identity drift over the whole evolution (the 'energy'
    # series tracks the per-step-adjusted invariant target)
    assert np.max(out["de"]) < 1e-9


def test_evolve_heat_overconstrained_degrades_like_reference():
    """Under-resourced config (no preconditioner, dt=0.2: residual stalls at
    ~3e-2 with tol=1e-8): enforcing both constraints in that Krylov subspace
    is genuinely infeasible, and the solver must warn-and-degrade exactly
    like the reference's failed SLSQP path (reference solvers.py:271-278) —
    while the LINEAR mass constraint, always enforceable, still holds."""
    import warnings

    with warnings.catch_warnings(record=True) as ws:
        warnings.simplefilter("always")
        out = evolve("heat", N=5, M=16, k=25, tol=1e-8,
                     pre=None, solver=wrappers.cgmres_wrapper)
    msgs = [str(w.message) for w in ws]
    assert any("failed to preserve constraints" in m for m in msgs)
    assert out["dm"][-1] < 1e-9  # mass conserved even in degrade mode


def test_time_cgmres_conservation_gain():
    out = time_cgmres("heat", M=32, k=25, tol=1e-7)
    con = out["conservation"]
    assert con["cgmres_mass"] * 2 <= con["gmres_mass"] + 1e-16
    assert con["cgmres_energy"] * 2 <= con["gmres_energy"] + 1e-16
    assert out["constrained_steps"] >= 1


def test_cg_on_heat():
    s = heat.linforms(M=32)
    x, info = cg(s.A, s.b, k=200, tol=1e-10, pre=precond.jacobi(s.A))
    import scipy.sparse.linalg as spla

    x_dir = spla.spsolve(s.A_csr, np.asarray(s.b))
    np.testing.assert_allclose(np.asarray(x), x_dir, rtol=1e-6, atol=1e-9)
    assert info["steps"] < 200


def test_error_sweep_serial(tmp_path):
    from structurepreservingiterativesolvers_tpu.experiments.error_sweep import (
        run_sweep,
    )

    merged = run_sweep(
        grid=[(2, 2, 1e-7)], solvers=("Exact", "CGMRES"), N=3, M=50, k=60,
        tmpdir=str(tmp_path),
    )
    assert len(merged) == 2
    exact = [m for m in merged if m["solver"] == "Exact"][0]
    cg_ = [m for m in merged if m["solver"] == "CGMRES"][0]
    # CGMRES tracks the exact solver's discretisation error
    assert cg_["err"][-1] < 5 * exact["err"][-1] + 1e-4
    assert os.path.exists(tmp_path / "error.pickle")


def test_fused_evolve_matches_host_loop():
    """The single-scan device evolution must match the host-driven loop's
    conservation behaviour."""
    from structurepreservingiterativesolvers_tpu.experiments.evolve import (
        fused_evolve,
    )

    out = fused_evolve("lkdv", N=10, M=50, degree=2, k=30, tol=1e-6)
    assert out["dm"][-1] < 1e-10
    assert out["de"][-1] < 1e-8
    assert np.all(out["safety"] == 1)


def test_fused_evolve_swe():
    from structurepreservingiterativesolvers_tpu.experiments.evolve import (
        fused_evolve,
    )

    out = fused_evolve("swe", N=5, M=16, k=20, tol=1e-7, T=1.0)
    assert np.all(out["safety"] == 1)
    assert out["dm"][-1] < 1e-9
    assert out["de"][-1] / 30000.0 < 1e-13  # relative to the O(3e4) energy


def test_evolve_checkpoint_resume(tmp_path):
    """Checkpointed evolution must resume and produce the same final state."""
    ckpt = str(tmp_path / "evolve.npz")
    kw = dict(N=8, M=50, degree=2, k=30, tol=1e-6, solver=wrappers.cgmres_wrapper)
    full = evolve("lkdv", **kw)
    # run first 4 steps, "crash", then resume
    evolve("lkdv", checkpoint=ckpt, checkpoint_every=4, **{**kw, "N": 8})
    import os

    assert os.path.exists(ckpt)
    from structurepreservingiterativesolvers_tpu.utils.checkpoint import load_state

    step, z, series = load_state(ckpt)
    assert step == 8
    resumed = evolve("lkdv", checkpoint=ckpt, checkpoint_every=4, **kw)
    np.testing.assert_allclose(resumed["dm"][-1], full["dm"][-1], atol=1e-12)


def test_fixture_roundtrip(tmp_path):
    """Portable CSR fixtures: save a model system, reload, solve, same
    invariant enforcement (SURVEY §2.4 fixture plan)."""
    import jax.numpy as jnp

    from structurepreservingiterativesolvers_tpu.models import lkdv, swe
    from structurepreservingiterativesolvers_tpu.models.fixtures import (
        load_fixture,
        save_fixture,
    )
    from structurepreservingiterativesolvers_tpu.solvers import cgmres

    for mod, name in ((lkdv, "lkdv"), (swe, "swe")):
        s = mod.linforms(M=16)
        path = str(tmp_path / f"{name}.npz")
        save_fixture(path, s, name)
        A, b, z0, cons, A_csr = load_fixture(path)
        x, info = cgmres(A, b, k=25, tol=1e-8, constraints=cons)
        assert info["safety"] is True
        x_ref, info_ref = cgmres(s.A, s.b, k=25, tol=1e-8,
                                 constraints=s.constraints())
        np.testing.assert_allclose(np.asarray(x), np.asarray(x_ref), rtol=1e-8,
                                   atol=1e-10)


def test_report_tabulator_and_plots(tmp_path):
    """Smoke-test the visualisation parity layer (tabulator → .tex/.csv,
    convergence and deviation plots)."""
    import jax.numpy as jnp

    from structurepreservingiterativesolvers_tpu.experiments import report
    from structurepreservingiterativesolvers_tpu.models import lkdv
    from structurepreservingiterativesolvers_tpu.solvers import cgmres_p, gmres

    s = lkdv.linforms(M=20, degree=1)
    _, gi = gmres(s.A, s.b, k=10, tol=1e-50, history=True)
    _, ci = cgmres_p(s.A, s.b, k=10, constraints=s.constraints(), history=True)
    table = report.tabulator(s, [gi, ci], filename=str(tmp_path / "tab"))
    assert (tmp_path / "tab.tex").exists()
    assert (tmp_path / "tab.csv").exists()
    assert "gmres residual norm" in table["columns"]
    assert "geosolve energy deviation" in table["columns"]
    assert len(table["rows"]) == max(len(gi["res"]), len(ci["res"]))
    assert table["rows"][0]["gmres residual norm"] == float(gi["res"][0])
    import csv

    with open(tmp_path / "tab.csv") as fh:
        assert len(list(csv.DictReader(fh))) == len(table["rows"])
    p1 = report.convergence_plot(table, filename=str(tmp_path / "conv.pdf"))
    assert (tmp_path / "conv.pdf").exists()

    runs = {
        "GMRES": {"time": np.arange(3.0), "dm": np.ones(3) * 1e-5,
                  "de": np.ones(3) * 1e-6},
    }
    report.deviation_plot(runs, filename=str(tmp_path / "dev.pdf"))
    assert (tmp_path / "dev.pdf").exists()


def test_wrapper_dispatch_threshold():
    """tol <= 1e-20 must dispatch to the prototypical solver
    (reference lkdv/LinearSolver.py:50-59)."""
    from structurepreservingiterativesolvers_tpu.models import lkdv

    s = lkdv.linforms(M=20, degree=1)
    _, info_p = wrappers.cgmres_wrapper(s, k=8, tol=1e-50)
    assert info_p["name"] == "geosolve"
    _, info_c = wrappers.cgmres_wrapper(s, k=8, tol=1e-8)
    assert info_c["name"] == "cgmres"
    import pytest as _pytest

    with _pytest.raises(NotImplementedError):
        wrappers.cgmres_wrapper(s, k=8, tol=1e-50, timing=True)


def test_cli_single_smoke(capsys):
    from structurepreservingiterativesolvers_tpu.experiments.cli import main

    main(["single", "--problem", "lkdv", "--k", "8", "--M", "20"])
    outp = capsys.readouterr().out
    assert "cgmres error" in outp


def test_error_sweep_parallel_fanout(tmp_path):
    """Process fan-out machinery (reference ErrorGenerator.py subprocess
    pool): small grid, 2 workers."""
    from structurepreservingiterativesolvers_tpu.experiments.error_sweep import (
        run_sweep,
    )

    merged = run_sweep(
        grid=[(1, 1, 1e-6)], solvers=("Exact", "CGMRES"), N=2, M=30, k=40,
        tmpdir=str(tmp_path), parallel=True, max_processes=2,
    )
    assert len(merged) == 2
    assert {m["solver"] for m in merged} == {"Exact", "CGMRES"}


def test_vmapped_batched_cgmres():
    """A batch of constrained solves as one vmapped program must match the
    individual solves (on-device sweep fan-out, SURVEY §7)."""
    import jax
    import jax.numpy as jnp

    from structurepreservingiterativesolvers_tpu.experiments.batched import (
        cgmres_many,
    )
    from structurepreservingiterativesolvers_tpu.models import lkdv
    from structurepreservingiterativesolvers_tpu.solvers import cgmres

    s = lkdv.linforms(M=50, degree=1)
    systems = [
        s.step_update(s.z0 * (1.0 + 0.01 * i)) for i in range(3)
    ]
    Bs = jnp.stack([t.b for t in systems])
    cons_list = [t.constraints() for t in systems]
    xs, info = cgmres_many(s.A, Bs, constraints_list=cons_list, k=20,
                           tol=1e-8)
    assert list(info["safety"]) == [1, 1, 1]
    for i, t in enumerate(systems):
        xi, _ = cgmres(t.A, t.b, k=20, tol=1e-8, constraints=t.constraints())
        np.testing.assert_allclose(np.asarray(xs[i]), np.asarray(xi),
                                   rtol=1e-8, atol=1e-11)


def test_markdown_table_formatter():
    from structurepreservingiterativesolvers_tpu.experiments.report import (
        markdown_table,
    )

    text = markdown_table([{"M": 16, "time": 0.00123, "ok": True},
                           {"M": 32, "time": 1.5e-5, "extra": "x"}])
    lines = text.splitlines()
    assert lines[0].split("|")[1:-1] == [" M  ", " time     ", " ok   ",
                                         " extra "]
    assert set(lines[1]) == {"|", "-"}
    assert lines[2] == "| 16 | 1.23e-03 | True |       |"
    assert lines[3] == "| 32 | 1.50e-05 |      | x     |"


def test_sweep_parallel_runs_serially_on_accelerator(monkeypatch, tmp_path,
                                                     capsys):
    """On a non-CPU backend ``parallel=True`` must not fan out processes
    (each would reserve the device): the grid runs in this process."""
    import subprocess

    import jax

    from structurepreservingiterativesolvers_tpu.experiments import error_sweep

    def no_popen(*a, **k):
        raise AssertionError("spawned a worker process on an accelerator")

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(subprocess, "Popen", no_popen)
    merged = error_sweep.run_sweep(
        grid=[(1, 1, 1e-6)], solvers=("Exact",), N=2, M=20, k=20,
        tmpdir=str(tmp_path), parallel=True, max_processes=2)
    assert [m["solver"] for m in merged] == ["Exact"]
    assert "serially in this process" in capsys.readouterr().out
