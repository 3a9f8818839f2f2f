"""Preconditioner-quality parity vs the reference's SuperLU ILU.

The reference preconditions lkdvRK and swe with
``spilu(A, drop_tol=1e-4, fill_factor=10)`` (reference
lkdvRK/Evolve.py:51-52, swe/TimedSolve.py:23-24).  Triangular solves are
sequential, so the production stand-ins are RAS/block-Jacobi +
polynomial acceleration / inner-Krylov.  These tests run the EXACT
reference preconditioner (densified ILU oracle, precond/ilu_oracle.py)
through the same jitted solvers and assert the stand-ins reach comparable
preconditioned iteration counts (≤1.5× — SURVEY §2.4's
"iteration-equivalent ... with matched quality" demand).

Quality is measured on plain (F)GMRES iteration counts: the CGMRES endgame
entangles iteration count with *when* the constrained phase starts (too few
Krylov dims at gate time force extra iterations for ANY very strong
preconditioner — inherent to the algorithm, reference solvers.py:230), so
GMRES isolates the preconditioner.  A CGMRES certification run confirms the
constrained solve still certifies under each preconditioner.
Numbers are tabulated in docs/ILU_PARITY.md.
"""

import math

import pytest

from structurepreservingiterativesolvers_tpu import precond
from structurepreservingiterativesolvers_tpu.models import lkdvrk, swe
from structurepreservingiterativesolvers_tpu.models.lkdvrk import (
    element_block_preconditioner,
)
from structurepreservingiterativesolvers_tpu.precond.ilu_oracle import ilu_oracle
from structurepreservingiterativesolvers_tpu.solvers import cgmres, gmres


def _gmres_steps(system, pre, k=60, tol=1e-8):
    _, info = gmres(system.A, system.b, k=k, tol=tol, pre=pre)
    assert info["res"][-1] < tol
    return info["steps"]


def _assert_certifies(system, pre, k=60, tol=1e-8):
    cons = tuple(system.constraints())
    _, info = cgmres(system.A, system.b, k=k, tol=tol, constraints=cons, pre=pre)
    assert info["safety"] is True
    assert info["deviation"] < 1e-10


@pytest.mark.parametrize("M,degree,tstages", [(50, 3, 2), (100, 3, 2)])
def test_lkdvrk_ras_neumann_matches_ilu(M, degree, tstages):
    """RAS + Neumann(3) composite vs spilu on the GL stage system
    (reference lkdvRK/Evolve.py:51-52 pairing)."""
    s = lkdvrk.linforms(M=M, degree=degree, tstages=tstages)
    steps_ilu = _gmres_steps(s, ilu_oracle(s.A_csr))
    inner = element_block_preconditioner(
        s, elems_per_block=M // 5, overlap=2 * (M // 50))
    ours = precond.neumann_composite(s.A, inner, degree=3)
    steps_ours = _gmres_steps(s, ours)
    assert steps_ours <= math.ceil(1.5 * steps_ilu), (steps_ours, steps_ilu)
    _assert_certifies(s, ours)


def test_swe_neumann_matches_ilu():
    """Neumann(4) vs spilu on the C-grid shallow-water system (reference
    swe/TimedSolve.py:23-24 pairing)."""
    s = swe.linforms(M=16)
    steps_ilu = _gmres_steps(s, ilu_oracle(s.A_csr))
    ours = precond.neumann(s.A, degree=4)
    steps_ours = _gmres_steps(s, ours)
    assert steps_ours <= math.ceil(1.5 * steps_ilu), (steps_ours, steps_ilu)
    _assert_certifies(s, ours)
