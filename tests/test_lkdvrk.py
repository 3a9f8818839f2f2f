"""lkdvRK (Gauss–Legendre stage-coupled) validation.

Covers the reference's tableau provider, stage system conservation, the
z1calc reconstruction, and CGMRES with stage-mapped constraints
(reference lkdvRK/ parity)."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse.linalg as spla

from structurepreservingiterativesolvers_tpu.models import lkdvrk
from structurepreservingiterativesolvers_tpu.models.tableaux import gauss_legendre
from structurepreservingiterativesolvers_tpu.solvers import cgmres, gmres


@pytest.mark.parametrize("s", [1, 2, 3, 4, 5])
def test_gauss_legendre_order_conditions(s):
    tb = gauss_legendre(s)
    assert abs(tb.b.sum() - 1.0) < 1e-13
    assert abs(tb.b @ tb.c - 0.5) < 1e-13
    np.testing.assert_allclose(tb.A.sum(axis=1), tb.c, atol=1e-12)
    # symplecticity condition: b_i a_ij + b_j a_ji − b_i b_j = 0
    S = tb.b[:, None] * tb.A + (tb.b[:, None] * tb.A).T - np.outer(tb.b, tb.b)
    assert np.abs(S).max() < 1e-12


@pytest.fixture(scope="module")
def sys2():
    return lkdvrk.linforms(N=10, M=50, degree=2, tstages=2, T=1.0)


def test_direct_stage_solve_conserves(sys2):
    k = spla.spsolve(sys2.A_csr, np.asarray(sys2.b))
    inv = sys2.compute_invariants(jnp.asarray(k))
    assert abs(float(inv["mass"] - sys2.m0)) < 1e-11
    assert abs(float(inv["momentum"] - sys2.mo0)) < 1e-11
    assert abs(float(inv["energy"] - sys2.e0)) < 1e-11


def test_stage_mapped_constraints_match_invariants(sys2):
    """The stage-space quadratic constraints must equal invariant deviations
    of the reconstructed z1 — the identity behind stage_mapped."""
    rng = np.random.default_rng(3)
    zbig = jnp.asarray(rng.standard_normal(sys2.prob.ns * sys2.dof))
    inv = sys2.compute_invariants(zbig)
    cons = sys2.constraints()
    np.testing.assert_allclose(float(cons[0](zbig)), float(inv["mass"] - sys2.m0), rtol=1e-10)
    np.testing.assert_allclose(float(cons[1](zbig)), float(inv["momentum"] - sys2.mo0), rtol=1e-10)
    np.testing.assert_allclose(float(cons[2](zbig)), float(inv["energy"] - sys2.e0), rtol=1e-10)


def test_cgmres_on_stage_system(sys2):
    k, tol = 40, 1e-6
    xg, _ = gmres(sys2.A, sys2.b, k=k, tol=tol)
    xc, ci = cgmres(sys2.A, sys2.b, k=k, tol=tol, constraints=sys2.constraints())
    ig, ic = sys2.compute_invariants(xg), sys2.compute_invariants(xc)
    assert ci["safety"] is True
    for key, ref0 in (("mass", sys2.m0), ("momentum", sys2.mo0), ("energy", sys2.e0)):
        dc = abs(float(ic[key] - ref0))
        dg = abs(float(ig[key] - ref0))
        assert dc < 1e-10
        assert 2.0 * dc <= dg + 1e-16


def test_one_step_error_small(sys2):
    kbig = spla.spsolve(sys2.A_csr, np.asarray(sys2.b))
    err = sys2.compute_error(jnp.asarray(kbig), t=sys2.prob.dt)
    assert err < 1e-3


def test_dg_mass_inverse_is_bsr(sys2):
    """The DG block mass inverse ships as BSR (the production consumer of
    the format): step_update's consistent-field solves run as batched
    block matmuls, and they reproduce the host LU solve."""
    from structurepreservingiterativesolvers_tpu.ops.sparse import BSR

    assert isinstance(sys2.Minv, BSR)
    assert sys2.Minv.block_size == sys2.prob.degree + 1
    rng = np.random.default_rng(0)
    v = jnp.asarray(rng.standard_normal(sys2.n0))
    host = spla.spsolve(sys2.Mh.tocsc(), np.asarray(v))
    np.testing.assert_allclose(np.asarray(sys2.Minv @ v), host, atol=1e-10)
