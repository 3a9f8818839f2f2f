"""Preconditioner stack tests: each must accelerate convergence and remain
a valid right preconditioner (identical solution, fewer iterations)."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp

from structurepreservingiterativesolvers_tpu import precond
from structurepreservingiterativesolvers_tpu.models import heat, lkdvrk
from structurepreservingiterativesolvers_tpu.ops import dia_from_scipy
from structurepreservingiterativesolvers_tpu.solvers import cgmres, gmres

RNG = np.random.default_rng(7)


def test_jacobi_diagonal_extraction():
    A = sp.csr_matrix(sp.diags([1.0, 5.0, 1.0], [-1, 0, 1], shape=(32, 32)))
    Ad = dia_from_scipy(A)
    np.testing.assert_allclose(np.asarray(precond.diagonal(Ad)), A.diagonal())
    J = precond.jacobi(Ad)
    v = jnp.asarray(RNG.standard_normal(32))
    np.testing.assert_allclose(np.asarray(J(v)), np.asarray(v) / 5.0)


def test_chebyshev_accelerates_heat():
    s = heat.linforms(M=32)
    pre = precond.chebyshev(s.A, degree=8)
    _, plain = gmres(s.A, s.b, k=30, tol=1e-7)
    _, cheb = gmres(s.A, s.b, k=30, tol=1e-7, pre=pre)
    assert cheb["res"][-1] < 1e-7
    assert cheb["res"][-1] < plain["res"][-1] * 1e-2


def test_neumann_valid_preconditioner():
    s = heat.linforms(M=16)
    pre = precond.neumann(s.A, degree=4)
    x, info = gmres(s.A, s.b, k=40, tol=1e-9, pre=pre)
    import scipy.sparse.linalg as spla

    x_dir = spla.spsolve(s.A_csr, np.asarray(s.b))
    np.testing.assert_allclose(np.asarray(x), x_dir, rtol=1e-5, atol=1e-8)


def test_block_jacobi_lkdvrk():
    s = lkdvrk.linforms(N=10, M=50, degree=3, tstages=2, T=1.0)
    pre = lkdvrk.element_block_preconditioner(s, elems_per_block=2)
    _, plain = cgmres(s.A, s.b, k=60, tol=1e-6, constraints=s.constraints())
    _, blocked = cgmres(s.A, s.b, k=60, tol=1e-6, constraints=s.constraints(), pre=pre)
    assert blocked["res"][-1] < 1e-6
    assert blocked["steps"] < plain["steps"]
    assert blocked["safety"] is True


def test_preconditioner_is_operand_no_retrace():
    """Two different Jacobi instances must reuse the same jitted core
    (preconditioner data is an operand, not a static closure)."""
    s = heat.linforms(M=16)
    p1 = precond.jacobi(s.A)
    p2 = precond.Jacobi(dinv=p1.dinv * 1.0000001)
    x1, _ = gmres(s.A, s.b, k=10, tol=1e-9, pre=p1)
    x2, _ = gmres(s.A, s.b, k=10, tol=1e-9, pre=p2)
    assert np.isfinite(np.asarray(x1)).all() and np.isfinite(np.asarray(x2)).all()


def test_amg_accelerates_heat():
    from structurepreservingiterativesolvers_tpu.precond.amg import amg

    s = heat.linforms(M=64)
    pre = amg(s.A_csr)
    assert len(pre.levels) >= 2
    _, plain = gmres(s.A, s.b, k=30, tol=1e-8)
    _, accel = gmres(s.A, s.b, k=30, tol=1e-8, pre=pre)
    assert accel["res"][-1] < 1e-8
    assert accel["steps"] <= 25


def test_amg_with_cgmres_constraints():
    from structurepreservingiterativesolvers_tpu.precond.amg import amg

    s = heat.linforms(M=64)
    pre = amg(s.A_csr)
    x, info = cgmres(s.A, s.b, k=30, tol=1e-8, constraints=s.constraints(), pre=pre)
    assert info["safety"] is True
    inv = s.compute_invariants(x)
    assert abs(float(inv["mass"] - s.m0)) < 1e-10


def test_amg_structured_transfers_match_host_galerkin():
    """grid=(C,C) box aggregation: the gather-free device transfers
    (BoxProlong/BoxRestrict — DIA smoother + reshape) must reproduce the
    host Galerkin P/R exactly, every level must be DIA (no ELL gather in
    the V-cycle), and solver quality must match the greedy path."""
    import scipy.sparse as sp

    from structurepreservingiterativesolvers_tpu.ops.sparse import DIA
    from structurepreservingiterativesolvers_tpu.precond.amg import (
        BoxProlong,
        BoxRestrict,
        _rho_estimate,
        amg,
    )

    M = 32
    s = heat.linforms(M=M)
    C = M + 1
    pre = amg(s.A_csr, grid=(C, C), setup="host")
    assert all(isinstance(l.A, DIA) for l in pre.levels)
    assert isinstance(pre.levels[0].P, BoxProlong)
    assert isinstance(pre.levels[0].R, BoxRestrict)

    # host-side rebuild of the level-0 transfers
    A = sp.csr_matrix(s.A_csr, dtype=np.float64)
    n, box = A.shape[0], 3
    Cc = -(-C // box)
    idx = np.arange(n)
    agg = (idx // C // box) * Cc + (idx % C // box)
    P0 = sp.csr_matrix((np.ones(n), (idx, agg)), shape=(n, Cc * Cc))
    dinv = 1.0 / A.diagonal()
    rho = _rho_estimate(sp.diags(dinv) @ A)
    P = sp.csr_matrix(
        (sp.identity(n) - (2 / 3 / rho) * (sp.diags(dinv) @ A)) @ P0)
    rng = np.random.default_rng(2)
    e = rng.standard_normal(Cc * Cc)
    r = rng.standard_normal(n)
    np.testing.assert_allclose(
        np.asarray(pre.levels[0].P @ jnp.asarray(e)), P @ e, atol=1e-12)
    np.testing.assert_allclose(
        np.asarray(pre.levels[0].R @ jnp.asarray(r)), P.T @ r, atol=1e-12)

    _, info = gmres(s.A, s.b, k=30, tol=1e-8, pre=pre)
    assert info["res"][-1] < 1e-8
    assert info["steps"] <= 15


def test_amg_follows_system_dtype():
    """Regression for the round-3 f64 leak: the default TimedSolve builder
    must ship an AMG hierarchy in the SYSTEM dtype (f32 here), not the host
    CSR's f64 — an f64 hierarchy would silently promote the whole V-cycle
    (and, by promotion, the Arnoldi body) of an f32 solve to f64."""
    import jax

    from structurepreservingiterativesolvers_tpu.experiments.timed_solve import (
        default_pre_builder,
    )

    s = heat.linforms(M=32, dtype=jnp.float32)
    assert s.A_csr.dtype == np.float64  # the host matrix stays f64 (exact setup)
    pre = default_pre_builder("heat")(s)
    for leaf in jax.tree_util.tree_leaves(pre):
        assert leaf.dtype in (jnp.float32, jnp.int32), leaf.dtype
    out = pre(s.b)
    assert out.dtype == jnp.float32
    # and the solve stays entirely f32 (no silent promotion downstream)
    x, info = gmres(s.A, s.b, k=30, tol=1e-5, pre=pre)
    assert x.dtype == jnp.float32
    assert info["res"][-1] < 1e-5


def test_ras_overlap_beats_block_jacobi():
    """Restricted additive Schwarz (overlap) must cut iteration counts
    relative to non-overlapping block-Jacobi on the stiff RK system."""
    s = lkdvrk.linforms(N=10, M=50, degree=3, tstages=2, T=1.0)
    pre_bj = lkdvrk.element_block_preconditioner(s, elems_per_block=2)
    pre_ras = lkdvrk.element_block_preconditioner(s, elems_per_block=2, overlap=1)
    _, bj = cgmres(s.A, s.b, k=60, tol=1e-6, constraints=s.constraints(), pre=pre_bj)
    _, rs = cgmres(s.A, s.b, k=60, tol=1e-6, constraints=s.constraints(), pre=pre_ras)
    assert rs["steps"] < bj["steps"]
    assert rs["safety"] is True


def test_amg_device_setup_probing_exact():
    """Device setup (one jitted program, no host SpGEMM): the coloring-probe
    coarse operator must equal the dense Galerkin product of the SHIPPED
    transfers exactly (same smoothers, so the only difference is roundoff)."""
    import numpy as np

    from structurepreservingiterativesolvers_tpu.precond.amg import amg

    M = 32
    s = heat.linforms(M=M)
    C = M + 1
    pre = amg(s.A, grid=(C, C))  # device-operator input → device setup
    l0 = pre.levels[0]
    A0 = np.asarray(l0.A.todense())
    n = A0.shape[0]
    SPd = np.asarray(l0.P.S.todense())
    SRd = np.asarray(l0.R.S.todense())
    idx = np.arange(n)
    P0 = np.zeros((n, l0.P.Cc1 * l0.P.Cc2))
    agg = (idx // C // 3) * l0.P.Cc2 + (idx % C // 3)
    P0[idx, agg] = 1.0
    Ac_ref = P0.T @ SRd @ A0 @ SPd @ P0
    Ac_dev = np.asarray(pre.levels[1].A.todense())
    err = np.abs(Ac_dev - Ac_ref).max() / np.abs(Ac_ref).max()
    eps = float(np.finfo(np.asarray(s.b).dtype).eps)
    assert err < 100 * eps, err


def test_amg_device_setup_solver_quality():
    """Device-built hierarchy must precondition as well as the host-built
    one (same aggregation, same smoother form; only the ρ estimate differs)."""
    from structurepreservingiterativesolvers_tpu.precond.amg import amg

    M = 64
    s = heat.linforms(M=M)
    C = M + 1
    pre_d = amg(s.A, grid=(C, C))
    pre_h = amg(s.A_csr, grid=(C, C), setup="host")
    _, d = gmres(s.A, s.b, k=30, tol=1e-8, pre=pre_d)
    _, h = gmres(s.A, s.b, k=30, tol=1e-8, pre=pre_h)
    assert d["res"][-1] < 1e-8
    assert d["steps"] <= h["steps"] + 2

    x, info = cgmres(s.A, s.b, k=30, tol=1e-8, constraints=s.constraints(),
                     pre=pre_d)
    assert info["safety"] is True


def test_amg_device_setup_rejects_asymmetric():
    """The structured transfers assume A = Aᵀ (Sᵣ = I−ω_s·A·D⁻¹ equals the
    Galerkin Pᵀ only then); an asymmetric operator must be refused, not
    silently shipped (advisor r4 #2)."""
    import pytest
    import scipy.sparse as sp

    from structurepreservingiterativesolvers_tpu.precond.amg import (
        _StructuredSetupError,
        amg,
    )

    M = 32
    s = heat.linforms(M=M)
    C = M + 1
    A_bad = sp.csr_matrix(s.A_csr, copy=True).tolil()
    A_bad[5, 6] = 10.0 * A_bad[6, 5]  # break symmetry hard
    A_bad = sp.csr_matrix(A_bad)
    with pytest.raises(_StructuredSetupError):
        amg(A_bad, grid=(C, C), setup="device")
    # 'auto' falls back to the host greedy path and still works
    pre = amg(A_bad, grid=(C, C), setup="auto")
    _, info = gmres(s.A, s.b, k=30, tol=1e-8, pre=pre)
    assert info["res"][-1] < 1e-8


def _chebyshev_coeffs(pre):
    """Monomial coefficients of the polynomial ``Chebyshev.__call__``
    applies, from running its recurrence on numpy polynomials in λ."""
    P = np.polynomial.Polynomial
    lam = P([0.0, 1.0])
    theta = 0.5 * (pre.lmax + pre.lmin)
    delta = 0.5 * (pre.lmax - pre.lmin)
    sigma = theta / delta
    rho = 1.0 / sigma
    x = P([1.0 / theta])
    r = 1.0 - lam * x
    d = (2.0 * rho / delta) * r
    for _ in range(pre.degree - 1):
        x = x + d
        r = r - lam * d
        rho_new = 1.0 / (2.0 * sigma - rho)
        d = (rho_new * rho) * d + (2.0 * rho_new / delta) * r
        rho = rho_new
    return (x + d).coef


@pytest.mark.parametrize("problem", ["heat32", "swe32-wrap"])
def test_polynomial_preconditioners_match_dense(problem):
    """Chebyshev and Neumann applies (chained sparse SpMVs) against p(A)v
    evaluated densely in numpy: Horner on the recurrence's coefficients for
    Chebyshev, ω Σ (I − ωD⁻¹A)^i D⁻¹ v for Neumann."""
    from structurepreservingiterativesolvers_tpu.models import swe

    s = heat.linforms(M=32) if problem == "heat32" else swe.linforms(M=32)
    if problem == "swe32-wrap":
        assert s.A.wrap  # periodic operator: shifts wrap around
    A = s.A_csr.toarray()
    n = A.shape[0]
    v = RNG.standard_normal(n)

    cheb = precond.chebyshev(s.A, degree=8)
    y = np.zeros(n)
    for c in _chebyshev_coeffs(cheb)[::-1]:
        y = A @ y + c * v
    got = np.asarray(cheb(jnp.asarray(v)))
    np.testing.assert_allclose(got, y, rtol=0, atol=1e-9 * np.abs(y).max())

    neu = precond.neumann(s.A, degree=4, omega=0.8)
    dinv = 1.0 / np.diag(A)
    B = np.eye(n) - 0.8 * dinv[:, None] * A
    term = 0.8 * dinv * v
    y = term.copy()
    for _ in range(3):
        term = B @ term
        y = y + term
    got = np.asarray(neu(jnp.asarray(v)))
    np.testing.assert_allclose(got, y, rtol=0, atol=1e-12 * np.abs(y).max())
