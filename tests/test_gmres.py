"""FGMRES validation against scipy direct solves and scipy's gmres.

Formalises the reference's manual direct-solver oracle (reference
lkdv/SingleSolve.py:36-40): iterative solution must approach spsolve's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from structurepreservingiterativesolvers_tpu.ops import dia_from_scipy, ell_from_scipy
from structurepreservingiterativesolvers_tpu.solvers import gmres

RNG = np.random.default_rng(1)


def laplace_1d(n):
    return sp.csr_matrix(sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(n, n)))


def test_gmres_converges_to_direct():
    n = 64
    A = laplace_1d(n)
    b = RNG.standard_normal(n)
    x_dir = spla.spsolve(A, b)
    x, info = gmres(dia_from_scipy(A), jnp.asarray(b), k=n, tol=1e-12)
    assert info["steps"] <= n
    np.testing.assert_allclose(np.asarray(x), x_dir, rtol=1e-8, atol=1e-9)
    assert info["res"][-1] < 1e-12


def test_gmres_residual_monotone_and_true():
    n = 48
    A = laplace_1d(n) + sp.identity(n)
    b = RNG.standard_normal(n)
    x, info = gmres(dia_from_scipy(A), jnp.asarray(b), k=30, tol=1e-10, history=True)
    res = info["res"]
    # true residuals must match ||Ax-b|| of the stored iterate history
    for j in range(info["steps"]):
        xj = info["x"][j + 1]
        np.testing.assert_allclose(np.linalg.norm(A @ xj - b), res[j], rtol=1e-8)
    assert np.all(np.diff(res) <= 1e-10)


def test_gmres_with_matrix_preconditioner():
    n = 80
    A = sp.csr_matrix(sp.diags([1.0, 10.0, 1.0], [-1, 0, 1], shape=(n, n)))
    b = RNG.standard_normal(n)
    Minv = sp.diags(1.0 / A.diagonal())  # Jacobi
    x_plain, info_plain = gmres(ell_from_scipy(A), jnp.asarray(b), k=60, tol=1e-10)
    x_pre, info_pre = gmres(
        ell_from_scipy(A), jnp.asarray(b), k=60, tol=1e-10,
        pre=dia_from_scipy(Minv),
    )
    assert info_pre["steps"] <= info_plain["steps"]
    np.testing.assert_allclose(np.asarray(x_pre), spla.spsolve(A, b), rtol=1e-7, atol=1e-9)


def test_gmres_warm_start():
    n = 32
    A = laplace_1d(n) + sp.identity(n)
    b = RNG.standard_normal(n)
    x_dir = spla.spsolve(A, b)
    x, info = gmres(dia_from_scipy(A), jnp.asarray(b), x0=jnp.asarray(x_dir), k=10, tol=1e-10)
    assert info["steps"] == 0
    np.testing.assert_allclose(np.asarray(x), x_dir, rtol=1e-12)


def test_gmres_estimate_mode_matches():
    n = 40
    A = laplace_1d(n) + sp.identity(n)
    b = RNG.standard_normal(n)
    _, info_t = gmres(dia_from_scipy(A), jnp.asarray(b), k=25, tol=1e-9)
    _, info_e = gmres(dia_from_scipy(A), jnp.asarray(b), k=25, tol=1e-9, true_residual=False)
    # Givens residual estimate equals the true residual in exact arithmetic
    m = min(len(info_t["res"]), len(info_e["res"]))
    np.testing.assert_allclose(info_t["res"][:m], info_e["res"][:m], rtol=1e-6, atol=1e-10)


def test_cgs2_orthogonality_matches_mgs():
    """CGS2 must deliver MGS-level basis orthogonality (the stability the
    constrained endgame depends on, SURVEY §7)."""
    n = 96
    A = sp.random(n, n, density=0.2, random_state=RNG, format="csr") + 5 * sp.identity(n)
    from structurepreservingiterativesolvers_tpu.ops import ell_from_scipy
    from structurepreservingiterativesolvers_tpu.solvers.arnoldi import (
        arnoldi_step,
        init_state,
    )
    import jax.numpy as jnp
    from jax import lax

    Ad = ell_from_scipy(A)
    b = jnp.asarray(RNG.standard_normal(n))
    k = 40
    losses = {}
    for ortho in ("cgs2", "mgs"):
        st = init_state(b, jnp.linalg.norm(b), k)
        for j in range(k):
            st, _ = arnoldi_step(Ad, lambda v: v, st, jnp.int32(j), ortho)
        Q = np.asarray(st.Q[:k])
        losses[ortho] = np.abs(Q @ Q.T - np.eye(k)).max()
    # the reorthogonalised default must hold machine-level orthogonality and
    # be at least as good as plain MGS (which degrades near convergence)
    assert losses["cgs2"] < 1e-12, losses
    assert losses["cgs2"] <= losses["mgs"] * 1.5 + 1e-13, losses


@pytest.mark.parametrize("k1,n", [(21, 1000), (21, 8192), (9, 70000)])
def test_cgs2_orthogonality_bounds(k1, n):
    """A basis grown by CGS2 (two classical passes) from random vectors stays
    orthonormal to roundoff: f64 and f32 (the f32 bound would be ~1e-3 with
    reduced-precision matrix products)."""
    from structurepreservingiterativesolvers_tpu.solvers.arnoldi import _cgs2

    for dtype, bound in ((jnp.float64, 1e-13), (jnp.float32, 1e-5)):
        W = RNG.standard_normal((k1, n))
        Q = jnp.zeros((k1, n), dtype).at[0].set(
            jnp.asarray(W[0] / np.linalg.norm(W[0]), dtype))
        for j in range(k1 - 1):
            w, _ = _cgs2(Q, jnp.asarray(W[j + 1], dtype), j)
            Q = Q.at[j + 1].set(w / jnp.linalg.norm(w))
        Qh = np.asarray(Q, np.float64)
        assert np.abs(Qh @ Qh.T - np.eye(k1)).max() < bound, dtype


def test_cgs2_and_mgs_take_same_steps():
    """The default CGS2 and the reference's MGS give the same GMRES
    iteration count and solution on a preconditioned heat system."""
    from structurepreservingiterativesolvers_tpu import precond
    from structurepreservingiterativesolvers_tpu.models import heat

    s = heat.linforms(M=24)
    pre = precond.chebyshev(s.A, degree=8)
    x_c, i_c = gmres(s.A, s.b, k=60, tol=1e-10, pre=pre, ortho="cgs2")
    x_m, i_m = gmres(s.A, s.b, k=60, tol=1e-10, pre=pre, ortho="mgs")
    assert i_c["res"][-1] < 1e-10 and i_c["steps"] < 60
    assert i_c["steps"] == i_m["steps"]
    np.testing.assert_allclose(np.asarray(x_c), np.asarray(x_m), rtol=1e-8)
