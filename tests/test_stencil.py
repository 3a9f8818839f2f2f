"""Constant-stencil fast path: decomposition, SpMV/SpMM parity, dispatch.

``ops/stencil.py`` is the matrix-free answer to the reference hot loop
``A @ z`` (reference solvers.py:95,191,370) for structured-grid operators:
``A = C + E`` with one constant per diagonal plus boundary-strip residuals
applied as static slices (a row-index gather/scatter correction would cost
more than the matrix reads it saves, so ``maybe_stencil`` only accepts
strip-shaped residuals).  Covered: parity against the explicit DIA operator
(boundary strips exercised on every edge), the all-constant and non-strip
fallback gates, SpMM, and the model-assembly wiring (heat assembles straight
into a Stencil).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp

from structurepreservingiterativesolvers_tpu.ops.sparse import DIA
from structurepreservingiterativesolvers_tpu.ops.stencil import (
    Stencil,
    as_dia,
    maybe_stencil,
    stencil_spmm,
    stencil_spmv,
)


def _grid_dia(R, C, offsets=None, perturb_strips=True, perturb_interior=(),
              seed=0, dtype=np.float64):
    """DIA for an R×C grid: constant diagonals, residuals on the boundary
    strips (first/last grid row, first/last grid column), plus optional
    interior perturbations (which must force the decomposition to decline)."""
    n = R * C
    if offsets is None:
        offsets = (-C - 1, -C, -1, 0, 1, C, C + 1)
    rng = np.random.default_rng(seed)
    consts = rng.standard_normal(len(offsets))
    data = np.zeros((len(offsets), n), dtype)
    for d, off in enumerate(offsets):
        lo, hi = max(0, -off), min(n, n - off)
        data[d, lo:hi] = consts[d]
    if perturb_strips:
        strip = np.zeros(n, bool)
        strip[:C] = True
        strip[n - C:] = True
        strip[::C] = True
        strip[C - 1::C] = True
        rows = np.nonzero(strip)[0]
        for d in range(len(offsets)):
            data[d, rows] += rng.standard_normal(rows.size)
    for r in perturb_interior:
        data[0, r] += 1.0
    return DIA(jnp.asarray(data), tuple(offsets), (n, n), False)


CASES = [
    # R, C — covering non-square grids, C not a multiple of lanes, tiny R
    (11, 13),
    (33, 32),
    (8, 128),
    (40, 17),
]


@pytest.mark.parametrize("R,C", CASES)
def test_spmv_matches_dia(R, C):
    A = _grid_dia(R, C)
    S = maybe_stencil(A)
    assert isinstance(S, Stencil), "strip decomposition should accept this"
    assert S.grid_c == C
    n = R * C
    x = jnp.asarray(np.random.default_rng(1).standard_normal(n))
    y_dia = A @ x
    y_st = S @ x
    np.testing.assert_allclose(np.asarray(y_st), np.asarray(y_dia),
                               rtol=1e-13, atol=1e-12)
    # uncorrected rows are exact: C alone reproduces them
    strip = np.zeros(n, bool)
    strip[:C] = True
    strip[n - C:] = True
    strip[::C] = True
    strip[C - 1::C] = True
    np.testing.assert_array_equal(
        np.asarray(y_st)[~strip], np.asarray(y_dia)[~strip]
    )


@pytest.mark.parametrize("R,C", CASES[:2])
def test_spmm_matches_dia(R, C):
    A = _grid_dia(R, C, seed=3)
    S = maybe_stencil(A)
    X = jnp.asarray(np.random.default_rng(2).standard_normal((R * C, 5)))
    np.testing.assert_allclose(
        np.asarray(stencil_spmm(S, X)), np.asarray(A @ X),
        rtol=1e-13, atol=1e-12,
    )


def test_spmv_noncontiguous_column_runs():
    # A wide stencil whose left/right corrections read X columns from
    # MULTIPLE non-adjacent contiguous runs ({0,1,2} and {C-3..C-1} here):
    # exercises the run-grouped slab slicing in _apply_strips.
    R, C = 12, 19
    A = _grid_dia(R, C,
                  offsets=(-2 * C, -C - 2, -C, -1, 0, 1, C, C + 2, 2 * C))
    S = maybe_stencil(A)
    assert isinstance(S, Stencil) and S.grid_c == C
    x = jnp.asarray(np.random.default_rng(3).standard_normal(R * C))
    np.testing.assert_allclose(np.asarray(S @ x), np.asarray(A @ x),
                               rtol=1e-13, atol=1e-12)


def test_all_constant_has_no_correction():
    # periodic 1-D constant stencil: every row identical, no strips needed
    n = 512
    rng = np.random.default_rng(0)
    consts = rng.standard_normal(3)
    data = np.tile(consts[:, None], (1, n))
    A = DIA(jnp.asarray(data), (-1, 0, 1), (n, n), True)
    S = maybe_stencil(A)
    assert isinstance(S, Stencil)
    assert S.grid_c == 0 and S.top_vals is None
    x = jnp.asarray(rng.standard_normal(n))
    np.testing.assert_array_equal(np.asarray(S @ x), np.asarray(A @ x))


def test_fallback_when_interior_rows_corrected():
    # interior perturbation → residual not strip-shaped → decline
    A = _grid_dia(16, 16, perturb_interior=(16 * 7 + 5,))
    assert maybe_stencil(A) is A


def test_fallback_when_not_stencil_like():
    rng = np.random.default_rng(0)
    n = 256
    data = rng.standard_normal((3, n))
    A = DIA(jnp.asarray(data), (-1, 0, 1), (n, n), True)
    assert maybe_stencil(A) is A


def test_fallback_passthrough_non_dia():
    X = jnp.ones((4, 4))
    assert maybe_stencil(X) is X
    assert as_dia(X) is X


def test_as_dia_roundtrip():
    A = _grid_dia(12, 12)
    S = maybe_stencil(A)
    assert as_dia(S) is S.dia
    np.testing.assert_array_equal(
        np.asarray(S.todense()), np.asarray(A.todense())
    )
    # DIA-compatible surface
    assert S.nnz == A.nnz
    assert S.shape == A.shape
    assert S.dtype == A.dtype
    assert S.corr_elements > 0
    np.testing.assert_array_equal(np.asarray(S.data), np.asarray(A.data))


def test_astype_casts_all_leaves():
    S = maybe_stencil(_grid_dia(10, 10)).astype(jnp.float32)
    assert S.const.dtype == jnp.float32
    assert S.top_vals.dtype == jnp.float32
    assert S.left_vals.dtype == jnp.float32
    assert S.dia.data.dtype == jnp.float32


def test_jit_operand():
    import jax

    S = maybe_stencil(_grid_dia(12, 14))
    x = jnp.asarray(np.random.default_rng(0).standard_normal(12 * 14))
    y = jax.jit(lambda A_, v: A_ @ v)(S, x)
    np.testing.assert_allclose(
        np.asarray(y), np.asarray(S.dia @ x), rtol=1e-13, atol=1e-12
    )


def test_heat_assembles_stencil_and_solves_identically():
    """Production wiring: heat's operator becomes a Stencil at real sizes and
    the solver result is identical to the explicit-DIA run."""
    import os

    from structurepreservingiterativesolvers_tpu.models import heat
    from structurepreservingiterativesolvers_tpu.solvers import gmres

    s = heat.linforms(M=64, N=100)
    assert isinstance(s.A, Stencil)
    assert s.A.grid_c == 65  # (M+1)² grid
    x_st, info_st = gmres(s.A, s.b, k=30, tol=1e-10)

    os.environ["SPIS_DISABLE_STENCIL"] = "1"
    try:
        s2 = heat.linforms(M=64, N=100)
    finally:
        del os.environ["SPIS_DISABLE_STENCIL"]
    assert isinstance(s2.A, DIA)
    x_dia, info_dia = gmres(s2.A, s2.b, k=30, tol=1e-10)
    assert info_st["steps"] == info_dia["steps"]
    np.testing.assert_allclose(
        np.asarray(x_st), np.asarray(x_dia), rtol=1e-12, atol=1e-12
    )


def test_block_system_declines():
    """lkdv/swe operators are block systems whose diagonals vary per field
    block — maybe_stencil must decline them (DIA path unchanged)."""
    from structurepreservingiterativesolvers_tpu.models import lkdv, swe

    assert isinstance(lkdv.linforms(M=100).A, DIA)
    assert isinstance(swe.linforms(M=16).A, DIA)


def test_cgmres_on_stencil_certifies():
    """Full constrained solve over a Stencil operator: the endgame and
    invariant certificate must behave exactly as on DIA."""
    from structurepreservingiterativesolvers_tpu.models import heat
    from structurepreservingiterativesolvers_tpu.solvers import cgmres

    s = heat.linforms(M=64, N=100)
    assert isinstance(s.A, Stencil)
    cons = tuple(s.constraints())
    x, info = cgmres(s.A, s.b, k=30, tol=1e-8, constraints=cons)
    assert info["safety"]
    assert info["deviation"] < 1e-10
