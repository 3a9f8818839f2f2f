"""Sparse format parity tests: each device format must match scipy CSR.

Mirrors the verification role scipy's SpMV plays in the reference Arnoldi
loops (reference solvers.py:95,191,370) — here promoted to real unit tests.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp

from structurepreservingiterativesolvers_tpu.ops import (
    BSR,
    DIA,
    ELL,
    bsr_from_scipy,
    dia_from_scipy,
    ell_from_scipy,
    from_scipy,
    spmm,
    spmv,
)

RNG = np.random.default_rng(0)


def random_csr(n, density=0.05):
    A = sp.random(n, n, density=density, random_state=RNG, format="csr")
    A.setdiag(RNG.standard_normal(n))
    return sp.csr_matrix(A)


def periodic_band(n, offsets=(-2, -1, 0, 1, 2)):
    rows, cols, vals = [], [], []
    for off in offsets:
        rows.append(np.arange(n))
        cols.append((np.arange(n) + off) % n)
        vals.append(RNG.standard_normal(n))
    return sp.csr_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(n, n),
    )


@pytest.mark.parametrize("conv", [ell_from_scipy, dia_from_scipy])
def test_spmv_matches_scipy_banded(conv):
    n = 64
    A = sp.csr_matrix(sp.diags([1.0, -2.0, 1.0], [-1, 0, 1], shape=(n, n)))
    x = RNG.standard_normal(n)
    Ad = conv(A)
    np.testing.assert_allclose(np.asarray(spmv(Ad, jnp.asarray(x))), A @ x, rtol=1e-12)


def test_ell_spmv_random():
    A = random_csr(100)
    x = RNG.standard_normal(100)
    Ae = ell_from_scipy(A)
    np.testing.assert_allclose(np.asarray(spmv(Ae, jnp.asarray(x))), A @ x, rtol=1e-11, atol=1e-12)


def test_dia_periodic_wraps():
    n = 50
    A = periodic_band(n)
    Ad = dia_from_scipy(A)
    assert Ad.wrap
    assert len(Ad.offsets) == 5
    x = RNG.standard_normal(n)
    np.testing.assert_allclose(np.asarray(spmv(Ad, jnp.asarray(x))), A @ x, rtol=1e-12)


def test_spmm_matches_scipy():
    n = 80
    A = periodic_band(n)
    X = RNG.standard_normal((n, 7))
    for conv in (ell_from_scipy, dia_from_scipy):
        Ad = conv(A)
        np.testing.assert_allclose(
            np.asarray(spmm(Ad, jnp.asarray(X))), A @ X, rtol=1e-11, atol=1e-12
        )


def test_bsr_matches_scipy():
    n, bs = 64, 8
    A = sp.csr_matrix(sp.diags([1.0, -2.0, 1.0], [-bs, 0, bs], shape=(n, n)))
    Ab = bsr_from_scipy(A, bs)
    x = RNG.standard_normal(n)
    X = RNG.standard_normal((n, 5))
    np.testing.assert_allclose(np.asarray(spmv(Ab, jnp.asarray(x))), A @ x, rtol=1e-12)
    np.testing.assert_allclose(np.asarray(spmm(Ab, jnp.asarray(X))), A @ X, rtol=1e-12)


def test_from_scipy_autoselect():
    band = from_scipy(periodic_band(40))
    assert isinstance(band, DIA)
    rand = from_scipy(random_csr(40, density=0.3))
    assert isinstance(rand, ELL)


def test_todense_roundtrip():
    A = periodic_band(30)
    for conv in (ell_from_scipy, dia_from_scipy):
        Ad = conv(A)
        np.testing.assert_allclose(np.asarray(Ad.todense()), A.toarray(), rtol=1e-12)


def test_native_kernels_match_scipy():
    """In-tree C++ host kernels (native/spkernels.cpp) vs scipy."""
    from structurepreservingiterativesolvers_tpu.utils import native

    if not native.available():
        pytest.skip("native toolchain unavailable")
    n = 120
    A = sp.csr_matrix(sp.diags([-1.0, 4.0, -1.0], [-1, 0, 1], shape=(n, n)))
    x = RNG.standard_normal(n)
    np.testing.assert_allclose(native.csr_spmv(A, x), A @ x, rtol=1e-14)
    # tridiagonal ILU(0) has no fill ⇒ exact LU
    ilu = native.ILU0(A)
    b = RNG.standard_normal(n)
    np.testing.assert_allclose(A @ ilu.solve(b), b, rtol=1e-10, atol=1e-12)


def _random_dia(n, offsets, wrap, seed=0):
    """Random DIA matrix with the given (possibly periodic) diagonals, and
    the same matrix as scipy CSR."""
    rng = np.random.default_rng(seed)
    rows, cols, vals = [], [], []
    for off in offsets:
        for i in range(n):
            j = (i + off) % n if wrap else i + off
            if wrap or 0 <= j < n:
                rows.append(i)
                cols.append(j)
                vals.append(rng.standard_normal())
    A = sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
    return dia_from_scipy(A, wrap=wrap), A


DIA_CASES = [
    # n, offsets, wrap: short and long shifts, odd n, periodic wrap-around
    (1000, (-3, -1, 0, 1, 3), False),
    (1024, (-130, -1, 0, 1, 130), True),
    (777, (-256, 0, 256), False),
    (4096, (-1030, -1, 0, 2, 1030), True),
    (300, (-7, 0, 7), True),
]


@pytest.mark.parametrize("n,offsets,wrap", DIA_CASES)
def test_dia_roll_chain_matches_scipy(n, offsets, wrap):
    """The DIA SpMV (a fused chain of shifted multiply-adds) against scipy
    CSR in f64, including the zero fill of non-periodic shifts."""
    Ad, Ah = _random_dia(n, offsets, wrap)
    assert Ad.wrap == wrap and tuple(sorted(Ad.offsets)) == tuple(sorted(offsets))
    x = RNG.standard_normal(n)
    err = np.abs(np.asarray(Ad @ jnp.asarray(x)) - Ah @ x)
    assert np.all(err <= 1e-13 * (abs(Ah) @ np.abs(x))), err.max()
