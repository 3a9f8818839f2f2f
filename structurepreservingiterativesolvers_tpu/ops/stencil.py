"""Constant-stencil (matrix-free) operator: the fast path for
structured-grid FEM matrices.

Every reference problem assembles its operator on a *uniform* structured mesh
(reference lkdv/lkdv.py:48, heat/heat.py:35-121, swe/swe.py:90-99,
lkdvRK/lkdvRK.py:113-124), so away from the boundary every row of ``A`` is
the same stencil: ``A = C + E`` where ``C`` has one constant per diagonal and
``E`` touches only O(boundary) rows.  The reference pays scipy-CSR traffic
(indices + values per nonzero) for what is really a convolution; here the
SpMV reads **no matrix data at all** on the constant part — memory traffic
drops from ``nnz + 2n`` elements (the DIA formulation) to ``~2n`` plus an
O(boundary) correction, the dominant cost of every Krylov iteration
(reference solvers.py:95,191,370).

The correction must not undo that saving.  A row-index gather/scatter over
the corrected rows costs far more than the matrix reads it removes, so
corrections here are restricted to the shape they actually take on a
tensor-product grid: the corrected rows are the **boundary strips** of the
(R, C) grid view — first/last grid row (contiguous runs of the flat vector)
and first/last grid column (single columns of the 2-D view).  Applying them
is a few static slices and padded adds touching O(R+C) elements: no gather,
no scatter, no extra full-vector passes.

``maybe_stencil`` performs the host-side decomposition at assembly time
(exact on uncorrected rows, ulp-level on the O(boundary) corrected rows —
``c·x + e·x`` re-rounds once against ``(c+e)·x``) and returns the original
``DIA`` unchanged when the residual is not strip-shaped, so nothing
downstream needs to care.  ``Stencil`` mirrors the DIA operator surface
(``@``, ``shape``, ``nnz``, ``todense``, ``astype``, ``.data``/``.offsets``)
and keeps the full ``DIA`` as a field for consumers that need explicit
matrix values (preconditioner setup, sharding, SpMM catch-up, oracles).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from .sparse import DIA, _register, _shift


@_register
@dataclasses.dataclass(frozen=True)
class Stencil:
    """``A = C + E``: per-diagonal constants ``const`` plus boundary-strip
    residuals on the (R, C) grid view (``grid_c`` = C; 0 when the matrix is
    exactly constant and no correction exists).  ``dia`` is the full
    operator for fallback paths."""

    dia: DIA
    const: jnp.ndarray  # (ndiag,)
    top_vals: Optional[jnp.ndarray]  # (ndiag, C) resid on rows [0, C)
    bot_vals: Optional[jnp.ndarray]  # (ndiag, C) resid on rows [n-C, n)
    left_vals: Optional[jnp.ndarray]  # (ndiag, R) resid on rows r*C
    right_vals: Optional[jnp.ndarray]  # (ndiag, R) resid on rows r*C + C-1
    offsets: Tuple[int, ...]  # static
    shape: Tuple[int, int]  # static
    wrap: bool  # static
    grid_c: int = 0  # static: grid row length C (0 = no correction)

    _static = ("offsets", "shape", "wrap", "grid_c")

    # -- DIA-compatible surface -------------------------------------------
    @property
    def data(self):
        return self.dia.data

    @property
    def nnz(self) -> int:
        return self.dia.nnz

    @property
    def dtype(self):
        return self.dia.dtype

    @property
    def corr_elements(self) -> int:
        """Elements the strip correction reads+writes (traffic accounting)."""
        if not self.grid_c:
            return 0
        C = self.grid_c
        R = self.shape[0] // C
        return 2 * (C + R) * (len(self.offsets) + 2)

    def __matmul__(self, other):
        if other.ndim == 1:
            return stencil_spmv(self, other)
        return stencil_spmm(self, other)

    def astype(self, dtype):
        cast = lambda a: None if a is None else a.astype(dtype)
        return dataclasses.replace(
            self,
            dia=self.dia.astype(dtype),
            const=self.const.astype(dtype),
            top_vals=cast(self.top_vals),
            bot_vals=cast(self.bot_vals),
            left_vals=cast(self.left_vals),
            right_vals=cast(self.right_vals),
        )

    def todense(self) -> jnp.ndarray:
        return self.dia.todense()


def as_dia(A):
    """The explicit-matrix view of an operator (identity for plain DIA)."""
    return A.dia if isinstance(A, Stencil) else A


def _strip_cover(resid: np.ndarray, n: int, C: int):
    """Extract boundary-strip residuals for grid row length C, or None if
    nonzero residuals exist outside the strips."""
    if C < 2 or n % C or n // C < 3:
        return None
    R = n // C
    ndiag = resid.shape[0]
    corr = np.any(resid != 0.0, axis=0)
    in_strip = np.zeros(n, bool)
    in_strip[:C] = True
    in_strip[n - C:] = True
    in_strip[::C] = True
    in_strip[C - 1::C] = True
    if np.any(corr & ~in_strip):
        return None
    top = resid[:, :C].copy()
    bot = resid[:, n - C:].copy()
    left = resid[:, ::C].copy()
    right = resid[:, C - 1::C].copy()
    # corner grid rows are fully covered by the top/bottom strips
    left[:, 0] = left[:, R - 1] = 0.0
    right[:, 0] = right[:, R - 1] = 0.0
    return top, bot, left, right


def maybe_stencil(A):
    """Decompose a DIA matrix into constant stencil + boundary-strip residual.

    The constant for each diagonal is its *mode* over in-range rows.  The
    SpMV is exact on uncorrected rows (``E`` is identically zero there, so
    ``C`` alone reproduces the row); on corrected rows ``C·x + E·x`` differs
    from ``A·x`` only by one extra rounding of the split product (ulp-level).
    Returns ``A`` unchanged when the corrected rows are not the boundary
    strips of a tensor-product grid (see the module docstring), or when
    ``A`` is not a DIA.
    """
    import os

    if not isinstance(A, DIA) or os.environ.get("SPIS_DISABLE_STENCIL") == "1":
        return A
    data = np.asarray(A.data)
    ndiag, n = data.shape
    const = np.zeros((ndiag,), data.dtype)
    resid = np.zeros_like(data)
    for d, off in enumerate(A.offsets):
        if A.wrap:
            inr = slice(0, n)
        else:
            inr = slice(max(0, -off), min(n, n - off))
        col = data[d, inr]
        if col.size == 0:
            continue
        vals, counts = np.unique(col, return_counts=True)
        const[d] = vals[np.argmax(counts)]
        resid[d, inr] = col - const[d]
        # out-of-range positions are structural zeros: the shifted read is 0
        # there regardless of the coefficient, so C never contributes and E
        # stays 0 — nothing to correct.
    corr_rows = np.nonzero(np.any(resid != 0.0, axis=0))[0]
    if corr_rows.size == 0:
        return Stencil(
            dia=A, const=jnp.asarray(const),
            top_vals=None, bot_vals=None, left_vals=None, right_vals=None,
            offsets=A.offsets, shape=A.shape, wrap=A.wrap, grid_c=0,
        )
    # the strip correction costs O(R + C) whatever the corrected fraction,
    # so the only gates are wrap (periodic grids have no boundary strips)
    # and strip coverage itself
    if A.wrap:
        return A
    # candidate grid row lengths: near the large offsets, and √n
    cands = []
    for off in A.offsets:
        a = abs(off)
        if a > 1:
            cands += [a - 1, a, a + 1]
    r = int(round(np.sqrt(n)))
    cands += [r]
    seen = set()
    for C in cands:
        if C in seen:
            continue
        seen.add(C)
        strips = _strip_cover(resid, n, C)
        if strips is not None:
            top, bot, left, right = strips
            return Stencil(
                dia=A,
                const=jnp.asarray(const),
                top_vals=jnp.asarray(top),
                bot_vals=jnp.asarray(bot),
                left_vals=jnp.asarray(left),
                right_vals=jnp.asarray(right),
                offsets=A.offsets,
                shape=A.shape,
                wrap=A.wrap,
                grid_c=int(C),
            )
    return A


def _window(x: jnp.ndarray, start: int, length: int) -> jnp.ndarray:
    """x[start : start+length] with zero fill outside [0, n) (static start)."""
    n = x.shape[0]
    lo = max(start, 0)
    hi = min(start + length, n)
    if hi <= lo:
        return jnp.zeros((length,), x.dtype)
    seg = lax.slice(x, (lo,), (hi,))
    return jnp.pad(seg, (lo - start, start + length - hi))


def _shift_small(v: jnp.ndarray, q: int) -> jnp.ndarray:
    """v shifted by q with zero fill: out[r] = v[r+q] (static q, small |q|)."""
    return _window(v, q, v.shape[0])


def _apply_strips(S: Stencil, x: jnp.ndarray, y: jnp.ndarray) -> jnp.ndarray:
    """Add the boundary-strip corrections to the constant-part product.

    All reads are static slices of ``x`` (or single columns of its (R, C)
    view) and the writes are padded-strip adds that XLA fuses into the
    surrounding elementwise graph.  No gather, no scatter."""
    n = S.shape[0]
    C = S.grid_c
    R = n // C
    dt = y.dtype
    offs = S.offsets

    top = bot = None
    for d, off in enumerate(offs):
        tt = S.top_vals[d].astype(dt) * _window(x, off, C)
        bb = S.bot_vals[d].astype(dt) * _window(x, n - C + off, C)
        top = tt if top is None else top + tt
        bot = bb if bot is None else bot + bb

    X = x.reshape(R, C)
    # The strided column reads of X are the strips' cost floor (one strided
    # read per distinct column).  The needed columns cluster into contiguous
    # runs near 0 and C-1 ({0,1} and {C-2,C-1} for a 9-point stencil), so
    # slice each run ONCE and index columns out of the slab: 2 strided reads
    # instead of 4-6.
    rems = sorted({divmod(base + off, C)[1] for off in offs for base in (0, C - 1)})
    cols = {}
    run_start = prev = rems[0]
    for rem in rems[1:] + [None]:
        if rem is not None and rem == prev + 1:
            prev = rem
            continue
        slab = lax.slice(X, (0, run_start), (R, prev + 1))
        for j in range(run_start, prev + 1):
            cols[j] = slab[:, j - run_start]
        if rem is not None:
            run_start = prev = rem
    lcorr = rcorr = None
    for d, off in enumerate(offs):
        # rows r·C + base read x[r·C + base + off] = X[r + q, rem]
        for base, vals, acc in ((0, S.left_vals, "l"), (C - 1, S.right_vals, "r")):
            q, rem = divmod(base + off, C)
            term = vals[d].astype(dt) * _shift_small(cols[rem], q)
            if acc == "l":
                lcorr = term if lcorr is None else lcorr + term
            else:
                rcorr = term if rcorr is None else rcorr + term

    corr = (
        jnp.pad(top[None, :], ((0, R - 1), (0, 0)))
        + jnp.pad(bot[None, :], ((R - 1, 0), (0, 0)))
        + jnp.pad(lcorr[:, None], ((0, 0), (0, C - 1)))
        + jnp.pad(rcorr[:, None], ((0, 0), (C - 1, 0)))
    )
    return (y.reshape(R, C) + corr).reshape(n)


def stencil_spmv(S: Stencil, x: jnp.ndarray) -> jnp.ndarray:
    y = jnp.zeros(S.shape[0], jnp.result_type(S.const, x))
    for d, off in enumerate(S.offsets):
        y = y + S.const[d] * _shift(x, off, S.wrap)
    if S.grid_c:
        y = _apply_strips(S, x, y)
    return y


def stencil_spmm(S: Stencil, X: jnp.ndarray) -> jnp.ndarray:
    """SpMM falls back to the exact explicit operator: the matrix-free win
    is per-SpMV memory traffic, and SpMM consumers (constraint catch-up,
    oracles) read the matrix data anyway."""
    from .sparse import dia_spmm

    return dia_spmm(S.dia, X)
