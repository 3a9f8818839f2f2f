"""Device sparse matrix formats.

The reference keeps everything in scipy CSR and leans on scipy's C SpMV
(reference ``solvers.py:95,191,370``).  CSR row-pointer indirection becomes
gathers and segment sums under XLA, so this module provides formats whose
SpMV is regular, fusible array work instead:

* ``DIA`` — diagonal storage, optionally periodic (wrapping).  FEM stencil
  matrices on structured meshes (all four reference problems) have a small,
  fixed set of nonzero diagonals; SpMV becomes a handful of elementwise
  multiply-adds over shifted copies of ``x``: no gather, one fused
  bandwidth-bound pass.  This is the fast path.
* ``ELL`` — fixed-width padded rows (cols + vals).  General fallback for any
  sparsity pattern; SpMV is a gather + row reduction, which XLA vectorises.
* ``BSR`` — dense blocks at block-sparse positions, for batched dense SpMM.

All formats are registered pytrees with static structure (shape, offsets,
row width), so they can be closed over or passed through ``jit`` / ``scan`` /
``shard_map`` without retracing on value changes.

Host-side assembly and fixture IO use scipy CSR (scipy is a host-only
convenience here, mirroring the reference's dependency); ``from_scipy``
converts to a device format, auto-selecting DIA when the matrix is
diagonally-structured.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np


def _register(cls):
    """Register a dataclass as a pytree; fields named in ``_static`` are aux."""
    static = tuple(cls._static)
    dyn = tuple(f.name for f in dataclasses.fields(cls) if f.name not in static)

    def flatten(obj):
        return [getattr(obj, n) for n in dyn], tuple(getattr(obj, n) for n in static)

    def unflatten(aux, children):
        kwargs = dict(zip(dyn, children))
        kwargs.update(dict(zip(static, aux)))
        return cls(**kwargs)

    jax.tree_util.register_pytree_node(cls, flatten, unflatten)
    return cls


@_register
@dataclasses.dataclass(frozen=True)
class DIA:
    """Diagonal sparse matrix.

    ``data[d, i]`` holds ``A[i, i + offsets[d]]`` (row-aligned).  When
    ``wrap`` is true the column index is taken mod n (periodic meshes);
    otherwise out-of-range positions are structural zeros.
    """

    data: jnp.ndarray  # (ndiag, n)
    offsets: Tuple[int, ...]  # static
    shape: Tuple[int, int]  # static
    wrap: bool  # static

    _static = ("offsets", "shape", "wrap")

    @property
    def nnz(self) -> int:
        return int(np.count_nonzero(np.asarray(self.data)))

    @property
    def dtype(self):
        return self.data.dtype

    def __matmul__(self, other):
        if other.ndim == 1:
            return dia_spmv(self, other)
        return dia_spmm(self, other)

    def astype(self, dtype):
        return dataclasses.replace(self, data=self.data.astype(dtype))

    def todense(self) -> jnp.ndarray:
        n, m = self.shape
        out = jnp.zeros(self.shape, self.data.dtype)
        rows = jnp.arange(n)
        for d, off in enumerate(self.offsets):
            cols = rows + off
            if self.wrap:
                cols = cols % m
                out = out.at[rows, cols].add(self.data[d])
            else:
                valid = (cols >= 0) & (cols < m)
                out = out.at[rows, jnp.clip(cols, 0, m - 1)].add(
                    jnp.where(valid, self.data[d], 0.0)
                )
        return out


@_register
@dataclasses.dataclass(frozen=True)
class ELL:
    """Padded-row (ELLPACK) sparse matrix, stored TRANSPOSED: ``cols[s, i]``
    / ``vals[s, i]`` hold slot ``s`` of row ``i``.

    Each row has exactly ``row_width`` (cols, vals) slots; padding entries
    point at column 0 with value 0, so no masking is needed in the kernel.
    The (r, n) layout puts the large row dimension minor-most, so each slot
    is one contiguous length-n vector and a narrow r (the AMG prolongators
    have r=4) never becomes a padded minor dimension.
    """

    cols: jnp.ndarray  # (r, n) int32
    vals: jnp.ndarray  # (r, n)
    shape: Tuple[int, int]  # static

    _static = ("shape",)

    @property
    def row_width(self) -> int:
        return self.cols.shape[0]

    @property
    def nnz(self) -> int:
        return int(np.count_nonzero(np.asarray(self.vals)))

    @property
    def dtype(self):
        return self.vals.dtype

    def __matmul__(self, other):
        if other.ndim == 1:
            return ell_spmv(self, other)
        return ell_spmm(self, other)

    def astype(self, dtype):
        return dataclasses.replace(self, vals=self.vals.astype(dtype))

    def todense(self) -> jnp.ndarray:
        n, m = self.shape
        out = jnp.zeros((n, m), self.vals.dtype)
        rows = jnp.broadcast_to(jnp.arange(n)[None, :], self.cols.shape)
        return out.at[rows, self.cols].add(self.vals)


@_register
@dataclasses.dataclass(frozen=True)
class BSR:
    """Block-sparse-row matrix with dense (bs × bs) blocks.

    ``blocks[p]`` is the dense block at block-row ``block_rows[p]``, block-col
    ``block_cols[p]``.  Block positions are static (baked into the jitted
    program) because FEM sparsity is fixed for a given mesh; only values are
    traced.  SpMM against a tall-dense right-hand side runs each block as a
    small dense matrix product.
    """

    blocks: jnp.ndarray  # (p, bs, bs)
    block_rows: Tuple[int, ...]  # static
    block_cols: Tuple[int, ...]  # static
    shape: Tuple[int, int]  # static

    _static = ("block_rows", "block_cols", "shape")

    @property
    def block_size(self) -> int:
        return self.blocks.shape[1]

    @property
    def nnz(self) -> int:
        return int(np.count_nonzero(np.asarray(self.blocks)))

    @property
    def dtype(self):
        return self.blocks.dtype

    def __matmul__(self, other):
        if other.ndim == 1:
            return bsr_spmv(self, other)
        return bsr_spmm(self, other)

    def astype(self, dtype):
        return dataclasses.replace(self, blocks=self.blocks.astype(dtype))

    def todense(self) -> jnp.ndarray:
        bs = self.block_size
        out = jnp.zeros(self.shape, self.blocks.dtype)
        for p, (br, bc) in enumerate(zip(self.block_rows, self.block_cols)):
            out = out.at[br * bs : (br + 1) * bs, bc * bs : (bc + 1) * bs].add(
                self.blocks[p]
            )
        return out


# ---------------------------------------------------------------------------
# SpMV / SpMM
# ---------------------------------------------------------------------------


def _shift(x: jnp.ndarray, off: int, wrap: bool) -> jnp.ndarray:
    """Row-aligned read of x at offset: out[i] = x[i+off] (0 when out of range)."""
    if off == 0:
        return x
    rolled = jnp.roll(x, -off, axis=0)
    if wrap:
        return rolled
    n = x.shape[0]
    idx = jnp.arange(n) + off
    valid = (idx >= 0) & (idx < n)
    if x.ndim > 1:
        valid = valid[:, None]
    return jnp.where(valid, rolled, 0)


def dia_spmv(A: DIA, x: jnp.ndarray) -> jnp.ndarray:
    """DIA SpMV as a chain of shifted multiply-adds, which XLA fuses into one
    elementwise pass over ``x`` and the diagonals (nnz + 2n element reads)."""
    y = jnp.zeros(A.shape[0], jnp.result_type(A.data, x))
    for d, off in enumerate(A.offsets):
        y = y + A.data[d] * _shift(x, off, A.wrap)
    return y


def dia_spmm(A: DIA, X: jnp.ndarray) -> jnp.ndarray:
    Y = jnp.zeros((A.shape[0], X.shape[1]), jnp.result_type(A.data, X))
    for d, off in enumerate(A.offsets):
        Y = Y + A.data[d][:, None] * _shift(X, off, A.wrap)
    return Y


def ell_spmv(A: ELL, x: jnp.ndarray) -> jnp.ndarray:
    # gather: (r, n) then weighted slot-sum
    gathered = x[A.cols]
    return jnp.sum(A.vals * gathered, axis=0)


def ell_spmm(A: ELL, X: jnp.ndarray) -> jnp.ndarray:
    # Scan over row-width to avoid materialising an (r, n, m) intermediate.
    def body(acc, rv):
        cols_r, vals_r = rv
        return acc + vals_r[:, None] * X[cols_r], None

    init = jnp.zeros((A.shape[0], X.shape[1]), jnp.result_type(A.vals, X))
    acc, _ = jax.lax.scan(body, init, (A.cols, A.vals))
    return acc


def bsr_spmv(A: BSR, x: jnp.ndarray) -> jnp.ndarray:
    return bsr_spmm(A, x[:, None])[:, 0]


def bsr_spmm(A: BSR, X: jnp.ndarray) -> jnp.ndarray:
    bs = A.block_size
    nbr = A.shape[0] // bs
    Xb = X.reshape(A.shape[1] // bs, bs, -1)
    # Group contributions per block-row with a segment-sum over products.
    prods = jnp.einsum(
        "pij,pjk->pik", A.blocks, Xb[jnp.asarray(A.block_cols)],
        preferred_element_type=jnp.result_type(A.blocks, X),
    )
    seg = jax.ops.segment_sum(
        prods, jnp.asarray(A.block_rows), num_segments=nbr
    )
    return seg.reshape(A.shape[0], -1)


def spmv(A, x):
    """Format-dispatching SpMV; also accepts dense 2-D arrays."""
    if isinstance(A, (DIA, ELL, BSR)):
        return A @ x
    return A @ x  # dense jnp array


def spmm(A, X):
    if isinstance(A, DIA):
        return dia_spmm(A, X)
    if isinstance(A, ELL):
        return ell_spmm(A, X)
    if isinstance(A, BSR):
        return bsr_spmm(A, X)
    return A @ X


# ---------------------------------------------------------------------------
# Construction / conversion (host side, numpy / scipy)
# ---------------------------------------------------------------------------


def ell_from_scipy(A, dtype=None) -> ELL:
    import scipy.sparse as sp

    A = sp.csr_matrix(A)
    A.sum_duplicates()
    n, m = A.shape
    widths = np.diff(A.indptr)
    r = max(int(widths.max()), 1)
    cols = np.zeros((r, n), np.int32)
    vals = np.zeros((r, n), A.dtype)
    # vectorised slot assignment: entry t of the CSR stream lands in slot
    # (t − indptr[row]) of its row
    rows_per_nz = np.repeat(np.arange(n), widths)
    slots = np.arange(A.nnz) - A.indptr[rows_per_nz]
    cols[slots, rows_per_nz] = A.indices
    vals[slots, rows_per_nz] = A.data
    dtype = dtype or vals.dtype
    return ELL(jnp.asarray(cols), jnp.asarray(vals, dtype), (n, m))


def dia_from_scipy(A, wrap: Optional[bool] = None, dtype=None) -> DIA:
    """Convert, auto-detecting periodic (wrapping) diagonal structure.

    For periodic meshes, entries at (i, j) with j-i ≡ off (mod n) for small
    signed |off| are stored on wrapped diagonals; this keeps e.g. a periodic
    1-D stencil to a handful of diagonals instead of O(n) corner diagonals.
    """
    import scipy.sparse as sp

    A = sp.coo_matrix(A)
    A.sum_duplicates()
    n, m = A.shape
    if n != m:
        raise ValueError("DIA requires a square matrix")
    raw = A.col.astype(np.int64) - A.row.astype(np.int64)
    wrapped = ((raw + n // 2) % n) - n // 2
    if wrap is None:
        wrap = len(np.unique(wrapped)) < len(np.unique(raw))
    offs = wrapped if wrap else raw
    uniq = np.unique(offs)
    data = np.zeros((len(uniq), n), A.dtype)
    # vectorised scatter (a Python per-entry loop costs ~10 s at the heat
    # M=2048 operator's 29M nnz and sat on the AMG-setup critical path)
    np.add.at(data, (np.searchsorted(uniq, offs), A.row), A.data)
    dtype = dtype or data.dtype
    return DIA(
        jnp.asarray(data, dtype), tuple(int(o) for o in uniq), (n, m), bool(wrap)
    )


def bsr_from_scipy(A, block_size: int, dtype=None) -> BSR:
    import scipy.sparse as sp

    A = sp.csr_matrix(A)
    n, m = A.shape
    bs = block_size
    if n % bs or m % bs:
        raise ValueError(f"shape {A.shape} not divisible by block size {bs}")
    Ab = sp.bsr_matrix(A, blocksize=(bs, bs))
    Ab.sort_indices()
    rows = np.repeat(np.arange(n // bs), np.diff(Ab.indptr))
    blocks = np.asarray(Ab.data)
    dtype = dtype or blocks.dtype
    return BSR(
        jnp.asarray(blocks, dtype),
        tuple(int(r) for r in rows),
        tuple(int(c) for c in Ab.indices),
        (n, m),
    )


def from_scipy(A, dtype=None, max_diags: int = 64, min_fill: float = 0.2):
    """Pick a device format automatically: DIA when the matrix concentrates
    on few (possibly periodic) diagonals that are reasonably full, else ELL."""
    import scipy.sparse as sp

    Ac = sp.coo_matrix(A)
    n, m = Ac.shape
    if n == m and Ac.nnz:
        raw = Ac.col.astype(np.int64) - Ac.row.astype(np.int64)
        wrapped = ((raw + n // 2) % n) - n // 2
        ndiag = min(len(np.unique(raw)), len(np.unique(wrapped)))
        fill = Ac.nnz / (ndiag * n)
        if ndiag <= min(max_diags, max(n // 4, 1)) and fill >= min_fill:
            return dia_from_scipy(A, dtype=dtype)
    return ell_from_scipy(A, dtype=dtype)


def to_scipy(A):
    import scipy.sparse as sp

    return sp.csr_matrix(np.asarray(A.todense()))
