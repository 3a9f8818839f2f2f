"""Point- and block-Jacobi preconditioners.

Data-parallel stand-ins for the reference's SuperLU ILU factors
(reference lkdvRK/Evolve.py:51-52, swe/TimedSolve.py:23-24): triangular
solves are inherently sequential, so the iteration-quality role is filled by
block-Jacobi with dense per-block inverses — the block solve is one batched
matmul — and by the polynomial preconditioners in ``chebyshev.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.sparse import DIA, ELL, _register


def diagonal(A) -> jnp.ndarray:
    """Extract the main diagonal of a device sparse matrix."""
    from ..ops.stencil import as_dia

    A = as_dia(A)  # Stencil → its explicit-matrix DIA view
    if isinstance(A, DIA):
        if 0 in A.offsets:
            return A.data[A.offsets.index(0)]
        return jnp.zeros(A.shape[0], A.dtype)
    if isinstance(A, ELL):
        n = A.shape[0]
        rows = jnp.arange(n)[None, :]  # (r, n) transposed layout
        hit = (A.cols == rows) & (A.vals != 0)
        return jnp.sum(jnp.where(hit, A.vals, 0.0), axis=0)
    return jnp.diagonal(A)


@_register
@dataclasses.dataclass(frozen=True)
class Jacobi:
    """Diagonal-inverse preconditioner."""

    dinv: jnp.ndarray

    _static = ()

    def __call__(self, v):
        return self.dinv * v

    def solve(self, v):
        return self.dinv * v


def jacobi(A) -> Jacobi:
    d = diagonal(A)
    return Jacobi(dinv=jnp.where(d == 0, 1.0, 1.0 / jnp.where(d == 0, 1.0, d)))


@_register
@dataclasses.dataclass(frozen=True)
class BlockJacobi:
    """Dense-inverse block-Jacobi: y[idx_p] = inv_p @ v[idx_p].

    Every dof belongs to exactly one block; blocks are uniform size, so the
    apply is one gather + one batched matmul + one scatter.
    """

    idx: jnp.ndarray  # (nb, bs) int32
    inv: jnp.ndarray  # (nb, bs, bs)

    _static = ()

    def __call__(self, v):
        gathered = v[self.idx]  # (nb, bs)
        solved = jnp.einsum(
            "pij,pj->pi", self.inv, gathered,
            preferred_element_type=gathered.dtype,
        )
        return jnp.zeros_like(v).at[self.idx.reshape(-1)].set(solved.reshape(-1))

    def solve(self, v):
        return self(v)


def block_jacobi(A_csr, blocks: Sequence[np.ndarray], dtype=None) -> BlockJacobi:
    """Build from a host CSR and a list of equal-size index blocks."""
    import scipy.sparse as sp

    A_csr = sp.csr_matrix(A_csr)
    blocks = [np.asarray(b) for b in blocks]
    bs = len(blocks[0])
    if any(len(b) != bs for b in blocks):
        raise ValueError("blocks must have uniform size")
    inv = np.stack(
        [np.linalg.inv(A_csr[b][:, b].toarray()) for b in blocks]
    )
    dtype = dtype or inv.dtype
    return BlockJacobi(
        idx=jnp.asarray(np.stack(blocks), jnp.int32),
        inv=jnp.asarray(inv, dtype),
    )


def contiguous_blocks(n: int, bs: int) -> list:
    """Partition [0, n) into contiguous blocks of size bs."""
    if n % bs:
        raise ValueError(f"n={n} not divisible by block size {bs}")
    return list(np.arange(n).reshape(n // bs, bs))


@_register
@dataclasses.dataclass(frozen=True)
class RAS:
    """Restricted additive Schwarz: overlapping dense block solves, but each
    dof takes its value only from the block that owns it (interior mask) —
    the standard overlap upgrade of block-Jacobi, still one gather + one
    batched matmul + one scatter."""

    idx: jnp.ndarray  # (nb, bs) int32 — overlapping blocks
    inv: jnp.ndarray  # (nb, bs, bs)
    own: jnp.ndarray  # (nb, bs) bool — interior (owned) positions

    _static = ()

    def __call__(self, v):
        gathered = v[self.idx]
        solved = jnp.einsum(
            "pij,pj->pi", self.inv, gathered,
            preferred_element_type=gathered.dtype,
        )
        flat_idx = jnp.where(self.own, self.idx, v.shape[0])  # park non-owned
        out = jnp.zeros(v.shape[0] + 1, v.dtype).at[flat_idx.reshape(-1)].set(
            jnp.where(self.own, solved, 0.0).reshape(-1)
        )
        return out[:-1]

    def solve(self, v):
        return self(v)


def ras(A_csr, blocks: Sequence[np.ndarray], owned: Sequence[np.ndarray],
        dtype=None) -> RAS:
    """Build restricted additive Schwarz from overlapping index blocks and
    per-block ownership masks (same lengths as ``blocks``)."""
    import scipy.sparse as sp

    A_csr = sp.csr_matrix(A_csr)
    blocks = [np.asarray(b) for b in blocks]
    bs = len(blocks[0])
    if any(len(b) != bs for b in blocks):
        raise ValueError("blocks must have uniform size")
    inv = np.stack([np.linalg.inv(A_csr[b][:, b].toarray()) for b in blocks])
    dtype = dtype or inv.dtype
    return RAS(
        idx=jnp.asarray(np.stack(blocks), jnp.int32),
        inv=jnp.asarray(inv, dtype),
        own=jnp.asarray(np.stack([o.astype(bool) for o in owned])),
    )
