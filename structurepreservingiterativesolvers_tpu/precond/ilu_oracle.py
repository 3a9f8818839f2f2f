"""Host-factored ILU *oracle* preconditioner (validation only).

The reference preconditions lkdvRK and swe with SuperLU's incomplete LU
(``scipy.sparse.linalg.spilu(A, drop_tol=1e-4, fill_factor=10)`` —
reference lkdvRK/Evolve.py:51-52, swe/TimedSolve.py:23-24).  Sparse
triangular solves are inherently sequential, so the production path uses block-Jacobi / RAS / polynomial preconditioners
(``jacobi.py``, ``chebyshev.py``) instead.

This module exists to *prove* that substitution is quality-equivalent: it
materialises the ILU factors' inverse action as a dense operator
(M⁻¹ = U⁻¹ L⁻¹ applied to the identity) so the exact reference
preconditioner can run inside a jitted device solve at test sizes, and the
preconditioned iteration counts of the stand-ins can be compared against it
(see ``tests/test_ilu_parity.py`` and ``docs/ILU_PARITY.md``).

Dense n×n storage means this is strictly a small-n validation oracle, not a
production preconditioner.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np

from ..ops.sparse import _register


@_register
@dataclasses.dataclass(frozen=True)
class DenseApply:
    """Dense preconditioner apply: v ↦ Minv @ v (one dense matvec)."""

    Minv: jnp.ndarray

    _static = ()

    def __call__(self, v):
        return self.Minv @ v

    def solve(self, v):
        return self(v)


def ilu_oracle(A_csr, drop_tol: float = 1e-4, fill_factor: float = 10.0,
               dtype=None) -> DenseApply:
    """spilu with the reference's exact parameters, densified for device use."""
    import scipy.sparse.linalg as spla

    A_csr = A_csr.tocsc()
    n = A_csr.shape[0]
    ilu = spla.spilu(A_csr, drop_tol=drop_tol, fill_factor=fill_factor)
    Minv = ilu.solve(np.eye(n))
    return DenseApply(Minv=jnp.asarray(Minv, dtype or Minv.dtype))


def direct_oracle(A_csr, dtype=None) -> DenseApply:
    """Exact-inverse preconditioner (the quality ceiling: 1-2 iterations)."""
    import scipy.sparse.linalg as spla

    n = A_csr.shape[0]
    Minv = spla.spsolve(A_csr.tocsc(), np.eye(n))
    return DenseApply(Minv=jnp.asarray(np.asarray(Minv), dtype or np.float64))
