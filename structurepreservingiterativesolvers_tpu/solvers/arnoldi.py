"""Fixed-shape Arnoldi building blocks shared by GMRES/CGMRES.

The reference's Arnoldi loop (reference ``solvers.py:92-106``) grows numpy
arrays dynamically; here everything is allocated at the max iteration count
``k`` and updated in place with masked dynamic indexing so the whole solver
jit-compiles once and runs as a single XLA program (``lax.while_loop`` over
iterations, ``lax.fori_loop`` for the modified-Gram-Schmidt recurrence).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import jax
import jax.numpy as jnp
from jax import lax


class ArnoldiState(NamedTuple):
    """Workspace for a k-step flexible Arnoldi factorisation.

    Q : (k+1, n) orthonormal Krylov basis (rows).
    Z : (k,   n) preconditioned vectors; flexible GMRES reconstructs the
        iterate from Z, not Q (reference solvers.py:111-115).
    H : (k+1, k) Hessenberg matrix.
    R, cs, sn, g : incremental Givens QR of H — R upper triangular, (cs, sn)
        the rotation pairs, g the rotated β·e1.  |g[j+1]| is the least-squares
        residual estimate, available without an extra SpMV (the reference
        instead recomputes ‖Ax−b‖ per iteration via np.linalg.lstsq,
        solvers.py:113-116; we keep the true-residual check as an option).
    """

    Q: jnp.ndarray
    Z: jnp.ndarray
    H: jnp.ndarray
    R: jnp.ndarray
    Rinv: jnp.ndarray
    cs: jnp.ndarray
    sn: jnp.ndarray
    g: jnp.ndarray


def init_state(r0: jnp.ndarray, beta: jnp.ndarray, k: int) -> ArnoldiState:
    n = r0.shape[0]
    dt = r0.dtype
    Q = jnp.zeros((k + 1, n), dt).at[0].set(r0 / jnp.where(beta == 0, 1.0, beta))
    return ArnoldiState(
        Q=Q,
        Z=jnp.zeros((k, n), dt),
        H=jnp.zeros((k + 1, k), dt),
        R=jnp.zeros((k, k), dt),
        Rinv=jnp.zeros((k, k), dt),
        cs=jnp.zeros(k, dt),
        sn=jnp.zeros(k, dt),
        g=jnp.zeros(k + 1, dt).at[0].set(beta),
    )


def _mgs(Q: jnp.ndarray, w: jnp.ndarray, j: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Modified Gram-Schmidt of w against rows Q[0..j]; returns (w⊥, h column).

    Sequential (j dependent dot/axpy pairs, latency-bound on an
    accelerator) — kept for strict reference parity (reference
    solvers.py:97-99); the default is CGS2 below."""
    k1 = Q.shape[0]
    h = jnp.zeros(k1, w.dtype)

    def body(i, carry):
        w, h = carry
        qi = Q[i]
        hij = jnp.dot(qi, w)
        return w - hij * qi, h.at[i].set(hij)

    return lax.fori_loop(0, j + 1, body, (w, h))


def _cgs2(Q: jnp.ndarray, w: jnp.ndarray, j: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Classical Gram-Schmidt with reorthogonalisation (CGS2).

    Rows of Q beyond the active prefix are zero, so the two batched
    (k+1,n)-matvec passes orthogonalise exactly against Q[0..j] with no
    masking — four bandwidth-bound sweeps over Q instead of j sequential
    dot/axpy pairs.  CGS2's orthogonality loss is O(eps), matching MGS for
    these basis sizes (the data-parallel substitute called out in SURVEY §7).
    Under GSPMD row sharding the products become local partial sums plus one
    all-reduce each."""
    h1 = Q @ w
    w1 = w - h1 @ Q
    h2 = Q @ w1
    w2 = w1 - h2 @ Q
    return w2, h1 + h2


def arnoldi_step(
    A,
    prefunc: Callable[[jnp.ndarray], jnp.ndarray],
    st: ArnoldiState,
    j: jnp.ndarray,
    ortho: str = "cgs2",
) -> Tuple[ArnoldiState, jnp.ndarray]:
    """One flexible-Arnoldi iteration; returns updated state and h[j+1,j].

    h[j+1,j] == 0 signals breakdown (reference solvers.py:101-106).
    """
    z = prefunc(st.Q[j])
    w = A @ z
    # ortho: 'cgs2' (default) or 'mgs' (reference parity)
    if ortho == "cgs2":
        w, hcol = _cgs2(st.Q, w, j)
    else:
        w, hcol = _mgs(st.Q, w, j)
    hlast = jnp.linalg.norm(w)
    hcol = hcol.at[j + 1].set(hlast)

    qnext = jnp.where(hlast > 0, w / jnp.where(hlast == 0, 1.0, hlast), 0.0)
    st = st._replace(
        Q=st.Q.at[j + 1].set(qnext),
        Z=st.Z.at[j].set(z),
        H=st.H.at[:, j].set(hcol),
    )
    st = _givens_update(st, hcol, j)
    return st, hlast


def _givens_update(st: ArnoldiState, hcol: jnp.ndarray, j: jnp.ndarray) -> ArnoldiState:
    """Fold column j of H into the running QR factorisation."""

    def rot(i, h):
        hi, hi1 = h[i], h[i + 1]
        h = h.at[i].set(st.cs[i] * hi + st.sn[i] * hi1)
        return h.at[i + 1].set(-st.sn[i] * hi + st.cs[i] * hi1)

    h = lax.fori_loop(0, j, rot, hcol)
    a, b = h[j], h[j + 1]
    denom = jnp.sqrt(a * a + b * b)
    safe = jnp.where(denom == 0, 1.0, denom)
    c, s = jnp.where(denom == 0, 1.0, a / safe), jnp.where(denom == 0, 0.0, b / safe)
    h = h.at[j].set(denom)

    g = st.g
    gj = g[j]
    g = g.at[j].set(c * gj).at[j + 1].set(-s * gj)
    k = st.R.shape[0]
    # incremental explicit inverse of the triangular factor: appending
    # column j to R extends R⁻¹ by one column at the cost of one masked
    # multiply+reduce — so coefficient solves (lsq_coeffs) are a single
    # matvec instead of a k-step sequential back-substitution per iteration
    # (a sequential loop of tiny dependent ops is latency-bound on device).
    idx = jnp.arange(k)
    tiny = jnp.finfo(st.R.dtype).tiny
    rjj = jnp.where(denom == 0, tiny, denom)
    upper = jnp.where(idx < j, h[:k], 0.0)
    newcol = -jnp.sum(st.Rinv * upper[None, :], axis=1) / rjj
    newcol = jnp.where(idx == j, 1.0 / rjj, newcol)
    return st._replace(
        R=st.R.at[:, j].set(h[:k]),
        Rinv=st.Rinv.at[:, j].set(newcol),
        cs=st.cs.at[j].set(c),
        sn=st.sn.at[j].set(s),
        g=g,
    )


def lsq_coeffs(st: ArnoldiState, j: jnp.ndarray) -> jnp.ndarray:
    """Least-squares coefficients y (k,) with y[j+1:] = 0.

    Solves min ‖β e1 − H[:, :j+1] y‖ through the Givens QR as one masked
    matvec with the incrementally-maintained R⁻¹ (see ``_givens_update``).
    The leading principal blocks of a triangular inverse are the inverses of
    the leading blocks, and R⁻¹ is upper triangular, so masking the rotated
    rhs to the active prefix yields exactly the prefix solution with zeros
    beyond it.  Replaces the reference's np.linalg.lstsq (solvers.py:113).
    """
    k = st.R.shape[0]
    rhs = jnp.where(jnp.arange(k) <= j, st.g[:k], 0.0)
    return jnp.sum(st.Rinv * rhs[None, :], axis=1)


def lsq_residual_estimate(st: ArnoldiState, j: jnp.ndarray) -> jnp.ndarray:
    """|g[j+1]| — the exact LSQ residual of the projected problem."""
    return jnp.abs(st.g[j + 1])
