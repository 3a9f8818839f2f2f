"""Quadratic invariant constraints and their reduction onto Krylov coefficients.

A structure constraint is ``g(x) = ½ xᵀ M x + vᵀ x + c = 0`` (mass is the
linear special case M = 0).  The reference compiles such a constraint onto the
Krylov coefficient space by forming ``MZ = M @ Z`` from scratch at every
constrained iteration (reference ``solvers.py:21-53``), an O(nnz·j) rebuild.

Here the reduction is *incremental*: each Arnoldi step appends one
preconditioned vector ``z_j``, so the reduced data gains

* ``t1[j]  = v·z_j + (M z_j)·x0``            — one SpMV + two dots
* ``T2[:,j] = T2[j,:] = ½ Z (M z_j)``        — one tall-dense matvec

after which the reduced constraint is the tiny dense form
``g(y) = t0 + t1·y + yᵀ T2 y`` with Jacobian ``t1 + 2 T2 y`` (M symmetric,
as all reference invariant matrices are).  When the solver enters the
constrained endgame mid-flight it catches up with a single batched SpMM
over the existing basis instead of j separate rebuilds.

``M`` may be a sparse/dense matrix, a linear combination of matrices
(``MatComb``, e.g. energy's ``L − M``, reference lkdv/LinearSolver.py:40-44),
or a stage-mapped operator (``StageKron``) expressing the Runge–Kutta
constraint chain ``z1 = z0 + dt Σ b_s X_s`` (reference lkdvRK/lkdvRK.py:162-189,
lkdvRK/LinearSolver.py:29-76) as a pure quadratic in the stage vector — which
turns the reference's slow dict-form path into the fast path.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from ..ops.sparse import _register


@_register
@dataclasses.dataclass(frozen=True)
class MatComb:
    """Linear combination  Σ coeff_i · A_i  as a matrix-free operator."""

    coeffs: Tuple[float, ...]  # static
    mats: Tuple[Any, ...]  # pytree children (sparse/dense matrices)

    _static = ("coeffs",)

    def __matmul__(self, x):
        out = self.coeffs[0] * (self.mats[0] @ x)
        for c, A in zip(self.coeffs[1:], self.mats[1:]):
            out = out + c * (A @ x)
        return out

    def todense(self):
        out = self.coeffs[0] * jnp.asarray(self.mats[0].todense())
        for c, A in zip(self.coeffs[1:], self.mats[1:]):
            out = out + c * jnp.asarray(A.todense())
        return out


@_register
@dataclasses.dataclass(frozen=True)
class StageKron:
    """Pᵀ M P where P maps a stacked stage vector X (ns·n0,) to
    ``dt Σ_s b_s X_s`` (n0,) — the linear part of the RK reconstruction
    z1 = z0 + dt Σ b_s X_s (reference lkdvRK/lkdvRK.py:162-174).

    Applying PᵀMP needs one inner-space SpMV regardless of stage count.
    """

    inner: Any  # operator on the n0 space
    b: jnp.ndarray  # (ns,) RK weights
    dt: float  # static
    ns: int  # static

    _static = ("dt", "ns")

    def _P(self, X):
        Xs = X.reshape(self.ns, -1)
        return self.dt * jnp.tensordot(self.b, Xs, axes=1)

    def _Pt(self, w):
        return (self.dt * jnp.outer(self.b, w)).reshape(-1)

    def __matmul__(self, X):
        if X.ndim == 1:
            return self._Pt(self.inner @ self._P(X))
        # (N, m) tall-dense right-hand side, applied columnwise
        Xs = X.reshape(self.ns, -1, X.shape[1])
        PX = self.dt * jnp.tensordot(self.b, Xs, axes=1)  # (n0, m)
        MPX = self.inner @ PX
        return (self.dt * self.b[:, None, None] * MPX[None]).reshape(-1, X.shape[1])

    def todense(self):
        # (PᵀMP)[(s,i),(t,j)] = dt² b_s b_t M[i,j] (stage-major stacking)
        Md = jnp.asarray(self.inner.todense())
        bb = jnp.outer(self.b, self.b) * (self.dt ** 2)
        return jnp.kron(bb.astype(Md.dtype), Md)


@_register
@dataclasses.dataclass(frozen=True)
class QuadraticConstraint:
    """g(x) = ½ xᵀ M x + vᵀ x + c.  ``M``/``v`` may be None (zero)."""

    M: Optional[Any]
    v: Optional[jnp.ndarray]
    c: jnp.ndarray
    name: str = "constraint"

    _static = ("name",)

    def __call__(self, x):
        out = jnp.asarray(self.c, x.dtype)
        if self.v is not None:
            out = out + jnp.dot(self.v, x)
        if self.M is not None:
            out = out + 0.5 * jnp.dot(x, self.M @ x)
        return out

    def grad(self, x):
        out = jnp.zeros_like(x)
        if self.v is not None:
            out = out + self.v
        if self.M is not None:
            out = out + self.M @ x  # symmetric M
        return out


def stage_mapped(
    inner: QuadraticConstraint,
    b: jnp.ndarray,
    dt: float,
    ns: int,
    z0: jnp.ndarray,
) -> QuadraticConstraint:
    """Compose a quadratic constraint on z1-space with the affine RK map
    ``z1 = z0 + P X`` to get an equivalent quadratic on stage space.

    This replaces the reference's general dict-form constraints
    (lkdvRK/LinearSolver.py:29-76) — which re-evaluate ``z1calc`` chains
    inside every SLSQP function call — with the compiled fast path.
    """
    Mz0 = inner.M @ z0 if inner.M is not None else jnp.zeros_like(z0)
    v_in = inner.v if inner.v is not None else jnp.zeros_like(z0)
    w = Mz0 + v_in
    Pt_w = (dt * jnp.outer(b, w)).reshape(-1)
    c_new = inner.c + jnp.dot(v_in, z0) + 0.5 * jnp.dot(z0, Mz0)
    M_new = StageKron(inner.M, jnp.asarray(b), float(dt), int(ns)) if inner.M is not None else None
    return QuadraticConstraint(M=M_new, v=Pt_w, c=c_new, name=inner.name)


class ReducedBuffers(NamedTuple):
    """Per-constraint reduced data over the Krylov coefficient space."""

    t0: jnp.ndarray  # scalar
    t1: jnp.ndarray  # (k,)
    T2: jnp.ndarray  # (k, k)


def init_buffers(
    con: QuadraticConstraint,
    x0: jnp.ndarray,
    k: int,
    cdtype=None,
    x0_zero: bool = False,
    dd_value: bool = False,
) -> ReducedBuffers:
    """``cdtype`` is the reduction dtype: with f32 storage the reduction and
    the KKT endgame run in f64 — the data is tiny and the constraint
    certificate needs the headroom (mixed-precision mode).

    ``x0_zero`` (static) skips the g(x0) evaluation entirely — t0 = c exactly
    — saving an n-sized SpMV per constraint per solve on the common x0=None
    path.  ``dd_value`` evaluates g(x0) in double-f32 instead of f64 (the
    dd path keeps the n-sized work in f32 elementwise ops)."""
    cdtype = cdtype or x0.dtype
    if x0_zero:
        t0 = jnp.asarray(con.c).astype(cdtype)
    elif dd_value and x0.dtype == jnp.float32 and dd_supported(con.M):
        # double-f32 evaluation is only valid when x0 is natively f32 —
        # with f64 storage the from_f32 split would truncate x0
        from ..ops import dd as _dd

        t0 = dd_constraint_value(con, _dd.from_f32(x0)).astype(cdtype)
    else:
        t0 = con(x0.astype(cdtype))
    return ReducedBuffers(
        t0=t0, t1=jnp.zeros(k, cdtype), T2=jnp.zeros((k, k), cdtype)
    )


def _dd_rows_dot(X: jnp.ndarray, y_dd):
    """(k,) dd: row-wise dots of exact-f32 matrix X (k, n) with dd vector y."""
    from ..ops import dd as _dd

    prod = _dd.mul_f32(_dd.DD(y_dd.hi[None, :], y_dd.lo[None, :]), X)
    return _dd.dd_sum(prod, axis=-1)


def _use_dd_reduction(con, Z, dd_reduce: bool) -> bool:
    return bool(dd_reduce) and Z.dtype == jnp.float32 and dd_supported(con.M)


def update_buffers(
    con: QuadraticConstraint,
    buf: ReducedBuffers,
    Z: jnp.ndarray,  # (k, n) Krylov Z-basis rows (row j freshly set)
    x0: jnp.ndarray,
    j: jnp.ndarray,
    x0_zero: bool = False,
    dd_reduce: bool = False,
    f32_reduce: bool = False,
) -> ReducedBuffers:
    """Fold the new basis vector Z[j] into the reduced constraint.

    ``dd_reduce`` (static): do the n-sized work in double-f32 instead of the
    buffer dtype.  With f32 storage the mixed-mode buffers are f64; the dd
    formulation keeps the n-sized work in f32 elementwise ops with ~2⁻⁴⁸
    relative error, well inside the certificate floor.

    ``f32_reduce`` (static): do the n-sized work in PLAIN f32 and only cast
    the tiny results to the buffer dtype — the snap-first mode.  With the
    projection epilogue certifying the RETURNED iterate in dd, the in-loop
    reduced model only steers the KKT; its f32 evaluation noise
    (~eps32·scale) sits below what the f32 assembly can represent anyway,
    so dd precision mid-loop buys nothing, and the plain f32 SpMM + matmul
    is several times cheaper than the dd catch-up.  The safety-latch floor
    must then use eps32 (solvers/cgmres.py)."""
    cdtype = buf.t1.dtype
    if f32_reduce:
        zj = Z[j]
        t1j = jnp.zeros((), Z.dtype)
        T2 = buf.T2
        if con.v is not None:
            t1j = t1j + jnp.dot(con.v.astype(Z.dtype), zj)
        if con.M is not None:
            u = (con.M @ zj).astype(Z.dtype)
            if not x0_zero:
                t1j = t1j + jnp.dot(u, x0.astype(Z.dtype))
            w = (0.5 * (Z @ u)).astype(cdtype)  # (k,) f32 matvec, tiny cast
            T2 = T2.at[j, :].set(w).at[:, j].set(w)
        return ReducedBuffers(
            t0=buf.t0, t1=buf.t1.at[j].set(t1j.astype(cdtype)), T2=T2)
    if _use_dd_reduction(con, Z, dd_reduce):
        from ..ops import dd as _dd

        zj = Z[j]
        t1j_dd = _dd.DD(jnp.float32(0.0), jnp.float32(0.0))
        T2 = buf.T2
        if con.v is not None:
            t1j_dd = _dd.dot_f32(_dd.from_f32(con.v), zj)
        if con.M is not None:
            u = _dd_matvec(con.M, _dd.from_f32(zj))
            if not x0_zero:
                t1j_dd = _dd.add(
                    t1j_dd, _dd.dot_f32(u, x0.astype(jnp.float32))
                )
            w = 0.5 * _dd.to_f64(_dd_rows_dot(Z, u)).astype(cdtype)
            T2 = T2.at[j, :].set(w).at[:, j].set(w)
        t1j = _dd.to_f64(t1j_dd).astype(cdtype)
        return ReducedBuffers(t0=buf.t0, t1=buf.t1.at[j].set(t1j), T2=T2)
    zj = Z[j].astype(cdtype)
    t1j = jnp.zeros((), cdtype)
    if con.v is not None:
        t1j = t1j + jnp.dot(con.v.astype(cdtype), zj)
    T2 = buf.T2
    if con.M is not None:
        u = (con.M @ zj).astype(cdtype)
        if not x0_zero:
            t1j = t1j + jnp.dot(u, x0.astype(cdtype))
        w = 0.5 * (Z.astype(cdtype) @ u)  # (k,) — inactive rows are zero
        T2 = T2.at[j, :].set(w).at[:, j].set(w)
    return ReducedBuffers(t0=buf.t0, t1=buf.t1.at[j].set(t1j), T2=T2)


def catchup_buffers(
    con: QuadraticConstraint,
    buf: ReducedBuffers,
    Z: jnp.ndarray,
    x0: jnp.ndarray,
    x0_zero: bool = False,
    dd_reduce: bool = False,
    f32_reduce: bool = False,
) -> ReducedBuffers:
    """Recompute the full reduction in one batched pass (phase-entry catch-up).

    Inactive rows of Z are zero, so the result is correct for any active
    prefix; cost is one SpMM + one (k,n)·(n,k) matmul — or, with
    ``dd_reduce`` (see ``update_buffers``), a vmapped double-f32 SpMM plus a
    ``lax.map`` of row-dot passes, avoiding all n-sized f64 work — or, with
    ``f32_reduce`` (the snap-first mode, see ``update_buffers``), the plain
    f32 SpMM + matmul with only the tiny results cast up.
    """
    cdtype = buf.t1.dtype
    if f32_reduce:
        t1 = jnp.zeros(Z.shape[0], Z.dtype)
        T2f = jnp.zeros((Z.shape[0], Z.shape[0]), Z.dtype)
        if con.v is not None:
            t1 = t1 + Z @ con.v.astype(Z.dtype)
        if con.M is not None:
            U = (con.M @ Z.T).astype(Z.dtype)  # (n, k) f32 SpMM
            if not x0_zero:
                t1 = t1 + U.T @ x0.astype(Z.dtype)
            T2f = 0.5 * (Z @ U)
        return ReducedBuffers(
            t0=buf.t0, t1=t1.astype(cdtype), T2=T2f.astype(cdtype))
    if _use_dd_reduction(con, Z, dd_reduce):
        from ..ops import dd as _dd

        k = Z.shape[0]
        t1_dd = _dd.DD(jnp.zeros(k, jnp.float32), jnp.zeros(k, jnp.float32))
        T2 = jnp.zeros((k, k), cdtype)
        if con.v is not None:
            t1_dd = _dd_rows_dot(Z, _dd.from_f32(con.v))
        if con.M is not None:
            if Z.shape[1] >= (1 << 21):
                # vmap materialises per-diagonal (k, n) dd intermediates —
                # ~ndiag·k·n·8 bytes, ~21 GB at heat M=2048; the
                # sequential map keeps the per-row SpMV's temporaries (n,)
                U = lax.map(
                    lambda row: _dd_matvec(
                        con.M, _dd.DD(row, jnp.zeros_like(row))
                    ),
                    Z,
                )
            else:
                U = jax.vmap(
                    lambda h, l: _dd_matvec(con.M, _dd.DD(h, l))
                )(Z, jnp.zeros_like(Z))  # (k, n) dd — batched f32 rolls
            if not x0_zero:
                w = _dd_matvec(con.M, _dd.from_f32(x0.astype(jnp.float32)))
                t1_dd = _dd.add(t1_dd, _dd_rows_dot(Z, w))
            # T2[i, j] = ½ z_i · u_j — chunked map: c rows per iteration
            # reads U once per chunk instead of once per row, while keeping
            # the intermediate at (c, k, n) instead of vmap's (k, k, n)
            k_ = Z.shape[0]
            c = 3
            kp = ((k_ + c - 1) // c) * c
            Zp = jnp.pad(Z, ((0, kp - k_), (0, 0))).reshape(kp // c, c, -1)
            rows = lax.map(
                lambda zc: _dd.dd_sum(
                    _dd.mul_f32(
                        _dd.DD(U.hi[None], U.lo[None]), zc[:, None, :]
                    ),
                    axis=-1,
                ),
                Zp,
            )  # (kp/c, c, k) dd
            T2 = 0.5 * _dd.to_f64(
                _dd.DD(rows.hi.reshape(kp, k_)[:k_],
                       rows.lo.reshape(kp, k_)[:k_])
            ).astype(cdtype)
        t1 = _dd.to_f64(t1_dd).astype(cdtype)
        return ReducedBuffers(t0=buf.t0, t1=t1, T2=T2)
    Zc = Z.astype(cdtype)
    t1 = jnp.zeros(Z.shape[0], cdtype)
    T2 = jnp.zeros((Z.shape[0], Z.shape[0]), cdtype)
    if con.v is not None:
        t1 = t1 + Zc @ con.v.astype(cdtype)
    if con.M is not None:
        U = (con.M @ Zc.T).astype(cdtype)  # (n, k) SpMM, promoted to cdtype
        if not x0_zero:
            t1 = t1 + U.T @ x0.astype(cdtype)
        T2 = 0.5 * (Zc @ U)
    return ReducedBuffers(t0=buf.t0, t1=t1, T2=T2)


def reduced_value(buf: ReducedBuffers, y: jnp.ndarray) -> jnp.ndarray:
    return buf.t0 + jnp.dot(buf.t1, y) + jnp.dot(y, buf.T2 @ y)


def reduced_grad(buf: ReducedBuffers, y: jnp.ndarray) -> jnp.ndarray:
    return buf.t1 + 2.0 * (buf.T2 @ y)


def reduced_hess(buf: ReducedBuffers) -> jnp.ndarray:
    return 2.0 * buf.T2


def reduced_scale(buf: ReducedBuffers, y: jnp.ndarray) -> jnp.ndarray:
    """Roundoff scale of the reduced constraint evaluation: the sum of the
    magnitudes of its summands.  |g(y)| cannot be certified below
    O(eps)·scale in finite precision — e.g. an O(1e4) energy invariant can
    only be enforced to ~1e-12 absolute in f64.  The solver's safety latch
    uses this floor."""
    return (
        jnp.abs(buf.t0)
        + jnp.sum(jnp.abs(buf.t1 * y))
        + jnp.sum(jnp.abs(y[:, None] * buf.T2 * y[None, :]))
    )


def _dd_matvec(M, x):
    """M @ x in double-f32 arithmetic (x a ``dd.DD`` pair, result a DD).

    Dispatches over the operator types a constraint matrix can be: DIA
    (roll-chain SpMV mirrors ops/sparse.py), MatComb (exactly-split static
    coefficients), StageKron (dd through the affine RK map), and dense
    arrays (broadcast two-product + pairwise dd reduction).
    """
    from ..ops import dd as _dd
    from ..ops.sparse import DIA, ELL

    if hasattr(M, "dd_matvec"):  # operator-provided dd path (protocol)
        return M.dd_matvec(x)
    if isinstance(M, DIA):
        return _dd.spmv_dia(_dd.from_f64_jnp(M.data), M.offsets, M.wrap, x)
    if isinstance(M, ELL):
        vals = _dd.from_f64_jnp(M.vals)
        gathered = _dd.DD(x.hi[M.cols], x.lo[M.cols])  # (r, n)
        return _dd.dd_sum(_dd.mul(vals, gathered), axis=0)
    if isinstance(M, MatComb):
        acc = None
        for c, A in zip(M.coeffs, M.mats):
            term = _dd.mul(_dd.from_f64_scalar(float(c)), _dd_matvec(A, x))
            acc = term if acc is None else _dd.add(acc, term)
        return acc
    if isinstance(M, StageKron):
        # P x = dt · Σ_s b_s X_s, then inner, then Pᵀ (scale each stage copy)
        bd = _dd.from_f64_jnp(jnp.asarray(M.b) * M.dt)  # (ns,) exact split
        hi = x.hi.reshape(M.ns, -1)
        lo = x.lo.reshape(M.ns, -1)
        acc = None
        for s in range(M.ns):
            bs = _dd.DD(bd.hi[s], bd.lo[s])
            term = _dd.mul(bs, _dd.DD(hi[s], lo[s]))
            acc = term if acc is None else _dd.add(acc, term)
        w = _dd_matvec(M.inner, acc)
        outs = [_dd.mul(_dd.DD(bd.hi[s], bd.lo[s]), w) for s in range(M.ns)]
        return _dd.DD(
            jnp.stack([o.hi for o in outs]).reshape(-1),
            jnp.stack([o.lo for o in outs]).reshape(-1),
        )
    if not isinstance(M, jnp.ndarray) and hasattr(M, "todense"):
        raise TypeError(
            f"no dd matvec for operator type {type(M).__name__}; "
            "gate with dd_supported()"
        )
    Md = jnp.asarray(M)
    prod = _dd.mul_f32(
        _dd.DD(x.hi[None, :], x.lo[None, :]), Md.astype(jnp.float32)
    )
    return _dd.dd_sum(prod, axis=-1)


def dd_supported(M) -> bool:
    """True if ``_dd_matvec`` has a non-densifying path for this operator."""
    from ..ops.sparse import DIA, ELL

    if M is None or isinstance(M, (DIA, ELL)) or hasattr(M, "dd_matvec"):
        return True
    if isinstance(M, MatComb):
        return all(dd_supported(A) for A in M.mats)
    if isinstance(M, StageKron):
        return dd_supported(M.inner)
    return isinstance(M, jnp.ndarray) and M.ndim == 2


def dd_constraint_value(con: QuadraticConstraint, x) -> jnp.ndarray:
    """g(x) = ½ xᵀ M x + vᵀ x + c evaluated in double-f32 (x a ``dd.DD``).

    This is the mixed-precision certificate path for f32 storage: constraint
    *values* — which need ~1e-14 relative accuracy for the safety latch — are
    computed as unevaluated f32 pairs and only the final scalar is promoted.
    """
    from ..ops import dd as _dd

    acc = _dd.from_f64_jnp(jnp.asarray(con.c))
    if con.v is not None:
        acc = _dd.add(acc, _dd.dot(_dd.from_f64_jnp(jnp.asarray(con.v)), x))
    if con.M is not None:
        u = _dd_matvec(con.M, x)
        acc = _dd.add(acc, _dd.mul_f32(_dd.dot(x, u), jnp.float32(0.5)))
    return _dd.to_f64(acc)


def constraint_checker(x: jnp.ndarray, cons: Sequence[QuadraticConstraint]):
    """Maximum absolute constraint deviation at x.

    The reference's checker takes a signed max (reference solvers.py:14-18,
    a quirk noted in its own docs); we use |·| — strictly safer for the
    safety latch.
    """
    devs = jnp.stack([jnp.abs(c(x)) for c in cons])
    return jnp.max(devs)
