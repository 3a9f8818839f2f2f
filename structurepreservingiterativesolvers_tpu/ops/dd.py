"""Double-f32 ("dd") arithmetic: f64-grade accuracy from paired f32 ops.

Used when a system is stored in float32: the constrained endgame needs
~1e-14-relative constraint *values* but only f32-accurate Jacobians, so the
certificate computes values in double-f32: each number is an unevaluated sum
``hi + lo`` of two f32s (~2⁻⁴⁸ ≈ 3.6e-15 unit roundoff), using only
error-free transformations (Knuth two-sum, Dekker split two-product) — pure
elementwise ops that XLA fuses, with no n-sized f64 arrays.  float64 systems
do not use this module (the reference runs numpy f64 end-to-end).

Classic references: Dekker (1971), Knuth TAOCP vol. 2, Hida–Li–Bailey's QD.
No FMA is assumed (XLA exposes none portably): two_prod uses Dekker
splitting, which is exact only if the backend does not contract ``a·b − p``
into a fused multiply-add; ``tests/test_dd.py`` and ``chip_smoke.py`` check
the identities on the backend they run on.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import jax.numpy as jnp
import numpy as np

# Dekker split constant for f32 (24-bit mantissa → 12+12): 2**12 + 1
_SPLIT_F32 = np.float32(4097.0)


class DD(NamedTuple):
    """Unevaluated sum hi + lo, both f32 (|lo| ≤ ulp(hi)/2)."""

    hi: jnp.ndarray
    lo: jnp.ndarray


def two_sum(a, b) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Error-free a + b = s + err (Knuth; no magnitude assumption)."""
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def quick_two_sum(a, b) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Error-free a + b = s + err, REQUIRES |a| >= |b| (or a == 0)."""
    s = a + b
    err = b - (s - a)
    return s, err


def _split(a) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Dekker split: a = hi + lo with hi, lo having ≤ 12 significant bits."""
    c = _SPLIT_F32 * a
    hi = c - (c - a)
    return hi, a - hi


def two_prod(a, b) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Error-free a · b = p + err (Dekker two-product, FMA-free)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, err


# ---------------------------------------------------------------------------
# dd scalar/array ops (all elementwise, broadcasting like jnp)
# ---------------------------------------------------------------------------


def add(x: DD, y: DD) -> DD:
    s, e = two_sum(x.hi, y.hi)
    t, f = two_sum(x.lo, y.lo)
    e = e + t
    s, e = quick_two_sum(s, e)
    e = e + f
    s, e = quick_two_sum(s, e)
    return DD(s, e)


def add_f32(x: DD, y) -> DD:
    s, e = two_sum(x.hi, y)
    e = e + x.lo
    s, e = quick_two_sum(s, e)
    return DD(s, e)


def neg(x: DD) -> DD:
    return DD(-x.hi, -x.lo)


def sub(x: DD, y: DD) -> DD:
    return add(x, neg(y))


def mul(x: DD, y: DD) -> DD:
    p, e = two_prod(x.hi, y.hi)
    e = e + (x.hi * y.lo + x.lo * y.hi)
    p, e = quick_two_sum(p, e)
    return DD(p, e)


def mul_f32(x: DD, y) -> DD:
    """x · y where y is a plain f32 array (exact in the product term)."""
    p, e = two_prod(x.hi, y)
    e = e + x.lo * y
    p, e = quick_two_sum(p, e)
    return DD(p, e)


def scale(x: DD, s: float) -> DD:
    """x · s for a *Python* scalar s, split exactly through dd."""
    return mul(x, from_f64_scalar(s, x.hi.shape, x.hi.dtype))


# ---------------------------------------------------------------------------
# conversions
# ---------------------------------------------------------------------------


def from_f32(a) -> DD:
    a = jnp.asarray(a, jnp.float32)
    return DD(a, jnp.zeros_like(a))


def from_f64_np(a: np.ndarray) -> DD:
    """Exact split of host f64 data into (hi, lo) f32 pair (build-time)."""
    a = np.asarray(a, np.float64)
    hi = a.astype(np.float32)
    lo = (a - hi.astype(np.float64)).astype(np.float32)
    return DD(jnp.asarray(hi), jnp.asarray(lo))


def from_f64_scalar(v: float, shape=(), dtype=jnp.float32) -> DD:
    hi = np.float32(v)
    lo = np.float32(np.float64(v) - np.float64(hi))
    return DD(jnp.broadcast_to(jnp.asarray(hi, dtype), shape),
              jnp.broadcast_to(jnp.asarray(lo, dtype), shape))


def from_f64_jnp(a) -> DD:
    """Split a traced f64 array (use sparingly: touches f64 on device)."""
    hi = a.astype(jnp.float32)
    return DD(hi, (a - hi.astype(a.dtype)).astype(jnp.float32))


def to_f64(x: DD) -> jnp.ndarray:
    return x.hi.astype(jnp.float64) + x.lo.astype(jnp.float64)


# ---------------------------------------------------------------------------
# reductions
# ---------------------------------------------------------------------------


def dd_sum(x: DD, axis: int = -1) -> DD:
    """Compensated sum along ``axis`` via pairwise tree folding in dd.

    log2(n) dd-adds on halving arrays — O(n) total work, error O(eps²·log n).
    """
    hi = jnp.moveaxis(x.hi, axis, -1)
    lo = jnp.moveaxis(x.lo, axis, -1)
    n = hi.shape[-1]
    while n > 1:
        half = (n + 1) // 2
        pad = half * 2 - n
        if pad:
            hi = jnp.concatenate(
                [hi, jnp.zeros(hi.shape[:-1] + (pad,), hi.dtype)], axis=-1)
            lo = jnp.concatenate(
                [lo, jnp.zeros(lo.shape[:-1] + (pad,), lo.dtype)], axis=-1)
        a = DD(hi[..., :half], lo[..., :half])
        b = DD(hi[..., half:], lo[..., half:])
        out = add(a, b)
        hi, lo = out.hi, out.lo
        n = half
    return DD(hi[..., 0], lo[..., 0])


def dot(x: DD, y: DD) -> DD:
    """dd inner product over the last axis."""
    return dd_sum(mul(x, y), axis=-1)


def dot_f32(x: DD, y) -> DD:
    """dd · f32 inner product over the last axis (y exact f32)."""
    return dd_sum(mul_f32(x, y), axis=-1)


# ---------------------------------------------------------------------------
# linear algebra building blocks for the constrained endgame
# ---------------------------------------------------------------------------


def combine_f32(coeffs_y, Z) -> DD:
    """x = Σ_j y_j · Z[j] in dd, where y is (k,) f64 and Z is (k, n) f32.

    The Krylov basis Z is stored in f32 (exact values); the f64 coefficients
    are split exactly.  k sequential dd accumulations of elementwise
    two-products — O(k·n) elementwise work, no f64 array ops.
    """
    k = Z.shape[0]
    y_hi = coeffs_y.astype(jnp.float32)
    y_lo = (coeffs_y - y_hi.astype(coeffs_y.dtype)).astype(jnp.float32)
    acc = DD(jnp.zeros_like(Z[0]), jnp.zeros_like(Z[0]))
    for j in range(k):
        yj = DD(jnp.broadcast_to(y_hi[j], Z[j].shape),
                jnp.broadcast_to(y_lo[j], Z[j].shape))
        acc = add(acc, mul_f32(yj, Z[j]))
    return acc


def spmv_dia(data: DD, offsets, wrap: bool, x: DD) -> DD:
    """DIA SpMV in dd: y[i] = Σ_d A[d,i] · x[i + off_d] (rolled reads).

    Mirrors ops/sparse.py::dia_spmv's roll-chain strategy with dd
    accumulation.
    """
    from .sparse import _shift

    acc = None
    for d, off in enumerate(offsets):
        xs = DD(_shift(x.hi, off, wrap), _shift(x.lo, off, wrap))
        term = mul(DD(data.hi[d], data.lo[d]), xs)
        acc = term if acc is None else add(acc, term)
    return acc
