"""Discrete invariant projection — snap an assembled f32 iterate onto the
constraint manifold.

Why this exists: the CGMRES endgame enforces the *reduced* constraints
``g(y) = t0 + t1·y + yᵀT2y`` to ~1e-12 in (dd-accurate) f64 coefficient
space, but the returned iterate is the f32 assembly ``x = x0 + Zᵀy`` — and
on invariants of scale ~1e4 (swe energy e0 ≈ 2.9e4, models/swe.py) the f32
assembly rounding alone re-introduces deviations of
``~√n·eps32·rms(∂g/∂x_i · x_i)`` ≈ 1e-4..1e-3 absolute.  The round-3 swe
sweep's "deviations stuck at 1e-4" was exactly this gap: reduced-space
deviation 9.6e-13, assembled-iterate deviation 1e-3.

The fix is a classic tool of geometric integration — post-step projection
onto the invariant manifold — made f32-representability-aware:

1. **Dense Newton stage**: dd-evaluate the true deviations g_c(x) at the
   assembled x (``dd_constraint_value`` — exact to ~2⁻⁴⁸), then take the
   least-norm Newton step  x ← x − Dᵀ(DDᵀ)⁻¹ g  with D the constraint
   Jacobian (one SpMV per quadratic constraint).  One pass lands at the
   √n-random re-rounding floor of the *update* (the correction is
   roundoff-sized, so each component moves by ≤ ~½ulp).
2. **Windowed trim stage**: the same Newton step restricted to a small
   static window of components — re-rounding noise scales as √window
   instead of √n, buying the last ~1-2 orders down to near-ulp deviation.

Every stage is guarded: the candidate is dd-re-evaluated and kept only if
the worst deviation decreased (where-select — no data-dependent control
flow, and a degenerate window Gram matrix can never corrupt the iterate).
The total displacement is O(deviation/‖∇g‖), orders below the solution
error at the solver tolerance, so the residual is unaffected at tol scale.

Replaces nothing in the reference — the reference runs f64 end-to-end
(reference solvers.py:266-270 checks deviations against ctol=1e-12 directly);
this module is what makes that check *meaningful* on f32 storage.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import jax.numpy as jnp
import numpy as np

from ..ops import dd as _dd
from .quadratic import QuadraticConstraint, dd_constraint_value, dd_supported


def snap_supported(cons: Sequence) -> bool:
    """True if every constraint is quadratic with a dd-evaluable matrix."""
    return all(
        isinstance(c, QuadraticConstraint) and dd_supported(c.M) for c in cons
    )


def _deviations(cons, x) -> jnp.ndarray:
    """(m,) f64 true deviations at f32 x, dd-evaluated."""
    xdd = _dd.from_f32(x)
    return jnp.stack([dd_constraint_value(c, xdd) for c in cons])


def _window_mask(D: jnp.ndarray, w: int) -> jnp.ndarray:
    """(n,) f32 mask selecting the width-``w`` aligned chunk on which every
    constraint's gradient is strongest (max over chunks of the min over
    constraints of the chunk gradient norm²) — a corner-of-domain fixed
    window can be gradient-degenerate (e.g. the swe Gaussian's far corner,
    where ρ ≈ 0 makes the energy gradient vanish)."""
    n = D.shape[1]
    nc = n // w
    scores = jnp.min(
        jnp.sum(D[:, : nc * w].reshape(D.shape[0], nc, w) ** 2, axis=-1),
        axis=0,
    )  # (nc,)
    start = jnp.argmax(scores).astype(jnp.int32) * w
    idx = jnp.arange(n, dtype=jnp.int32)
    return ((idx >= start) & (idx < start + w)).astype(D.dtype)


def _newton_direction(D, x, g, window: int = 0):
    """Least-norm Newton direction −Dᵀ(DDᵀ+λI)⁻¹ g, optionally with D
    restricted to the strongest aligned window of ``window`` components."""
    from ..solvers.kkt import solve_dense

    if window:
        D = D * _window_mask(D, window)[None, :]
    # Gram in f32 (an f64 cast would double the n-sized matmul's traffic);
    # Newton only needs ~1e-3 relative accuracy in G — the dd
    # re-evaluation of g is what certifies the result
    G = (D @ D.T).astype(jnp.float64)  # (m, m) tiny Gram
    # Tikhonov floor keeps a rank-deficient window from producing a huge
    # step (the accept-guard would reject it, but NaN/inf must never form)
    lam = 1e-12 * jnp.maximum(jnp.trace(G), 1e-30)
    alpha = solve_dense(G + lam * jnp.eye(G.shape[0], dtype=G.dtype), -g)
    # cast the (roundoff-sized) coefficients to f32 BEFORE the n-sized work:
    # an f64 α would promote the n-sized axpy to f64
    return alpha.astype(x.dtype) @ D


# a numpy constant: this module is first imported inside a jit trace
# (solvers/cgmres.py), where a module-level jnp array would be a leaked tracer
_TAUS = 2.0 ** -np.arange(13, dtype=np.float64)  # 1, 1/2, …, 2^-12


# Shrinking-window ladder (measured, swe M=64..256 f32): the dense stages
# (0) catch any above-roundoff deviation but are a no-op at the floor —
# their per-component update is sub-ulp and rounds away; TWO dense stages
# because Newton on a quadratic constraint needs a second pass when the
# entry deviation is large (observed: an f32-noisy KKT steer left 2.2e-2 on
# lkdv; dense×1 → 4e-5, dense×2 → 3e-7).  Each narrower window then
# concentrates the correction in fewer components (per-component update ≫
# ulp) while its re-rounding noise shrinks as √w, landing at ~2e-9 absolute
# (≈7e-14 of the swe energy scale) by w=8.
_LADDER = (0, 0, 0, 0, 0, 0, 2048, 512, 128, 32, 8)


def snap(x: jnp.ndarray, cons: Sequence[QuadraticConstraint],
         windows: Tuple[int, ...] = _LADDER, rounds: int = 2):
    """Project f32 ``x`` onto the constraint manifold.  Traceable; returns
    ``(x_snapped, deviations)`` with deviations the certified (dd) f64
    per-constraint values at the RETURNED iterate.

    Cost model: the expensive full dd evaluations (a dd SpMV each — ~35× an
    f32 SpMV) happen exactly TWICE per constraint: at entry and for the
    exit certificate.  Between them every stage re-evaluates through the
    EXACT quadratic increment

        g(x+Δ) = g(x) + ∇g(x)·Δ + ½ ΔᵀMΔ,   ∇g(x) = D_entry + M(x−x_entry)

    where Δ = f32(x_new) − x is the exact realised (post-rounding) update —
    so the measured quantity still includes the f32 re-rounding noise the
    ladder exists to beat.  Each stage then costs dd *dots* plus one f32
    SpMV instead of a dd SpMV (the snap epilogue was 0.44 s of a 0.81 s
    CGMRES at n=4.2M before this).  The Jacobian error of the frozen f32
    ``D_entry`` contributes O(eps32·|g|) per stage — relative to the
    deviation being removed, far below the target floor."""
    from ..ops import dd as _dd

    m = len(cons)
    if m == 0:
        return x, jnp.zeros((0,), jnp.float64)
    n = x.shape[0]
    # TWO ladder rounds with a full dd/gradient REFRESH between them: with a
    # large entry deviation (f32-reduced steering leaves ~7e-5 at heat
    # M=512 vs ~9e-6 dd-steered) one round's frozen-entry model floors at
    # ~3e-8 — re-entering with fresh D and g lands at ~1e-15 (round-5
    # probe).  The refresh costs one dd evaluation set (it doubles as the
    # previous round's exit check) plus m f32 SpMVs for D.
    g = _deviations(cons, x)
    for _ in range(max(int(rounds), 1)):
        D = jnp.stack([c.grad(x) for c in cons])  # (m, n) f32
        x_entry = x
        for window in windows:
            if window >= n:
                continue
            if window == 0:
                # REFRESH the gradient before every dense stage (m f32
                # SpMVs — cheap; the dd deviations stay incremental): with
                # a strongly curved manifold and a large deviation (heat
                # M=2048 entry ~0.08) each damped step only contracts ~1.7×
                # and a stale gradient stalls the descent entirely
                D = jnp.stack([c.grad(x) for c in cons])
                x_entry = x
            dirn = _newton_direction(D, x, g, window)
            if window == 0:
                # damped DENSE stage: a full Newton step from a LARGE entry
                # deviation overshoots the quadratic term (½δᵀMδ ∝ ‖δ‖²)
                # and the guard rejects every stage — at heat M=2048 the
                # f32r-steered entry sits at ~0.08 and the undamped ladder
                # made zero progress (round-5 probe).  The increment along
                # τ·dirn is EXACTLY quadratic in τ, so the whole
                # backtracking grid costs one lin/quad computation.  The
                # windowed trim stages stay undamped: their corrections are
                # roundoff-sized and the model (which ignores f32
                # re-rounding) would starve them with tiny τ.
                lin, quad = [], []
                for ci, con in enumerate(cons):
                    l = _dd.dot_f32(_dd.from_f32(D[ci]), dirn)
                    q = jnp.float64(0.0)
                    if con.M is not None:
                        md = (con.M @ dirn).astype(jnp.float32)
                        l = _dd.add(l, _dd.dot_f32(
                            _dd.from_f32(md), x - x_entry))
                        q = 0.5 * _dd.to_f64(
                            _dd.dot_f32(_dd.from_f32(md), dirn))
                    lin.append(_dd.to_f64(l))
                    quad.append(q)
                lin = jnp.stack(lin)
                quad = jnp.stack(quad)
                taus = jnp.asarray(_TAUS)
                gmod = (g[None, :] + taus[:, None] * lin[None, :]
                        + (taus ** 2)[:, None] * quad[None, :])
                tau = taus[jnp.argmin(jnp.max(jnp.abs(gmod), axis=1))]
                x_new = x + tau.astype(x.dtype) * dirn
            else:
                x_new = x + dirn
            delta = x_new - x  # exact realised (post-rounding) update
            gnew = []
            for ci, con in enumerate(cons):
                t = _dd.dot_f32(_dd.from_f32(D[ci]), delta)
                if con.M is not None:
                    md = (con.M @ delta).astype(jnp.float32)
                    # (M(x−x_entry))·Δ + ½Δ·MΔ = (MΔ)·((x−x_entry) + ½Δ)
                    t = _dd.add(t, _dd.dot_f32(
                        _dd.from_f32(md), (x - x_entry) + 0.5 * delta))
                gnew.append(g[ci] + _dd.to_f64(t))
            g_new = jnp.stack(gnew)
            better = (jnp.max(jnp.abs(g_new)) < jnp.max(jnp.abs(g))) \
                & jnp.all(jnp.isfinite(g_new))
            x = jnp.where(better, x_new, x)
            g = jnp.where(better, g_new, g)
        # fresh dd evaluation: next round's entry AND the exit certificate —
        # the reported deviations are always measured at the RETURNED
        # iterate, independent of the incremental estimates
        g = _deviations(cons, x)
    return x, g
