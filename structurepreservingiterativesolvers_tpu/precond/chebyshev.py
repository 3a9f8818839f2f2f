"""Polynomial preconditioners (Chebyshev and Neumann).

Data-parallel replacements for the algorithmically sequential preconditioners
the reference imports (SuperLU ILU triangular solves; PyAMG Ruge–Stüben,
reference heat/TimedSolve.py:30-31): a fixed short sequence of SpMVs is
perfectly jit-able, has no data-dependent control flow, and — because FGMRES
is flexible — any fixed polynomial in A is an admissible right
preconditioner.

* ``chebyshev(A, lmin, lmax, degree)`` — optimal polynomial approximation of
  A⁻¹ on a positive spectrum interval (SPD systems, e.g. heat).
* ``neumann(A, degree, omega)`` — truncated Neumann series of the
  Jacobi-scaled system; works for the mildly nonsymmetric systems.
* ``power_bounds(A)`` — cheap spectral-interval estimate (power iteration on
  the Jacobi-scaled operator).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.sparse import _register
from .jacobi import diagonal


@_register
@dataclasses.dataclass(frozen=True)
class Chebyshev:
    """Chebyshev polynomial approximation of A⁻¹ on [lmin, lmax] applied via
    the standard three-term recurrence (one SpMV per degree)."""

    A: object
    lmin: float  # static
    lmax: float  # static
    degree: int  # static

    _static = ("lmin", "lmax", "degree")

    def __call__(self, v):
        theta = 0.5 * (self.lmax + self.lmin)
        delta = 0.5 * (self.lmax - self.lmin)
        sigma = theta / delta
        rho = 1.0 / sigma
        x = v / theta
        r = v - self.A @ x
        d = (2.0 * rho / delta) * r
        for _ in range(self.degree - 1):
            x = x + d
            r = r - self.A @ d
            rho_new = 1.0 / (2.0 * sigma - rho)
            d = (rho_new * rho) * d + (2.0 * rho_new / delta) * r
            rho = rho_new
        return x + d if self.degree >= 1 else x

    def solve(self, v):
        return self(v)


@_register
@dataclasses.dataclass(frozen=True)
class Neumann:
    """Truncated Neumann series for (D⁻¹A) with damping ω:
    p(A) = ω Σ_{i<degree} (I − ω D⁻¹A)^i D⁻¹."""

    A: object
    dinv: jnp.ndarray
    omega: float  # static
    degree: int  # static

    _static = ("omega", "degree")

    def __call__(self, v):
        z = self.omega * (self.dinv * v)
        acc = z
        for _ in range(self.degree - 1):
            z = z - self.omega * (self.dinv * (self.A @ z))
            acc = acc + z
        return acc

    def solve(self, v):
        return self(v)


@_register
@dataclasses.dataclass(frozen=True)
class NeumannComposite:
    """Neumann acceleration of an *inner* preconditioner B:

        M⁻¹ = Σ_{i≤degree} (I − B A)^i B

    — the polynomial-of-preconditioned-operator upgrade that closes the
    iteration-count gap to the reference's SuperLU ILU
    (lkdvRK/Evolve.py:51-52): each extra degree costs one SpMV + one inner
    apply (batched dense work for block/RAS inners), no triangular solves.
    With a RAS inner this reaches ILU-level preconditioning quality on the
    lkdvRK stage systems (see docs/ILU_PARITY.md)."""

    A: object
    inner: object
    degree: int  # static

    _static = ("degree",)

    def __call__(self, v):
        from .base import apply_preconditioner

        z = apply_preconditioner(self.inner, v)
        acc = z
        for _ in range(self.degree):
            z = z - apply_preconditioner(self.inner, self.A @ z)
            acc = acc + z
        return acc

    def solve(self, v):
        return self(v)


def neumann_composite(A, inner, degree: int = 2) -> NeumannComposite:
    return NeumannComposite(A=A, inner=inner, degree=int(degree))


@_register
@dataclasses.dataclass(frozen=True)
class SkewNormalChebyshev:
    """Polynomial approximate inverse for shifted-skew systems A = aI − K
    with K skew(-adjoint in some inner product) — the swe midpoint operator
    A = I/dt − S/2 (models/swe.py; reference swe/swe.py:61-66 builds the
    same Crank–Nicolson form, and swe/TimedSolve.py:23-24 pairs it with
    SuperLU spilu, whose triangular solves are sequential).

    Identity: A·(2aI − A) = a²I − K² =: N is SPD in the skewness inner
    product with spectrum ⊂ [a², a² + ρ(K)²] — a SHORT interval whose
    condition κ = 1 + (ρ(K)/a)² stays O(1) across the reference sweep.  So

        A⁻¹ = (2aI − A) · N⁻¹ ≈ (2aI − A) · q(N)

    with q the degree-``degree`` Chebyshev approximation of the inverse on
    [lmin, lmax].  Each N-apply is two A-SpMVs; the whole preconditioner is
    a fixed chain of 2·degree+1 SpMVs — fully fused by XLA, no triangular
    solves, M-robust where the truncated Neumann series diverges for
    ρ(dt·S/2) > 1 (M ≳ 283 on the reference swe grid)."""

    A: object
    a: float  # static — the shift: A = aI − K
    lmin: float  # static: lower spectral bound of N (≈ a²)
    lmax: float  # static: upper bound (a² + ρ(K)² with margin)
    degree: int  # static

    _static = ("a", "lmin", "lmax", "degree")

    def _N(self, v):
        # N v = A (2a v − A v) = (a²I − K²) v
        return self.A @ (2.0 * self.a * v - self.A @ v)

    def __call__(self, v):
        theta = 0.5 * (self.lmax + self.lmin)
        delta = 0.5 * (self.lmax - self.lmin)
        sigma = theta / delta
        rho = 1.0 / sigma
        x = v / theta
        r = v - self._N(x)
        d = (2.0 * rho / delta) * r
        for _ in range(self.degree - 1):
            x = x + d
            r = r - self._N(d)
            rho_new = 1.0 / (2.0 * sigma - rho)
            d = (rho_new * rho) * d + (2.0 * rho_new / delta) * r
            rho = rho_new
        u = x + d if self.degree >= 1 else x
        return 2.0 * self.a * u - self.A @ u

    def solve(self, v):
        return self(v)


def skew_normal_chebyshev(A, a: float, rho_k: Optional[float] = None,
                          degree: Optional[int] = None,
                          target: float = 0.03) -> SkewNormalChebyshev:
    """Build a SkewNormalChebyshev for A = aI − K (K skew).

    ``rho_k`` (spectral radius of K) is estimated by power iteration on
    K = aI − A if not given.  ``degree=None`` auto-selects the smallest
    degree whose Chebyshev min-max error on [a², a² + ρ(K)²] is ≤ ``target``
    — preconditioned GMRES then contracts the residual by ~``target`` per
    iteration regardless of M."""
    import math

    if rho_k is None:
        # power iteration on K can under-converge when skew eigenvalue
        # pairs cluster (advisor r4 #3): take the MAX over the last norm
        # ratios instead of the final one, and widen the margin to 1.1 —
        # lmax < λmax(N) would make the Chebyshev polynomial AMPLIFY
        # exterior modes, while a mild overestimate only costs a slightly
        # flatter polynomial
        n = A.shape[0]
        rng = np.random.default_rng(0)
        v = jnp.asarray(rng.standard_normal(n), diagonal(A).dtype)
        v = v / jnp.linalg.norm(v)
        est = 0.0
        for it in range(30):
            w = a * v - A @ v  # K v
            nw = float(jnp.linalg.norm(w))
            if it >= 25:
                est = max(est, nw)
            v = w / nw
        rho_k = 1.1 * est
    lmin = float(a) ** 2
    lmax = lmin + float(rho_k) ** 2
    if degree is None:
        kappa = lmax / lmin
        factor = (math.sqrt(kappa) - 1.0) / (math.sqrt(kappa) + 1.0)
        if factor <= 0:
            degree = 1
        else:
            degree = max(1, math.ceil(math.log(2.0 / target)
                                      / math.log(1.0 / factor)))
    return SkewNormalChebyshev(A=A, a=float(a), lmin=lmin, lmax=lmax,
                               degree=int(degree))


def power_bounds(A, iters: int = 30, seed: int = 0):
    """Estimate the spectral interval of D⁻¹A by power iteration.
    Returns (lmin_est, lmax_est) with safety margins."""
    n = A.shape[0]
    dinv = 1.0 / jnp.where(diagonal(A) == 0, 1.0, diagonal(A))
    v = jnp.asarray(np.random.default_rng(seed).standard_normal(n), dinv.dtype)
    v = v / jnp.linalg.norm(v)
    lmax = 1.0
    for _ in range(iters):
        w = dinv * (A @ v)
        lmax = jnp.linalg.norm(w)
        v = w / jnp.where(lmax == 0, 1.0, lmax)
    lmax = float(lmax)
    return 0.05 * lmax, 1.1 * lmax


def chebyshev(A, lmin: Optional[float] = None, lmax: Optional[float] = None,
              degree: int = 8):
    """Build a Chebyshev preconditioner; bounds estimated if not given.

    For diagonally-scaled operation, compose with Jacobi outside; here we
    precondition A itself using estimated bounds of A's spectrum (via the
    Rayleigh quotient growth of plain power iteration)."""
    if lmin is None or lmax is None:
        n = A.shape[0]
        rng = np.random.default_rng(0)
        v = jnp.asarray(rng.standard_normal(n), diagonal(A).dtype)
        v = v / jnp.linalg.norm(v)
        est = 1.0
        for _ in range(30):
            w = A @ v
            est = float(jnp.linalg.norm(w))
            v = w / est
        lmax = lmax or 1.1 * est
        lmin = lmin or 0.03 * est
    return Chebyshev(A=A, lmin=float(lmin), lmax=float(lmax),
                     degree=int(degree))


def neumann(A, degree: int = 4, omega: float = 0.8):
    d = diagonal(A)
    dinv = 1.0 / jnp.where(d == 0, 1.0, d)
    return Neumann(A=A, dinv=dinv, omega=float(omega), degree=int(degree))
