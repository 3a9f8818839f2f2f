"""1-D linear KdV with Gauss–Legendre Runge–Kutta stepping (stage-coupled).

Capability parity with the reference's Irksome-based problem module
(reference ``lkdvRK/lkdvRK.py``).  The weak form (lkdvRK/lkdvRK.py:107-111)

    F1 = Dt(u)·φ + G v,   F2 = (v−u)·ψ − G w,   F3 = w·χ − G u

is collocated at the s Gauss–Legendre stages: unknowns are the stacked stage
derivatives k = (k_1,…,k_s), each a 3-field vector, with stage values
``z_s = z0 + dt Σ_j a_sj k_j`` (Irksome's ``getForm`` convention,
lkdvRK/lkdvRK.py:113-118).  Differentiating gives the block system

    rows (s,·):  [ δ_sj·M      dt a_sj·G    0        ] [k_j^u]   [ −G v0           ]
                 [ −dt a_sj·M  dt a_sj·M   −dt a_sj·G ] [k_j^v] = [ Mu0 − Mv0 + Gw0 ]
                 [ −dt a_sj·G  0            dt a_sj·M ] [k_j^w]   [ Gu0 − Mw0       ]

— the Kronecker expansion ``I⊗blockdiag + dt·(a ⊗ coupling)`` built directly
from the 1-D operators (no Irksome).  The step reconstruction is
``z1 = z0 + dt Σ b_s k_s`` (``z1calc``, lkdvRK/lkdvRK.py:162-174); mass /
momentum / energy constraints on z1 are compiled through that affine map into
plain quadratic constraints on stage space (``stage_mapped``) — replacing
the reference's slow dict-form callables (lkdvRK/LinearSolver.py:29-76)
with the fast path.

Consistent initial data: w0 = M⁻¹G u0, v0 = u0 + M⁻¹G w0 (the reference's
``w_finder``/``v_finder`` LU solves, lkdvRK/lkdvRK.py:65-93).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from ..config import default_dtype
from ..constraints.quadratic import QuadraticConstraint, stage_mapped
from ..ops.sparse import bsr_from_scipy, from_scipy
from ..ops.stencil import maybe_stencil
from .fem1d import Space1D
from .lkdv import MLENGTH, _BlockDiag3
from .tableaux import ButcherTableau, gauss_legendre


@dataclasses.dataclass
class Problem:
    N: int = 100
    M: int = 50
    degree: int = 1
    tstages: int = 2
    space: str = "DG"
    T: float = 1.0
    mlength: float = MLENGTH
    dim: int = 3

    def __post_init__(self):
        self.tableau: ButcherTableau = gauss_legendre(self.tstages)
        self.ns = self.tableau.num_stages

    @property
    def dt(self) -> float:
        return float(self.T) / self.N

    def fem(self) -> Space1D:
        return Space1D(self.M, self.mlength, self.degree, self.space)

    def exact(self, x, t):
        alpha = 4.0
        beta = alpha * 2.0 * np.pi / self.mlength
        return np.sin(beta * (x - (1.0 - beta**2) * t)) + 1.0


@dataclasses.dataclass
class System:
    A: object
    b: jnp.ndarray
    z0: jnp.ndarray  # (3n0,) current step's initial mixed vector
    Mmat: object
    Gmat: object
    Minv: object  # block-diagonal mass inverse (DG), device
    omega: jnp.ndarray
    m0: jnp.ndarray
    mo0: jnp.ndarray
    e0: jnp.ndarray
    prob: Problem
    n0: int
    fem: Space1D = dataclasses.field(repr=False, default=None)
    A_csr: sp.csr_matrix = dataclasses.field(repr=False, default=None)
    Mh: sp.csr_matrix = dataclasses.field(repr=False, default=None)

    @property
    def dof(self) -> int:
        return 3 * self.n0

    def z1calc(self, zbig: jnp.ndarray) -> jnp.ndarray:
        """Step reconstruction z1 = z0 + dt Σ b_s k_s
        (reference lkdvRK/lkdvRK.py:162-174)."""
        prob = self.prob
        ks = zbig.reshape(prob.ns, self.dof)
        bw = jnp.asarray(prob.tableau.b, zbig.dtype)
        return self.z0 + prob.dt * jnp.tensordot(bw, ks, axes=1)

    def constraints(self):
        """Stage-space quadratic constraints equivalent to the reference's
        dict-form mass/momentum/energy (lkdvRK/LinearSolver.py:29-79)."""
        n0, prob = self.n0, self.prob
        dt = self.b.dtype
        omega_full = jnp.zeros(3 * n0, dt).at[:n0].set(self.omega)
        inner = [
            QuadraticConstraint(M=None, v=omega_full, c=-self.m0, name="mass"),
            QuadraticConstraint(
                M=_BlockDiag3(self.Mmat, (1.0, 0.0, 0.0)), v=None, c=-self.mo0,
                name="momentum",
            ),
            QuadraticConstraint(
                M=_BlockDiag3(self.Mmat, (-1.0, 0.0, 1.0)), v=None, c=-self.e0,
                name="energy",
            ),
        ]
        bw = jnp.asarray(prob.tableau.b, dt)
        return [
            stage_mapped(c, bw, prob.dt, prob.ns, self.z0) for c in inner
        ]

    def compute_invariants(self, zbig: jnp.ndarray) -> dict:
        z1 = self.z1calc(zbig)
        u, v, w = jnp.split(z1, 3)
        return {
            "mass": jnp.dot(self.omega, u),
            "momentum": 0.5 * jnp.dot(u, self.Mmat @ u),
            "energy": 0.5 * jnp.dot(w, self.Mmat @ w) - 0.5 * jnp.dot(u, self.Mmat @ u),
        }

    def step_update(self, zbig_prev: jnp.ndarray) -> "System":
        """Next-step stage system from the previous stage solution.

        Reconstructs z1, re-derives consistent auxiliary fields on device
        (w = M⁻¹G u, v = u + M⁻¹G w — the reference's per-step
        ``v_finder``/``w_finder`` LU solves, lkdvRK/lkdvRK.py:65-93, done
        here with the precomputed block-diagonal DG mass inverse), and
        re-seeds b and the invariant targets.  With consistent fields the
        algebraic stage rows have zero right-hand side, so
        b = [−G v0; 0; 0] per stage."""
        prob = self.prob
        n0 = self.n0
        z1 = self.z1calc(zbig_prev)
        u1 = z1[:n0]
        w0 = self.Minv @ (self.Gmat @ u1)
        v0 = u1 + self.Minv @ (self.Gmat @ w0)
        z0n = jnp.concatenate([u1, v0, w0])
        b_stage = jnp.concatenate(
            [-(self.Gmat @ v0), jnp.zeros(2 * n0, z1.dtype)]
        )
        return dataclasses.replace(
            self,
            b=jnp.tile(b_stage, prob.ns),
            z0=z0n,
            m0=jnp.dot(self.omega, u1),
            mo0=0.5 * jnp.dot(u1, self.Mmat @ u1),
            e0=0.5 * jnp.dot(w0, self.Mmat @ w0) - 0.5 * jnp.dot(u1, self.Mmat @ u1),
        )

    def compute_error(self, zbig: jnp.ndarray, t: float) -> float:
        """L2(u) error vs the exact travelling wave at time t
        (reference lkdvRK/lkdvRK.py:223-240)."""
        z1 = np.asarray(self.z1calc(zbig))
        u1 = np.split(z1, 3)[0]
        uex = self.fem.project(lambda x: self.prob.exact(x, t))
        e = u1 - uex
        return float(np.sqrt(e @ (self.Mh @ e)))


def _mass_inverse(Mh: sp.csr_matrix, fem: Space1D) -> sp.csr_matrix:
    """Explicit sparse mass inverse.  DG mass is block-diagonal per element,
    so the inverse is too; for CG we fall back to a dense inverse of the
    (banded, well-conditioned) mass — only used at assembly time."""
    if fem.kind == "DG":
        blocks = [
            np.linalg.inv(Mh[idx][:, idx].toarray()) for idx in fem.lg
        ]
        return sp.csr_matrix(sp.block_diag(blocks))
    return sp.csr_matrix(np.linalg.inv(Mh.toarray()))


def element_block_preconditioner(system: "System", elems_per_block: int = 2,
                                 overlap: int = 0):
    """Block preconditioner coupling all fields and stages of
    ``elems_per_block`` adjacent elements — the data-parallel stand-in for
    the reference's SuperLU ILU factor (lkdvRK/Evolve.py:51-52): the
    per-block dense solves run as one batched matmul instead of sequential
    triangular solves.  ``overlap`` > 0 upgrades to restricted additive
    Schwarz with that many halo elements per side (periodic), cutting the
    iteration count further."""
    from ..precond import block_jacobi
    from ..precond.jacobi import ras

    n0, prob = system.n0, system.prob
    nloc = prob.degree + 1
    ne = n0 // nloc
    if ne % elems_per_block:
        raise ValueError("elems_per_block must divide the element count")

    def elem_dofs(elems):
        idx = []
        for st in range(prob.ns):
            for f in range(3):
                base = st * 3 * n0 + f * n0
                for e in elems:
                    e = e % ne
                    idx.extend(range(base + e * nloc, base + (e + 1) * nloc))
        return np.asarray(idx)

    if overlap == 0:
        blocks = [
            elem_dofs(range(e0, e0 + elems_per_block))
            for e0 in range(0, ne, elems_per_block)
        ]
        return block_jacobi(system.A_csr, blocks, dtype=system.b.dtype)

    blocks, owned = [], []
    width = elems_per_block + 2 * overlap
    for e0 in range(0, ne, elems_per_block):
        elems = list(range(e0 - overlap, e0 + elems_per_block + overlap))
        blocks.append(elem_dofs(elems))
        own = np.zeros(width * prob.ns * 3 * nloc, dtype=bool)
        # ownership: the central elems_per_block elements of every field/stage
        per_field = width * nloc
        mask1 = np.zeros(per_field, dtype=bool)
        mask1[overlap * nloc:(overlap + elems_per_block) * nloc] = True
        own = np.tile(mask1, prob.ns * 3)
        owned.append(own)
    return ras(system.A_csr, blocks, owned, dtype=system.b.dtype)


def linforms(
    N: int = 100,
    M: int = 50,
    degree: int = 1,
    tstages: int = 2,
    T: float = 1.0,
    space: str = "DG",
    zinit: Optional[np.ndarray] = None,
    dtype=None,
) -> System:
    dtype = dtype or default_dtype()
    prob = Problem(N=N, M=M, degree=degree, tstages=tstages, space=space, T=float(T))
    fem = prob.fem()
    n0 = fem.ndof
    ns, dt_step = prob.ns, prob.dt
    a, bw = prob.tableau.A, prob.tableau.b

    Mh = fem.mass()
    Gh = fem.gfunc()
    omega_h = fem.omega()

    if zinit is None:
        u0 = fem.project(lambda x: prob.exact(x, 0.0))
    else:
        u0 = np.split(np.asarray(zinit), 3)[0]
    # consistent auxiliary fields (v_finder / w_finder)
    w0 = spla.spsolve(Mh, Gh @ u0)
    v0 = u0 + spla.spsolve(Mh, Gh @ w0)

    Z = sp.csr_matrix((n0, n0))
    blocks = []
    for s in range(ns):
        row = []
        for j in range(ns):
            d = 1.0 if s == j else 0.0
            asj = dt_step * a[s, j]
            row.append(
                sp.bmat(
                    [
                        [d * Mh if d else Z, asj * Gh, Z],
                        [-asj * Mh, asj * Mh, -asj * Gh],
                        [-asj * Gh, Z, asj * Mh],
                    ]
                )
            )
        blocks.append(row)
    A_csr = sp.csr_matrix(sp.bmat(blocks))

    b_stage = np.concatenate(
        [-(Gh @ v0), Mh @ u0 - Mh @ v0 + Gh @ w0, Gh @ u0 - Mh @ w0]
    )
    b_big = np.tile(b_stage, ns)

    m0 = omega_h @ u0
    mo0 = 0.5 * u0 @ (Mh @ u0)
    e0 = 0.5 * w0 @ (Mh @ w0) - 0.5 * u0 @ (Mh @ u0)
    z0 = np.concatenate([u0, v0, w0])

    return System(
        A=maybe_stencil(from_scipy(A_csr, dtype=dtype)),
        b=jnp.asarray(b_big, dtype),
        z0=jnp.asarray(z0, dtype),
        Mmat=from_scipy(Mh, dtype=dtype),
        Gmat=from_scipy(Gh, dtype=dtype),
        # DG mass inverse is block-diagonal per element → BSR: the
        # consistent-field updates in step_update run as batched block
        # matmuls (bsr_spmm) instead of a gathered ELL SpMV
        Minv=(
            bsr_from_scipy(_mass_inverse(Mh, fem), prob.degree + 1, dtype=dtype)
            if fem.kind == "DG"
            else from_scipy(_mass_inverse(Mh, fem), dtype=dtype)
        ),
        omega=jnp.asarray(omega_h, dtype),
        m0=jnp.asarray(m0, dtype),
        mo0=jnp.asarray(mo0, dtype),
        e0=jnp.asarray(e0, dtype),
        prob=prob,
        n0=n0,
        fem=fem,
        A_csr=A_csr,
        Mh=Mh,
    )
