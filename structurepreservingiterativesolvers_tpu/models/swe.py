"""2-D linear rotating shallow water (periodic square), midpoint step.

Capability parity with the reference problem module (reference
``swe/swe.py``): the linear rotating SWE

    u_t − f v + c² ρ_x = 0
    v_t + f u + c² ρ_y = 0
    ρ_t + u_x + v_y  = 0

with mass (∫ρ) and energy (½∫|u|² + ½c²∫ρ²) invariants
(swe/swe.py:104-107, swe/LinearSolver.py:23-33).

Discretisation re-design: the reference uses a Firedrake RT(point)×DG mixed
pair (swe/swe.py:28-32).  Here we use its structured twin, an Arakawa C-grid
staggered finite-difference/finite-volume scheme — u on x-edges, v on
y-edges, ρ at centres — with the energy-conserving 4-point Coriolis average.
The semi-discrete operator S is skew-symmetric in the energy inner product
P = h²·diag(I, I, c²I), so the midpoint step conserves mass and energy
exactly, giving the same constraint structure as the reference problem while
mapping onto pure shift stencils (DIA diagonals — no gather).

System:  A = I/dt − ½S,   b = (I/dt + ½S) z0   (identity mass matrix).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp

from ..config import default_dtype
from ..constraints.quadratic import QuadraticConstraint
from ..ops.sparse import from_scipy
from ..ops.stencil import maybe_stencil

MLENGTH = 40.0


@dataclasses.dataclass
class Problem:
    N: int = 100
    M: int = 50
    degree: int = 1
    T: float = 10.0
    mlength: float = MLENGTH
    c: float = 1.0  # wave speed (swe/swe.py:19)
    f: float = 0.1  # Coriolis parameter (swe/swe.py:20)

    @property
    def dt(self) -> float:
        return float(self.T) / self.N

    @property
    def h(self) -> float:
        return self.mlength / self.M

    def ic_rho(self, x, y):
        """Gaussian height anomaly at domain centre (swe/swe.py:34-40)."""
        return 10.0 * np.exp(-((x - 20.0) ** 2 + (y - 20.0) ** 2) / 20.0**2)


def _shift_op(M: int, di: int, dj: int) -> sp.csr_matrix:
    """Periodic shift operator on an M×M grid flattened row-major:
    (Su)[i,j] = u[i+di, j+dj]."""
    n = M * M
    idx = np.arange(n)
    i, j = idx // M, idx % M
    src = ((i + di) % M) * M + (j + dj) % M
    return sp.csr_matrix((np.ones(n), (idx, src)), shape=(n, n))


def _operators(prob: Problem):
    M, h = prob.M, prob.h
    n = M * M
    I = sp.identity(n, format="csr")
    Sx = _shift_op(M, 1, 0)  # sample at i+1
    Sy = _shift_op(M, 0, 1)
    # u-point (i,j) sits on the x-edge between centres (i-1,j) and (i,j):
    # gradient Gx ρ |_u(i,j) = (ρ[i,j] − ρ[i−1,j])/h
    Gx = (I - Sx.T) / h
    Gy = (I - Sy.T) / h
    # 4-point Coriolis average of v at u-points (energy-conserving pair)
    Av = 0.25 * (I + Sx.T + Sy + Sx.T @ Sy)
    return I, Gx, Gy, Av


@dataclasses.dataclass
class System:
    A: object
    b: jnp.ndarray
    z0: jnp.ndarray
    omega: jnp.ndarray  # full-vector mass-integration weights (ρ block)
    Lfull: object  # energy matrix on the full vector (swe/swe.py:95-97)
    m0: jnp.ndarray
    e0: jnp.ndarray
    prob: Problem
    n0: int  # per-field dim (M²)
    A_csr: sp.csr_matrix = dataclasses.field(repr=False, default=None)

    def constraints(self):
        mass = QuadraticConstraint(M=None, v=self.omega, c=-self.m0, name="mass")
        energy = QuadraticConstraint(M=self.Lfull, v=None, c=-self.e0, name="energy")
        return [mass, energy]

    def compute_invariants(self, z: jnp.ndarray) -> dict:
        return {
            "mass": jnp.dot(self.omega, z),
            "energy": 0.5 * jnp.dot(z, self.Lfull @ z),
        }

    def step_update(self, z_prev: jnp.ndarray) -> "System":
        """Next-step system (device-side).  Since A = I/dt − S/2,
        b = (I/dt + S/2) z = 2z/dt − A z — one SpMV, no reassembly."""
        dt_step = self.prob.dt
        b = 2.0 * z_prev / dt_step - (self.A @ z_prev)
        return dataclasses.replace(
            self,
            b=b,
            z0=z_prev,
            m0=jnp.dot(self.omega, z_prev),
            e0=0.5 * jnp.dot(z_prev, self.Lfull @ z_prev),
        )


@dataclasses.dataclass(frozen=True)
class _EnergyDiag:
    """h²·diag(I, I, c²·I) as an operator (the reference's L matrix role)."""

    scales: tuple  # static: per-block scalar weights
    n0: int  # static: per-field dimension

    def __matmul__(self, x):
        parts = jnp.split(x, 3, axis=0)
        return jnp.concatenate([s * p for s, p in zip(self.scales, parts)], axis=0)

    def dd_matvec(self, x):
        """Double-f32 apply (constraints/quadratic.py::_dd_matvec protocol).

        Without this the dd machinery is bypassed for the swe energy
        constraint entirely — the endgame then enforces energy only to f32
        evaluation noise (~1e-4 absolute at M=512), which is exactly the
        round-3 sweep's 'deviations stuck at 1e-4'.  The scales are static
        Python floats, exactly split per scalar."""
        from ..ops import dd as _dd

        his = jnp.split(x.hi, 3, axis=-1)
        los = jnp.split(x.lo, 3, axis=-1)
        outs = [
            _dd.mul(_dd.from_f64_scalar(float(s)), _dd.DD(h, l))
            for s, h, l in zip(self.scales, his, los)
        ]
        return _dd.DD(
            jnp.concatenate([o.hi for o in outs], axis=-1),
            jnp.concatenate([o.lo for o in outs], axis=-1),
        )

    def todense(self):
        diag = np.concatenate([np.full(self.n0, s) for s in self.scales])
        return jnp.asarray(np.diag(diag))


import jax.tree_util as _tu

_tu.register_pytree_node(
    _EnergyDiag,
    lambda o: ((), (o.scales, o.n0)),
    lambda aux, ch: _EnergyDiag(aux[0], aux[1]),
)


def linforms(
    N: int = 100,
    M: int = 50,
    degree: int = 1,
    T: float = 10.0,
    zinit: Optional[np.ndarray] = None,
    dtype=None,
) -> System:
    dtype = dtype or default_dtype()
    prob = Problem(N=N, M=M, degree=degree, T=float(T))
    h, c, f, dt_step = prob.h, prob.c, prob.f, prob.dt
    n0 = M * M

    I, Gx, Gy, Av = _operators(prob)
    Z = sp.csr_matrix((n0, n0))
    # z_t = S z with skew-symmetric (in the energy product) S
    S = sp.bmat(
        [
            [Z, f * Av, -(c**2) * Gx],
            [-f * Av.T, Z, -(c**2) * Gy],
            [Gx.T, Gy.T, Z],
        ],
        format="csr",
    )
    A_csr = sp.csr_matrix(sp.identity(3 * n0) / dt_step - 0.5 * S)

    if zinit is None:
        idx = np.arange(n0)
        xc = (idx // M + 0.5) * h
        yc = (idx % M + 0.5) * h
        rho0 = prob.ic_rho(xc, yc)
        z0 = np.concatenate([np.zeros(n0), np.zeros(n0), rho0])
    else:
        z0 = np.asarray(zinit)

    b = z0 / dt_step + 0.5 * (S @ z0)

    omega = np.concatenate([np.zeros(2 * n0), np.full(n0, h * h)])
    m0 = omega @ z0
    Lfull = _EnergyDiag((h * h, h * h, h * h * c * c), n0)
    e0 = 0.5 * z0 @ (np.concatenate([h * h * z0[:n0], h * h * z0[n0 : 2 * n0], h * h * c * c * z0[2 * n0 :]]))

    return System(
        A=maybe_stencil(from_scipy(A_csr, dtype=dtype)),
        b=jnp.asarray(b, dtype),
        z0=jnp.asarray(z0, dtype),
        omega=jnp.asarray(omega, dtype),
        Lfull=Lfull,
        m0=jnp.asarray(m0, dtype),
        e0=jnp.asarray(e0, dtype),
        prob=prob,
        n0=n0,
        A_csr=A_csr,
    )
