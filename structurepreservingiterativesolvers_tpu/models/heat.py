"""2-D heat equation test problem (u_t − Δu = 0, natural BC).

Capability parity with the reference problem module (reference
``heat/heat.py``): P1 on a structured unit-square triangulation, midpoint
step.  System (heat/heat.py:63-85):

    A = M/dt + ½K,     b = (M/dt − ½K) u0

Invariants (heat/heat.py:92-146, heat/LinearSolver.py:26-35):

* mass  ω·u  (conserved, Neumann BC);
* the *dissipation identity* — not a conservation law:
      ½u1ᵀMu1 − ½u0ᵀMu0 + dt·umidᵀK umid = 0
  expressed as the quadratic constraint with
      M_c = M + ½dt·K,  v = ½dt·K u0,  c = −(½u0ᵀMu0 − ¼dt·u0ᵀK u0).

Initial condition: the reference's 1e3-scaled polynomial bump
(heat/heat.py:30-32).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp

from ..config import default_dtype
from ..constraints.quadratic import MatComb, QuadraticConstraint
from ..ops.sparse import from_scipy
from ..ops.stencil import maybe_stencil
from .fem2d import SpaceP1


@dataclasses.dataclass
class Problem:
    N: int = 100
    M: int = 50
    degree: int = 1
    T: float = 10.0

    @property
    def dt(self) -> float:
        return float(self.T) / self.N

    def fem(self) -> SpaceP1:
        if self.degree == 1:
            return SpaceP1(self.M, 1.0)
        if self.degree == 2:
            from .fem2d import SpaceP2

            return SpaceP2(self.M, 1.0)
        raise NotImplementedError("degrees 1 and 2 supported")

    def ic(self, x, y):
        """1e3-scaled polynomial bump (heat/heat.py:30-32)."""
        return 1e3 * ((x * (x - 1.0)) ** 5 + (y * (y - 1.0)) ** 6)


@dataclasses.dataclass
class System:
    A: object
    b: jnp.ndarray
    z0: jnp.ndarray
    Mmat: object
    Lmat: object  # stiffness (the reference's L, heat/heat.py:86-90)
    Lz0: jnp.ndarray
    omega: jnp.ndarray
    m0: jnp.ndarray
    e0: jnp.ndarray
    old_energy: jnp.ndarray
    prob: Problem
    A_csr: sp.csr_matrix = dataclasses.field(repr=False, default=None)
    # energy-constraint matrix M + ½dt·K pre-combined at assembly (see
    # ``constraints``); None falls back to the MatComb form
    Emat: object = None

    def constraints(self):
        dt = self.prob.dt
        mass = QuadraticConstraint(M=None, v=self.omega, c=-self.m0, name="mass")
        # M + ½dt·K pre-combined at assembly (host f64, exact): M and K share
        # the sparsity pattern, so the combined DIA HALVES every dd SpMV/SpMM
        # in the constraint catch-up and increments vs a MatComb of the two
        # (the catch-up is the dominant constrained-phase cost)
        Mc = self.Emat if self.Emat is not None else MatComb(
            (1.0, 0.5 * dt), (self.Mmat, self.Lmat))
        energy = QuadraticConstraint(
            M=Mc,
            v=0.5 * dt * self.Lz0,
            c=-self.old_energy,
            name="energy",
        )
        return [mass, energy]

    def compute_invariants(self, z: jnp.ndarray, zold: Optional[jnp.ndarray] = None) -> dict:
        zold = self.z0 if zold is None else zold
        zmid = 0.5 * (z + zold)
        mass = jnp.dot(self.omega, z)
        energy = (
            0.5 * jnp.dot(z, self.Mmat @ z)
            - 0.5 * jnp.dot(zold, self.Mmat @ zold)
            + self.prob.dt * jnp.dot(zmid, self.Lmat @ zmid)
        )
        return {"mass": mass, "energy": energy}

    def step_update(self, z_prev: jnp.ndarray) -> "System":
        """Next-step system from a previous solution (device-side; replaces
        per-step Firedrake reassembly)."""
        dt_step = self.prob.dt
        u0 = z_prev
        Lz0 = self.Lmat @ u0
        Mu0 = self.Mmat @ u0
        return dataclasses.replace(
            self,
            b=Mu0 / dt_step - 0.5 * Lz0,
            z0=u0,
            Lz0=Lz0,
            m0=jnp.dot(self.omega, u0),
            old_energy=0.5 * jnp.dot(u0, Mu0) - 0.25 * dt_step * jnp.dot(u0, Lz0),
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
    fem = prob.fem()
    dt_step = prob.dt

    Mh = fem.mass()
    Kh = fem.stiffness()
    omega_h = fem.omega()

    if zinit is None:
        u0 = fem.project(prob.ic)
    else:
        u0 = np.asarray(zinit)

    A_csr = sp.csr_matrix(Mh / dt_step + 0.5 * Kh)
    b = (Mh @ u0) / dt_step - 0.5 * (Kh @ u0)

    Lz0 = Kh @ u0
    old_energy = 0.5 * u0 @ (Mh @ u0) - 0.25 * dt_step * u0 @ Lz0
    m0 = omega_h @ u0

    return System(
        A=maybe_stencil(from_scipy(A_csr, dtype=dtype)),
        b=jnp.asarray(b, dtype),
        z0=jnp.asarray(u0, dtype),
        Mmat=from_scipy(Mh, dtype=dtype),
        Lmat=from_scipy(Kh, dtype=dtype),
        Emat=from_scipy(sp.csr_matrix(Mh + 0.5 * dt_step * Kh), dtype=dtype),
        Lz0=jnp.asarray(Lz0, dtype),
        omega=jnp.asarray(omega_h, dtype),
        m0=jnp.asarray(m0, dtype),
        e0=jnp.asarray(0.0, dtype),
        old_energy=jnp.asarray(old_energy, dtype),
        prob=prob,
        A_csr=A_csr,
    )
