"""End-to-end demo: all four reference problems, GMRES vs CGMRES.

Run: python examples/demo.py   (GPU, or JAX_PLATFORMS=cpu; ~1 min on CPU)
"""

import sys

sys.path.insert(0, ".")

import jax.numpy as jnp
import numpy as np

from structurepreservingiterativesolvers_tpu import models, precond, solvers


def show(label, system, k, tol, pre=None):
    from structurepreservingiterativesolvers_tpu.experiments.wrappers import (
        reduction_mode,
    )

    xg, gi = solvers.gmres(system.A, system.b, k=k, tol=tol, pre=pre)
    # reduction_mode keeps the in-loop arithmetic compatible with the
    # tolerance (high-invariant-scale problems need the dd reduction)
    xc, ci = solvers.cgmres(system.A, system.b, k=k, tol=tol,
                            constraints=system.constraints(), pre=pre,
                            **reduction_mode(system, tol))
    # deviations through the dd/f64 certificate path: a plain f32
    # compute_invariants carries evaluation noise orders above the real
    # deviations and would print noise as "drift"
    from structurepreservingiterativesolvers_tpu.experiments.timed_solve import (
        certified_deviations,
    )

    dg, dc = certified_deviations(system, xg), certified_deviations(system, xc)
    print(f"\n=== {label} (n={system.b.shape[0]}) ===")
    print(f"  gmres : steps {gi['steps']:3d}  res {gi['res'][-1]:.2e}")
    print(f"  cgmres: steps {ci['steps']:3d}  res {ci['res'][-1]:.2e}  "
          f"safety={ci['safety']}")
    for name in dg:
        gain = dg[name] / max(dc[name], 1e-16)
        print(f"  {name:9s} |deviation|: gmres {dg[name]:.2e}   "
              f"cgmres {dc[name]:.2e}   gain {gain:.3g}x")


def main():
    show("1D linear KdV (DG3)", models.lkdv.linforms(M=100, degree=3), k=50, tol=1e-6)

    rk = models.lkdvrk.linforms(N=10, M=50, degree=3, tstages=2, T=1.0)
    show("1D linear KdV, 2-stage Gauss-Legendre", rk, k=60, tol=1e-6,
         pre=models.lkdvrk.element_block_preconditioner(rk))

    heat = models.heat.linforms(M=64)
    show("2D heat (P1)", heat, k=30, tol=1e-7,
         pre=precond.chebyshev(heat.A, degree=8))

    import numpy as np

    swe = models.swe.linforms(M=32)
    # shifted-skew polynomial inverse (the swe pairing) + rhs-relative tol:
    # the absolute 1e-7 sits below the f32-attainable floor at this scale
    show("2D rotating shallow water (C-grid)", swe, k=20,
         tol=4e-7 * float(np.linalg.norm(np.asarray(swe.b))),
         pre=precond.skew_normal_chebyshev(swe.A, a=1.0 / swe.prob.dt))


if __name__ == "__main__":
    main()
