"""structurepreservingiterativesolvers_tpu — a structure-preserving Krylov
solver framework in JAX, running on GPUs (and on the CPU for tests).

A from-scratch JAX/XLA re-design of the capability set of
``JamesJackaman/StructurePreservingIterativeSolvers`` (reference repo: CGMRES —
constraint-satisfying flexible GMRES for structure-preserving FEM
discretisations; see reference ``solvers.py``).  Nothing here is a port: the
compute path is jit-compiled, fixed-shape, scan-based device code; sparse
matrices live in gather-free device formats (DIA / ELL / BSR); the constrained
least-squares endgame runs as an on-device KKT solver instead of SLSQP; and
distribution is expressed with ``jax.sharding`` meshes + collectives.

Quick start::

    import structurepreservingiterativesolvers_tpu as spis
    sys = spis.models.lkdv.linforms(M=50, degree=1)
    x, info = spis.solvers.cgmres(sys.A, sys.b, x0, k=20, tol=1e-8,
                                  constraints=sys.constraints())
"""

from . import config  # noqa: F401  (applies x64 default, must be first)
from . import ops
from . import solvers
from . import constraints
from . import precond
from . import models
from . import parallel
from . import experiments
from . import utils

__version__ = "0.1.0"

__all__ = [
    "config",
    "ops",
    "solvers",
    "constraints",
    "precond",
    "models",
    "parallel",
    "experiments",
    "utils",
]
