"""Discrete invariant projection (constraints/projection.py): the returned
f32 iterate — not just the reduced coefficient model — must certify the
constraints.  Round-3 verdict: swe deviations were 'stuck at 1e-4' because
the f32 assembly re-introduced √n·eps32-scale deviations the KKT had
removed in reduced space."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from structurepreservingiterativesolvers_tpu.constraints import projection as P
from structurepreservingiterativesolvers_tpu.experiments.timed_solve import (
    certified_deviations,
)
from structurepreservingiterativesolvers_tpu.models import swe
from structurepreservingiterativesolvers_tpu.solvers import cgmres, gmres


@pytest.fixture(scope="module")
def swe32():
    return swe.linforms(M=64, dtype=jnp.float32)


def test_snap_reaches_near_ulp_deviation(swe32):
    """From a perturbed f32 point near the solution, snap must reduce the
    certified deviations by orders of magnitude, to ≲1e-11 of the invariant
    scale."""
    s = swe32
    x = s.z0 + jnp.asarray(
        np.random.default_rng(3).standard_normal(s.b.shape[0]) * 1e-4,
        jnp.float32,
    )
    cons = tuple(s.constraints())
    g0 = np.abs(np.asarray(P._deviations(cons, x)))
    x_sn, g_sn = jax.jit(lambda xx: P.snap(xx, cons))(x)
    g_sn = np.abs(np.asarray(g_sn))
    assert x_sn.dtype == jnp.float32
    assert (g_sn <= g0).all()
    scale = max(abs(float(s.e0)), abs(float(s.m0)))
    assert g_sn.max() < 1e-11 * scale
    # the certified values must MATCH an independent dd evaluation
    dev = certified_deviations(s, x_sn)
    np.testing.assert_allclose(
        sorted(dev.values()), sorted(g_sn), rtol=1e-6, atol=1e-12)
    # and the displacement is roundoff-sized, not a solution change
    assert float(jnp.linalg.norm(x_sn - x)) < 1e-2 * float(jnp.linalg.norm(x))


def test_snap_rejects_degenerate_updates(swe32):
    """With an already-feasible iterate the guard keeps x unchanged-or-better
    (never worse), even when candidate steps are pure noise."""
    s = swe32
    cons = tuple(s.constraints())
    x = s.z0
    g0 = np.abs(np.asarray(P._deviations(cons, x))).max()
    _, g = P.snap(x, cons)
    assert np.abs(np.asarray(g)).max() <= g0 + 1e-30


def test_cgmres_f32_deviation_field_is_assembled_truth(swe32):
    """info['deviation'] must equal the dd-certified deviation of the
    RETURNED x (the round-3 sweep reported the reduced-space 1e-12 proxy
    while the returned iterate sat at 1e-3)."""
    from structurepreservingiterativesolvers_tpu import precond

    s = swe32
    pre = precond.skew_normal_chebyshev(s.A, a=1.0 / s.prob.dt)
    tol = 4e-7 * float(np.linalg.norm(np.asarray(s.b)))
    x, info = cgmres(s.A, s.b, k=20, tol=tol, constraints=s.constraints(),
                     pre=pre)
    assert info["safety"] is True
    dev = certified_deviations(s, x)
    assert max(dev.values()) == pytest.approx(info["deviation"], rel=1e-5)
    scale = max(abs(float(s.e0)), 1.0)
    assert info["deviation"] < 1e-10 * scale


def test_swe_gain_over_gmres_at_scale(swe32):
    """The reference's conservation-gain bar (≥2×, heat/TimedSolve.py:75-80)
    must pass with orders of margin on swe once the endgame + snap run."""
    from structurepreservingiterativesolvers_tpu import precond

    s = swe32
    pre = precond.skew_normal_chebyshev(s.A, a=1.0 / s.prob.dt)
    tol = 4e-7 * float(np.linalg.norm(np.asarray(s.b)))
    xg, _ = gmres(s.A, s.b, k=20, tol=tol, pre=pre)
    xc, ic = cgmres(s.A, s.b, k=20, tol=tol, constraints=s.constraints(),
                    pre=pre)
    dg = certified_deviations(s, xg)
    dc = certified_deviations(s, xc)
    for nm in dg:
        assert dg[nm] / max(dc[nm], 1e-16) > 100.0, nm


def test_first_import_inside_jit_trace():
    """The solver imports this module lazily inside its jitted core, so its
    module-level constants must not be created under a trace: a jnp array
    built there would leak as a tracer into every later use."""
    import os
    import subprocess
    import sys

    code = """
import sys
import jax, jax.numpy as jnp
import structurepreservingiterativesolvers_tpu  # noqa: F401
name = "structurepreservingiterativesolvers_tpu.constraints.projection"
assert name not in sys.modules

@jax.jit
def first(x):
    from structurepreservingiterativesolvers_tpu.constraints import projection
    return x * jnp.asarray(projection._TAUS)[1]

assert float(first(2.0)) == 1.0
from structurepreservingiterativesolvers_tpu.constraints import projection
assert float(jax.jit(lambda x: x * jnp.asarray(projection._TAUS)[2])(4.0)) == 1.0
print("ok")
"""
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300,
                       env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr[-2000:]
