"""Benchmark driver: prints ONE JSON line of heat-problem measurements.

Headline: SpMV throughput (nnz/s) of the production operator on the heat
problem, the op that dominates every Krylov iteration (reference hot loop:
``A @ z`` in solvers.py:95,191,370).  Reported beside it: the explicit DIA
roll chain, scipy CSR SpMV on the host CPU (``vs_baseline`` — the engine the
reference actually runs on), CGMRES time-to-solution, the device AMG setup,
the preconditioned iteration time, the CGMRES/GMRES core ratio and the
certified conservation gains (the reference's quality bar,
heat/TimedSolve.py:75-80).

Runs on the default JAX accelerator and refuses the CPU: a number taken on
the host is not a device measurement.  The output names the device (JAX
platform, kind, count) and the card's power limit.

    python bench.py
"""

from __future__ import annotations

import json
import sys

import numpy as np


def main() -> int:
    import jax
    import jax.numpy as jnp
    from jax import lax

    from structurepreservingiterativesolvers_tpu import config
    from structurepreservingiterativesolvers_tpu.experiments.timed_solve import (
        certified_deviations,
        chained_core_times,
    )
    from structurepreservingiterativesolvers_tpu.models import heat
    from structurepreservingiterativesolvers_tpu.ops.stencil import Stencil, as_dia
    from structurepreservingiterativesolvers_tpu.precond.amg import amg
    from structurepreservingiterativesolvers_tpu.solvers import cgmres, gmres
    from structurepreservingiterativesolvers_tpu.solvers.cgmres import (
        _build_core,
        _build_phase1,
    )
    from structurepreservingiterativesolvers_tpu.solvers.hostio import dscalar
    from structurepreservingiterativesolvers_tpu.utils.profiling import (
        gpu_name_power_limit,
        median_time,
    )

    dev = jax.devices()[0]
    if dev.platform == "cpu":
        print("bench.py: JAX found no accelerator; refusing to report CPU "
              "times as device numbers", file=sys.stderr)
        return 2
    config.enable_compile_cache()

    M = 1024
    sys_ = heat.linforms(M=M, N=100)
    A, b = sys_.A, sys_.b
    A_dia = as_dia(A)
    nnz = sys_.A_csr.nnz
    n_rows = b.shape[0]
    x = jnp.asarray(np.random.default_rng(0).standard_normal(n_rows), b.dtype)

    # 1000 dependent SpMVs in one program: each feeds the next, so nothing
    # can be elided and per-dispatch overhead is amortised away
    reps = 1000

    def spmv_time(A_op):
        chain = jax.jit(lambda v: lax.fori_loop(
            0, reps, lambda i, w: A_op @ (w / (i + 1.0)), v))
        return median_time(lambda: chain(x)) / reps

    t_dia = spmv_time(A_dia)
    t_prod = spmv_time(A)

    xh = np.asarray(x, dtype=np.float64)
    Ah = sys_.A_csr
    t_host = median_time(lambda: Ah @ xh, reps=5, warmup=3)

    # CGMRES time-to-solution at fixed invariant quality, AMG-preconditioned
    # (the reference's TimedSolve pairs heat with Ruge–Stüben): REPS
    # dependent full solves in one program give the per-solve device time
    M2 = 256
    s2 = heat.linforms(M=M2, N=100)
    cons = tuple(s2.constraints())
    pre = amg(s2.A_csr, dtype=b.dtype, grid=(M2 + 1, M2 + 1))
    xg, _ = gmres(s2.A, s2.b, k=40, tol=1e-6, pre=pre)
    dt2 = s2.b.dtype
    f32 = dt2 == jnp.float32
    core = _build_core(40, len(cons), None, False, False, f32,
                       ("q",) * len(cons), "cgs2", True, "while", f32, f32)
    tol_d, contol_d, ctol_d = (dscalar(v, dt2) for v in (1e-6, 10.0, 1e-12))
    cg_reps = 5

    @jax.jit
    def cg_chain(b2):
        def body(i, acc):
            out = core(s2.A, b2 * (1.0 + 1e-12 * acc[0]), None, cons,
                       tol_d, contol_d, ctol_d, pre)
            return out.x.astype(b2.dtype)
        return lax.fori_loop(0, cg_reps, body, jnp.zeros_like(b2))

    t_cg = median_time(lambda: cg_chain(s2.b), reps=3) / cg_reps

    # preconditioned-iteration throughput at the headline size: the lean
    # phase-1 GMRES loop (AMG apply + SpMV + CGS2 + Givens + true residual)
    amg(A, dtype=b.dtype, grid=(M + 1, M + 1))  # compile the setup program
    amg_setup_s = median_time(
        lambda: amg(A, dtype=b.dtype, grid=(M + 1, M + 1)).coarse_inv,
        reps=1, warmup=0)
    pre_big = amg(A, dtype=b.dtype, grid=(M + 1, M + 1))
    kp = 20
    p1 = _build_phase1(kp, None, "cgs2", True)
    tolp, contolp = dscalar(1e-7, b.dtype), dscalar(10.0, b.dtype)
    _, j1, _ = p1(A, b, None, tolp, contolp, pre_big)
    j1h = max(int(j1), 1)
    p1_reps = 5

    @jax.jit
    def p1_chain(b2):
        def body(i, acc):
            _, _, r = p1(A, b2 * (1.0 + 1e-12 * acc), None, tolp, contolp,
                         pre_big)
            return acc + 1e-20 * r.astype(acc.dtype)
        return lax.fori_loop(0, p1_reps, body, jnp.zeros((), b2.dtype))

    t_p1 = median_time(lambda: p1_chain(b), reps=3) / p1_reps

    t_g_core, t_c_core = chained_core_times(sys_, pre_big, kp, 1e-7)
    xc, ci = cgmres(s2.A, s2.b, k=40, tol=1e-6, constraints=cons, pre=pre)
    dg = certified_deviations(s2, xg)
    dc = certified_deviations(s2, xc)

    out = {
        "metric": "spmv_nnz_per_s",
        "value": nnz / t_prod,
        "unit": "nnz/s",
        "vs_baseline": t_host / t_prod,
        "extra": {
            "device": {"platform": dev.platform, "kind": dev.device_kind,
                       "count": len(jax.devices())},
            "gpu_name_power_limit": gpu_name_power_limit(),
            "dtype": str(b.dtype),
            "n": int(n_rows),
            "nnz": int(nnz),
            "production_operator": type(A).__name__,
            "spmv_time_production_s": t_prod,
            "spmv_time_dia_s": t_dia,
            "spmv_bytes_production": int(
                (2 * n_rows + (A.corr_elements if isinstance(A, Stencil)
                               else 0)) * b.dtype.itemsize),
            "host_scipy_nnz_per_s": nnz / t_host,
            "cgmres_tts_s": t_cg,
            "amg_setup_s": amg_setup_s,
            "cgmres_over_gmres_core": t_c_core / t_g_core,
            "gmres_core_s": t_g_core,
            "cgmres_core_s": t_c_core,
            "preconditioned_iter_s": t_p1 / j1h,
            "preconditioned_iters_measured": j1h,
            "cgmres_steps": ci["steps"],
            "cgmres_safety": ci["safety"],
            "cgmres_deviation": ci["deviation"],
            "conservation_gain_mass": dg["mass"] / max(dc["mass"], 1e-16),
            "conservation_gain_energy": dg["energy"] / max(dc["energy"], 1e-16),
        },
    }
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
