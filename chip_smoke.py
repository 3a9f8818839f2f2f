"""Smoke run of the solver on a GPU: the main path, end to end, at the
reference's full problem sizes, every result checked against the host.

    python chip_smoke.py               # one GPU: phases 1-6
    python chip_smoke.py --chips 4     # only the row-sharded solve on 4 GPUs,
                                       # compared with the same solve on one

It goes through the entry points a user calls (``models.*.linforms``,
``experiments.wrappers``, ``experiments.timed_solve.time_cgmres``,
``experiments.evolve``) in one process, so one JAX process holds the card(s).
Phases (sizes: BASELINE.md, the reference's largest):

1. heat f64 M=2048 (n=4,198,401): structured AMG, stencil SpMV, KKT endgame.
2. swe f64 M=512 (n=786,432), skew-normal Chebyshev, rhs-relative and
   absolute tolerance.
3. lkdvRK f64 M=400, s=2: five ``evolve`` steps with the RAS+Neumann
   composite; per-step invariant drift checked on the host.
4. GMRES / CGMRES vs scipy ``spsolve`` at heat M=256, swe M=128, lkdv M=50.
5. float32 storage, heat M=1024: Arnoldi-basis orthogonality (no TF32),
   certified deviation vs a host f64 evaluation, double-f32 identities.
6. Device times at heat M=2048 f64 of the stencil SpMV, one CGS2 step and a
   copy of the same bytes, each as a chain of dependent ops in one program.

Host checks run in float64 on JAX's CPU device or in scipy, independent of
the GPU's arithmetic.  Each phase prints one line of evidence; the last line
is ``{"ok": true, "device": {...}}``.  When JAX finds no GPU, or a phase
fails, the script exits non-zero and prints no such line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback

import numpy as np

# GMRES / CGMRES step counts of phase 4's solves on the CPU backend (same
# calls, f64, k=100); the GPU must agree within one step.  heat runs to k:
# its rhs-relative 1e-12 sits under the f64 residual floor.
CPU_STEPS = {("heat", 256): (100, 100), ("swe", 128): (4, 5),
             ("lkdv", 50): (18, 19)}


class SmokeFailure(Exception):
    """A result disagreed with its reference (raised, not asserted, so the
    checks also hold under ``python -O``)."""


def _check(ok, *detail) -> None:
    if not ok:
        raise SmokeFailure(detail)


def _log(msg: str) -> None:
    print(msg, flush=True)


def _cpu():
    import jax

    return jax.devices("cpu")[0]


def to_host(obj):
    """Copy of ``obj`` with every JAX array moved to the CPU device:
    dataclasses (models' ``System``s, operators, constraints) field by field,
    tuples/lists/dicts element by element."""
    import jax

    if isinstance(obj, jax.Array):
        return jax.device_put(obj, _cpu())
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: to_host(getattr(obj, f.name))
            for f in dataclasses.fields(obj) if f.init})
    if isinstance(obj, (list, tuple)) and not hasattr(obj, "_fields"):
        return type(obj)(to_host(o) for o in obj)
    if isinstance(obj, dict):
        return {k: to_host(v) for k, v in obj.items()}
    return obj


def _abs_operator(M):
    """|M| entrywise (an upper bound for operators stored as sums)."""
    import jax
    import jax.numpy as jnp

    from structurepreservingiterativesolvers_tpu.constraints.quadratic import (
        MatComb,
    )

    if isinstance(M, MatComb):
        return dataclasses.replace(
            M, coeffs=tuple(abs(c) for c in M.coeffs),
            mats=tuple(_abs_operator(A) for A in M.mats))
    return jax.tree_util.tree_map(
        lambda a: jnp.abs(a) if isinstance(a, jax.Array) else a, M)


def host_residual(system, x) -> tuple:
    """(‖b − A x‖, its rounding floor) in f64 with the host CSR matrix."""
    A = system.A_csr
    xh = np.asarray(x, np.float64)
    bh = np.asarray(system.b, np.float64)
    r = float(np.linalg.norm(bh - A @ xh))
    absA = abs(A)
    floor = 16 * np.finfo(np.float64).eps * float(
        np.linalg.norm(absA @ np.abs(xh) + np.abs(bh)))
    return r, floor


def host_deviations(system, x) -> dict:
    """Per invariant, on the CPU device in f64: ``dev``, the deviation from
    its target by the model's ``compute_invariants``; ``g``, the value of the
    constraint the solver certifies (for f32 systems the two differ by the
    f32 rounding of the stored matrices and targets); the constraint's |c|;
    ``floor``, 32·eps·(sum of the magnitudes of its terms) — the same floor
    formula as the solver's safety latch — and ``dd_floor``, the double-f32
    unit roundoff 2⁻⁴⁸ times that sum, the resolution of the f32 path's
    certificate."""
    import jax
    import jax.numpy as jnp

    from structurepreservingiterativesolvers_tpu.constraints.quadratic import (
        QuadraticConstraint,
    )
    from structurepreservingiterativesolvers_tpu.experiments.report import (
        _targets,
    )

    def f64(tree):
        return jax.tree_util.tree_map(
            lambda a: a.astype(jnp.float64) if isinstance(a, jax.Array)
            and jnp.issubdtype(a.dtype, jnp.floating) else a, tree)

    sh = f64(to_host(system))
    out = {}
    with jax.default_device(_cpu()):
        xh = jnp.asarray(np.asarray(x, np.float64))
        inv = sh.compute_invariants(xh)
        targets = _targets(sh, list(inv))
        for con in sh.constraints():
            con = f64(con)
            absc = QuadraticConstraint(
                M=None if con.M is None else _abs_operator(con.M),
                v=None if con.v is None else jnp.abs(con.v),
                c=jnp.abs(con.c), name=con.name)
            scale = float(absc(jnp.abs(xh)))
            out[con.name] = {
                "dev": abs(float(inv[con.name]) - targets[con.name]),
                "g": abs(float(con(xh))),
                "c": abs(float(con.c)),
                "floor": 32 * float(np.finfo(np.float64).eps) * scale,
                "dd_floor": 2.0 ** -48 * scale,
            }
    return out


def _check_certificate(system, x, safety) -> str:
    devs = host_deviations(system, x)
    if safety:
        for nm, d in devs.items():
            bound = max(1e-12 * max(1.0, d["c"]), d["floor"])
            _check(d["dev"] <= bound, nm, d, bound)
    return " ".join(f"{nm}_dev={d['dev']:.3e}" for nm, d in devs.items())


def _check_residual(system, x, res_reported) -> str:
    r, floor = host_residual(system, x)
    diff = abs(r - res_reported)
    _check(diff <= max(1e-6 * r, floor), r, res_reported, floor)
    return (f"res_host={r:.6e} res_solver={res_reported:.6e} "
            f"res_floor={floor:.1e}")


def _timed_row(problem, M, tol, k, tol_mode="abs"):
    from structurepreservingiterativesolvers_tpu.experiments.timed_solve import (
        time_cgmres,
    )

    out = time_cgmres(problem=problem, M=M, tol=tol, k=k, tol_mode=tol_mode)
    system, x = out["system"], out["x"]
    checks = _check_residual(system, x, out["res_final"])
    checks += " " + _check_certificate(system, x, out["safety"])
    return (f"M={M} n={system.b.shape[0]} dtype={system.b.dtype} "
            f"tol={out['tol_effective']:.3e} steps={out['steps']} "
            f"constrained_steps={out['constrained_steps']} "
            f"gmres_steps={out['gmres_steps']} safety={out['safety']} "
            f"time_gmres_s={out['time_gmres']:.4f} "
            f"time_cgmres_s={out['runtime']:.4f} "
            f"time_pre_s={out['time_pre']:.4f} "
            f"compile_s={out['compile_time']:.2f} {checks}")


def _peak_bytes() -> str:
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return f"peak_bytes_in_use={stats.get('peak_bytes_in_use', 'n/a')}"


def phase_heat(M=2048, tol=1e-7, k=20) -> str:
    """heat f64 through TimedSolve's row: AMG + stencil + KKT endgame."""
    return f"heat {_timed_row('heat', M, tol, k)} {_peak_bytes()}"


def phase_swe(M=512, k=20) -> str:
    """swe f64, default preconditioner, rhs-relative and absolute tol."""
    rhs = _timed_row("swe", M, 1e-7, k, tol_mode="rhs")
    ab = _timed_row("swe", M, 1e-9, k)
    return f"swe rhs-mode: {rhs} | abs-mode: {ab} {_peak_bytes()}"


def phase_lkdvrk(M=400, N=5, degree=3, tstages=2, tol=1e-7, k=50) -> str:
    """lkdvRK f64 evolution with the RAS+Neumann composite; the invariant
    drift of every step is re-evaluated on the host in f64."""
    import jax
    import jax.numpy as jnp

    from structurepreservingiterativesolvers_tpu.experiments import wrappers
    from structurepreservingiterativesolvers_tpu.experiments.evolve import evolve
    from structurepreservingiterativesolvers_tpu.experiments.report import (
        _targets,
    )
    from structurepreservingiterativesolvers_tpu.experiments.timed_solve import (
        default_pre_builder,
    )
    from structurepreservingiterativesolvers_tpu.models import lkdvrk

    params = dict(N=N, M=M, degree=degree, tstages=tstages, T=0.1 * N)
    pre = default_pre_builder("lkdvrk")(lkdvrk.linforms(**params))
    record = []

    def solver(system, x0=None, k=k, tol=tol, pre=None):
        x, info = wrappers.cgmres_wrapper(system, x0=x0, k=k, tol=tol, pre=pre)
        record.append((to_host(system), np.asarray(x), info))
        return x, info

    t0 = time.perf_counter()
    out = evolve("lkdvrk", k=k, tol=tol, solver=solver, pre=pre, **params)
    wall = time.perf_counter() - t0
    sys0 = record[0][0]
    names = [nm for nm in ("mass", "momentum", "energy") if nm in out]
    targets = _targets(sys0, names)
    worst = 0.0
    with jax.default_device(_cpu()):
        for i, (sysh, xh, info) in enumerate(record):
            _check(info["safety"] is True, i, info["safety"])
            inv = sysh.compute_invariants(jnp.asarray(xh, jnp.float64))
            for nm in names:
                drift = abs(float(inv[nm]) - targets[nm])
                bound = 1e-10 * max(1.0, abs(targets[nm]))
                _check(drift <= bound, i, nm, drift, bound)
                # the device's own drift series agrees with the host's
                _check(abs(out[nm][i + 1] - float(inv[nm])) <= bound,
                       i, nm, out[nm][i + 1], float(inv[nm]))
                worst = max(worst, drift / max(1.0, abs(targets[nm])))
    steps = [r[2]["steps"] for r in record]
    return (f"lkdvRK M={M} degree={degree} s={tstages} n={sys0.b.shape[0]} "
            f"evolve_steps={len(record)} solver_steps={steps} "
            f"wall_s={wall:.3f} max_rel_drift_host={worst:.3e} "
            f"{_peak_bytes()}")


PARITY_CASES = (("heat", 256), ("swe", 128), ("lkdv", 50))


def phase_parity(cases=PARITY_CASES, k=100, rtol=1e-12) -> str:
    """GMRES / CGMRES vs a host direct solve; step counts vs the CPU's."""
    from structurepreservingiterativesolvers_tpu.experiments import wrappers
    from structurepreservingiterativesolvers_tpu.experiments.single_solve import (
        get_model,
    )
    from structurepreservingiterativesolvers_tpu.experiments.timed_solve import (
        default_pre_builder,
    )

    parts = []
    for problem, M in cases:
        system = get_model(problem).linforms(M=M)
        pre = default_pre_builder(problem)(system)
        tol = rtol * float(np.linalg.norm(np.asarray(system.b)))
        x_dir = np.asarray(wrappers.exact(system)[0], np.float64)
        xg, ig = wrappers.gmres_wrapper(system, k=k, tol=tol, pre=pre)
        xc, ic = wrappers.cgmres_wrapper(system, k=k, tol=tol, pre=pre)
        errs = []
        for x in (xg, xc):
            e = (np.linalg.norm(np.asarray(x, np.float64) - x_dir)
                 / np.linalg.norm(x_dir))
            _check(e <= 1e-8, problem, M, e)
            errs.append(e)
        steps = (ig["steps"], ic["steps"])
        ref = CPU_STEPS.get((problem, M))
        if ref is not None:
            _check(all(abs(a - b) <= 1 for a, b in zip(steps, ref)),
                   problem, M, steps, ref)
        parts.append(f"{problem} M={M}: gmres steps={steps[0]} "
                     f"err={errs[0]:.2e}, cgmres steps={steps[1]} "
                     f"err={errs[1]:.2e} safety={ic['safety']} "
                     f"(cpu steps {ref})")
    return "parity " + "; ".join(parts)


def phase_f32(M=1024, k=20, tol=1e-7) -> str:
    """float32 storage: basis orthogonality, certified deviation vs host
    f64, and the double-f32 error-free transforms on the device."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    from structurepreservingiterativesolvers_tpu.experiments import wrappers
    from structurepreservingiterativesolvers_tpu.experiments.timed_solve import (
        default_pre_builder,
    )
    from structurepreservingiterativesolvers_tpu.models import heat
    from structurepreservingiterativesolvers_tpu.ops import dd
    from structurepreservingiterativesolvers_tpu.precond.base import (
        apply_preconditioner,
    )
    from structurepreservingiterativesolvers_tpu.solvers.arnoldi import (
        arnoldi_step,
        init_state,
    )

    system = heat.linforms(M=M, dtype=jnp.float32)
    pre = default_pre_builder("heat")(system)

    @jax.jit
    def basis(A, b, pre):
        beta = jnp.linalg.norm(b)
        st = init_state(b, beta, k)

        def body(j, carry):
            st, hs = carry
            st, h = arnoldi_step(A, lambda v: apply_preconditioner(pre, v),
                                 st, j)
            return st, hs.at[j].set(h)

        st, hs = lax.fori_loop(0, k, body, (st, jnp.zeros(k, b.dtype)))
        return st.Q, hs

    Q, hs = jax.device_get(basis(system.A, system.b, pre))
    live = 1 + int(np.argmax(np.append(hs <= 0, True)))  # rows built
    Q = np.asarray(Q[:live], np.float64)
    ortho = float(np.max(np.abs(Q @ Q.T - np.eye(live))))
    _check(ortho <= 1e-5, ortho)

    x, info = wrappers.cgmres_wrapper(system, k=k, tol=tol, pre=pre)
    devs = host_deviations(system, x)
    dev_host = max(d["g"] for d in devs.values())
    dd_floor = max(d["dd_floor"] for d in devs.values())
    diff = abs(info["deviation"] - dev_host)
    rel = diff / max(dev_host, 1e-300)
    # relative agreement, or agreement to the dd evaluation's own roundoff
    # when the certified deviation sits at that floor
    _check(diff <= max(1e-3 * dev_host, dd_floor),
           info["deviation"], dev_host, dd_floor)

    rng = np.random.default_rng(0)
    a = (rng.standard_normal(1 << 20) * 1e6).astype(np.float32)
    b = (rng.standard_normal(1 << 20) * 1e-3).astype(np.float32)
    s, e = jax.device_get(jax.jit(dd.two_sum)(a, b))
    _check(np.array_equal(s.astype(np.float64) + e,
                          a.astype(np.float64) + b), "two_sum")
    b = rng.standard_normal(1 << 20).astype(np.float32)
    p, e = jax.device_get(jax.jit(dd.two_prod)(a, b))
    _check(np.array_equal(p.astype(np.float64) + e,
                          a.astype(np.float64) * b), "two_prod")
    return (f"f32 heat M={M} n={system.b.shape[0]}: basis rows={live} "
            f"max|QQ^T-I|={ortho:.2e}; cgmres steps={info['steps']} "
            f"safety={info['safety']} deviation={info['deviation']:.6e} "
            f"host_f64={dev_host:.6e} rel_diff={rel:.2e} "
            f"dd_floor={dd_floor:.1e}; "
            f"dd two_sum/two_prod exact on 2^20 pairs")


def phase_kernels(M=2048, k=20, reps=200, big=1 << 26) -> str:
    """Per-op device time of the stencil SpMV, one CGS2 step and a copy of
    the same bytes, each as ``reps`` dependent ops in one program; plus a
    copy of ``big`` elements (512 MiB in f64, far beyond the L2 cache)."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    from structurepreservingiterativesolvers_tpu.models import heat
    from structurepreservingiterativesolvers_tpu.ops.stencil import (
        Stencil,
        as_dia,
    )
    from structurepreservingiterativesolvers_tpu.solvers.arnoldi import _cgs2
    from structurepreservingiterativesolvers_tpu.utils.profiling import (
        median_time,
    )

    system = heat.linforms(M=M)
    A = system.A
    n = system.b.shape[0]
    item = system.b.dtype.itemsize
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal(n), system.b.dtype)
    Q = jnp.asarray(rng.standard_normal((k + 1, n)) / np.sqrt(n),
                    system.b.dtype)

    def per_op(step, v0, *ops):
        chain = jax.jit(lambda v, *o: lax.fori_loop(
            0, reps, lambda i, w: step(w, *o), v))
        return median_time(lambda: chain(v0, *ops)) / reps

    # scaled by 1/‖A‖∞ so the chained iterates stay O(1)
    scale = 1.0 / float(jnp.max(jnp.sum(jnp.abs(as_dia(A).data), axis=0)))
    t_spmv = per_op(lambda w, A: A @ w * scale, x, A)
    t_cgs2 = per_op(lambda w, Q: 0.5 * (_cgs2(Q, w, k)[0] + w), x, Q)
    t_copy = per_op(lambda w: w * 0.999, x)
    t_copy_big = per_op(lambda w: w * 0.999,
                        jnp.ones((big,), system.b.dtype))
    corr = A.corr_elements if isinstance(A, Stencil) else 0
    b_spmv = (2 * n + corr) * item
    b_cgs2 = 4 * (k + 1) * n * item
    b_copy = 2 * n * item
    b_copy_big = 2 * big * item
    bw = b_copy / t_copy
    bw_big = b_copy_big / t_copy_big
    return (f"kernels heat M={M} n={n} f64 ({type(A).__name__}), {reps} "
            f"chained ops: spmv {t_spmv * 1e6:.2f} us ({b_spmv} B, "
            f"{b_spmv / t_spmv / 1e9:.1f} GB/s, share of copy "
            f"{b_spmv / t_spmv / bw:.3f}); cgs2 k={k} {t_cgs2 * 1e6:.2f} us "
            f"({b_cgs2} B, {b_cgs2 / t_cgs2 / 1e9:.1f} GB/s, share of copy "
            f"{b_cgs2 / t_cgs2 / bw:.3f}); copy {t_copy * 1e6:.2f} us "
            f"({b_copy} B, {bw / 1e9:.1f} GB/s); copy of {b_copy_big} B "
            f"{bw_big / 1e9:.1f} GB/s")


def phase_sharded(M=2047, k=20, tol=1e-7, n_devices=4) -> str:
    """Row-sharded AMG-preconditioned CGMRES on ``n_devices`` vs the same
    solve on one device."""
    import jax
    import jax.numpy as jnp

    from structurepreservingiterativesolvers_tpu.models import heat
    from structurepreservingiterativesolvers_tpu.parallel import (
        make_mesh,
        shard_preconditioner,
        shard_system,
    )
    from structurepreservingiterativesolvers_tpu.precond.amg import amg
    from structurepreservingiterativesolvers_tpu.solvers import cgmres

    _check(len(jax.devices()) >= n_devices, jax.devices())
    system = heat.linforms(M=M)
    n = system.b.shape[0]
    _check(n % n_devices == 0, n, n_devices)
    pre = amg(system.A, dtype=system.b.dtype, grid=(M + 1, M + 1))
    cons = system.constraints()
    cmax = max(abs(float(c.c)) for c in cons)
    t0 = time.perf_counter()
    x1, i1 = cgmres(system.A, system.b, k=k, tol=tol, constraints=cons,
                    pre=pre)
    x1.block_until_ready()
    t1 = time.perf_counter() - t0
    mesh = make_mesh(n_devices)
    A, b, _, cons_sh = shard_system(system.A, system.b, jnp.zeros_like(
        system.b), cons, mesh)
    pre_sh = shard_preconditioner(pre, mesh)
    t0 = time.perf_counter()
    xs, i_s = cgmres(A, b, None, k=k, tol=tol, constraints=cons_sh,
                     pre=pre_sh)
    xs.block_until_ready()
    ts = time.perf_counter() - t0
    # the certificate bound of phase 1: 1e-12·max(1,|c|), floored at the
    # constraint's own evaluation roundoff (the solver latch's formula)
    floor = max(d["floor"] for d in host_deviations(system, x1).values())
    bound = max(1e-12 * max(1.0, cmax), floor)
    for info, x in ((i1, x1), (i_s, xs)):
        _check(info["safety"] is True, info)
        _check(info["deviation"] <= bound, info, bound)
        _check_certificate(system, x, info["safety"])
    _check(i_s["steps"] == i1["steps"], i_s["steps"], i1["steps"])
    x1h, xsh = np.asarray(x1), np.asarray(xs)
    rel = float(np.linalg.norm(xsh - x1h) / np.linalg.norm(x1h))
    _check(rel <= 1e-10, rel)
    shards = {s.device.id: s.data.nbytes for s in xs.addressable_shards}
    _check(len(shards) == n_devices and len(set(shards.values())) == 1,
           shards)
    return (f"sharded heat M={M} n={n} on {n_devices} devices: steps="
            f"{i_s['steps']} (one device {i1['steps']}) constrained="
            f"{i_s['constrained_steps']} safety={i_s['safety']} deviation "
            f"sharded={i_s['deviation']:.3e} one={i1['deviation']:.3e} "
            f"(1e-12*max(1,|c|)={1e-12 * max(1.0, cmax):.1e}, "
            f"floor={floor:.1e}) "
            f"rel_diff_x={rel:.2e} sharding={xs.sharding} "
            f"bytes_per_device={shards} wall_first_call_s sharded={ts:.2f} "
            f"one={t1:.2f}")


PHASES = {1: phase_heat, 2: phase_swe, 3: phase_lkdvrk, 4: phase_parity,
          5: phase_f32, 6: phase_kernels}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--chips", type=int, default=1, choices=(1, 4))
    args = parser.parse_args(argv)

    # host checks run on JAX's CPU device beside the GPU
    plats = os.environ.get("JAX_PLATFORMS", "")
    if plats and "cpu" not in plats.split(","):
        os.environ["JAX_PLATFORMS"] = plats + ",cpu"
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: JAX's default device is {dev.platform}, not a "
              "GPU; nothing was run", file=sys.stderr)
        return 2
    if len(jax.devices()) < args.chips:
        print(f"chip_smoke: --chips {args.chips} but JAX sees "
              f"{len(jax.devices())} device(s)", file=sys.stderr)
        return 2

    from structurepreservingiterativesolvers_tpu import config
    from structurepreservingiterativesolvers_tpu.utils.profiling import (
        gpu_name_power_limit,
    )

    cache = config.enable_compile_cache()
    _log(f"device: {dev.device_kind} x{len(jax.devices())}; nvidia-smi: "
         f"{gpu_name_power_limit()}; jax {jax.__version__}; "
         f"compile cache {cache}")
    if args.chips == 4:
        todo = {"4-chip": lambda: phase_sharded(n_devices=4)}
    else:
        todo = PHASES
    failed = []
    for name, fn in todo.items():
        t0 = time.perf_counter()
        try:
            line = fn()
        except Exception:  # noqa: BLE001 — report, run the rest, then fail
            traceback.print_exc()
            failed.append(name)
            _log(f"phase {name} FAILED after "
                 f"{time.perf_counter() - t0:.1f} s")
            continue
        _log(f"phase {name} ok ({time.perf_counter() - t0:.1f} s): {line}")
    if failed:
        _log(f"failed phases: {failed}")
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
