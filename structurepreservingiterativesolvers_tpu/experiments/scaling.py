"""Multi-device scaling measurements (SpMV throughput and solve time vs
mesh size).

BASELINE's north-star metrics include nnz/s at 1 chip / N devices and ≥80%
scaling efficiency.  This harness runs the same problem over growing device
meshes and reports throughput + efficiency.  On a single-chip or CPU host it
still runs (virtual devices) — functional validation of the sharded path;
on a pod slice it measures real ICI scaling.
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np


def _med(fn, reps=10, warmup=2):
    for _ in range(warmup):
        fn()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def spmv_scaling(
    problem: str = "swe",
    M: int = 64,
    device_counts: Optional[Sequence[int]] = None,
    **params,
):
    """DIA SpMV time vs number of devices (GSPMD sharding)."""
    from ..parallel import make_mesh, shard_matrix, shard_vector
    from .single_solve import get_model

    model = get_model(problem)
    s = model.linforms(M=M, **params)
    nnz = s.A_csr.nnz
    n = s.b.shape[0]
    navail = len(jax.devices())
    if device_counts is None:
        device_counts = [d for d in (1, 2, 4, 8, 16) if d <= navail and n % d == 0]

    spmv = jax.jit(lambda A, x: A @ x)
    rows = []
    t1 = None
    for d in device_counts:
        mesh = make_mesh(d)
        A = shard_matrix(s.A, mesh)
        x = shard_vector(s.b, mesh)
        spmv(A, x).block_until_ready()
        t = _med(lambda: spmv(A, x).block_until_ready())
        if t1 is None:
            t1 = t
        rows.append(
            {
                "devices": d,
                "time_s": t,
                "nnz_per_s": nnz / t,
                "speedup": t1 / t,
                "efficiency": t1 / t / d,
            }
        )
    return rows


def solve_scaling(
    problem: str = "swe",
    M: int = 64,
    k: int = 20,
    tol: float = 1e-7,
    device_counts: Optional[Sequence[int]] = None,
    **params,
):
    """Full CGMRES solve time vs number of devices."""
    from ..parallel import make_mesh, shard_system
    from ..solvers import cgmres
    from .single_solve import get_model

    model = get_model(problem)
    s = model.linforms(M=M, **params)
    n = s.b.shape[0]
    navail = len(jax.devices())
    if device_counts is None:
        device_counts = [d for d in (1, 2, 4, 8, 16) if d <= navail and n % d == 0]

    rows = []
    t1 = None
    for d in device_counts:
        mesh = make_mesh(d)
        A, b, x0, cons = shard_system(
            s.A, s.b, jnp.zeros_like(s.b), s.constraints(), mesh
        )

        def run():
            x, _ = cgmres(A, b, x0, k=k, tol=tol, constraints=cons)
            return x.block_until_ready()

        run()
        t = _med(run, reps=5, warmup=1)
        if t1 is None:
            t1 = t
        rows.append(
            {"devices": d, "time_s": t, "speedup": t1 / t, "efficiency": t1 / t / d}
        )
    return rows


def report(rows) -> str:
    from .report import markdown_table

    return markdown_table(rows, floatfmt=".4g")


# ---------------------------------------------------------------------------
# Multi-host (multi-process) scaling — BASELINE north star: ≥80% efficiency
# at 2 hosts.  Worker + spawner pair; see parallel/distributed.py.
# ---------------------------------------------------------------------------

_DIST_TAG = "DIST_RESULT "


def dist_bench_worker(
    problem: str = "swe",
    M: int = 32,
    k: int = 20,
    tol: float = 1e-6,
    reps: int = 3,
):
    """One process of a distributed benchmark job.  Every process must run
    this with the same arguments (SPMD); the coordinator prints one
    ``DIST_RESULT {json}`` line with solve/SpMV timings on the GLOBAL mesh."""
    import json

    import jax

    from ..parallel import shard_system
    from ..parallel.distributed import global_mesh, init_distributed, is_coordinator
    from ..solvers import cgmres
    from .single_solve import get_model

    init_distributed()
    mesh = global_mesh()
    nd = mesh.devices.size

    model = get_model(problem)
    s = model.linforms(M=M)
    n = s.b.shape[0]
    if n % nd:
        raise ValueError(f"n={n} not divisible by {nd} global devices")
    nnz = s.A_csr.nnz
    A, b, x0, cons = shard_system(
        s.A, s.b, jnp.zeros_like(s.b), s.constraints(), mesh
    )

    spmv = jax.jit(lambda A_, v: A_ @ v)
    from ..parallel import shard_vector

    xs = shard_vector(s.b, mesh)
    spmv(A, xs).block_until_ready()
    t_spmv = _med(lambda: spmv(A, xs).block_until_ready(), reps=max(reps, 5))

    # collective latency floor: one global sum of a tiny sharded vector (the
    # shape of every MGS inner product).  On loopback-gloo CPU surrogates
    # this is ~tens of ms and dominates everything; on a device
    # interconnect it is microseconds — report it so efficiency numbers can
    # be interpreted.
    tiny = shard_vector(jnp.ones((nd * 8,), s.b.dtype), mesh)
    allred = jax.jit(lambda v: jnp.sum(v))
    allred(tiny).block_until_ready()
    t_coll = _med(lambda: allred(tiny).block_until_ready(), reps=max(reps, 5))

    def solve():
        x, _ = cgmres(A, b, x0, k=k, tol=tol, constraints=cons)
        return x.block_until_ready()

    x = solve()  # compile
    t_solve = _med(solve, reps=reps, warmup=0)
    x_fin, info = cgmres(A, b, x0, k=k, tol=tol, constraints=cons)

    result = {
        "problem": problem,
        "M": M,
        "n": int(n),
        "nnz": int(nnz),
        "hosts": int(jax.process_count()),
        "devices": int(nd),
        "spmv_time_s": t_spmv,
        "spmv_nnz_per_s": nnz / t_spmv,
        "collective_latency_s": t_coll,
        "solve_time_s": t_solve,
        "steps": info["steps"],
        "deviation": info["deviation"],
        "safety": info["safety"],
    }
    if is_coordinator():
        print(_DIST_TAG + json.dumps(result), flush=True)
    return result


def dist_efficiency(
    problem: str = "swe",
    M: int = 32,
    k: int = 20,
    tol: float = 1e-6,
    process_counts=(1, 2),
    devices_per_process: int = 4,
    to_markdown: bool = True,
):
    """Strong-scaling efficiency across host counts (the BASELINE table).

    Spawns one distributed job per process count (multi-process CPU
    validation when no pod is attached; on a pod, launch
    ``dist-bench`` once per host instead) and reports
    efficiency = t₁·d₁ / (t_N·d_N) for solve and SpMV.
    """
    import json

    from ..parallel.distributed import spawn_local

    argv_base = [
        "dist-bench", "--problem", problem, "--M", str(M), "--k", str(k),
        "--tol", str(tol),
    ]
    rows = []
    for i, np_ in enumerate(process_counts):
        outs = spawn_local(
            np_, argv_base, port=12973 + 17 * np_,
            devices_per_process=devices_per_process,
        )
        res = None
        for rc, out in outs:
            for line in out.splitlines():
                if line.startswith(_DIST_TAG):
                    res = json.loads(line[len(_DIST_TAG):])
        if res is None:
            logs = "\n".join(o[-2000:] for _, o in outs)
            raise RuntimeError(
                f"distributed job with {np_} processes produced no result:\n{logs}"
            )
        rows.append(res)

    base = rows[0]
    for r in rows:
        scale = r["devices"] / base["devices"]
        r["solve_efficiency"] = base["solve_time_s"] / (r["solve_time_s"] * scale)
        r["spmv_efficiency"] = base["spmv_time_s"] / (r["spmv_time_s"] * scale)
    if to_markdown:
        from .report import markdown_table

        cols = ["hosts", "devices", "spmv_time_s", "spmv_nnz_per_s",
                "solve_time_s", "steps", "spmv_efficiency", "solve_efficiency"]
        print(markdown_table([{c: r[c] for c in cols} for r in rows],
                             floatfmt=".4g"))
    return rows
