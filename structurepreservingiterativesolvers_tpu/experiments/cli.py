"""Command-line interface — one CLI replacing the reference's per-problem
``__main__`` driver scripts and the argparse shim (reference
lkdvRK/subcall.py:27-43).

Usage::

    python -m structurepreservingiterativesolvers_tpu single --problem lkdv --k 20
    python -m structurepreservingiterativesolvers_tpu evolve --problem lkdv --tol 1e-6 --plot
    python -m structurepreservingiterativesolvers_tpu timed --problem heat --sizes 16 32 64
    python -m structurepreservingiterativesolvers_tpu sweep --parallel
    python -m structurepreservingiterativesolvers_tpu bench
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    parser = argparse.ArgumentParser(prog="structurepreservingiterativesolvers_tpu")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("single", help="one-step solver comparison (SingleSolve)")
    p.add_argument("--problem", default="lkdv",
                   choices=["lkdv", "lkdvrk", "heat", "swe"])
    p.add_argument("--k", type=int, default=20)
    p.add_argument("--tol", type=float, default=1e-50)
    p.add_argument("--M", type=int, default=50)
    p.add_argument("--degree", type=int, default=1)
    p.add_argument("--plot", action="store_true")

    p = sub.add_parser("evolve", help="time evolution with drift tracking")
    p.add_argument("--problem", default="lkdv",
                   choices=["lkdv", "lkdvrk", "heat", "swe"])
    p.add_argument("--N", type=int, default=100)
    p.add_argument("--M", type=int, default=50)
    p.add_argument("--degree", type=int, default=1)
    p.add_argument("--k", type=int, default=50)
    p.add_argument("--tol", type=float, default=1e-6)
    p.add_argument("--plot", action="store_true")

    p = sub.add_parser("timed", help="size-sweep timing benchmark (TimedSolve)")
    p.add_argument("--problem", default="heat", choices=["heat", "swe", "lkdv", "lkdvrk"])
    p.add_argument("--sizes", type=int, nargs="+", default=None)
    p.add_argument("--tol", type=float, default=1e-7)
    p.add_argument("--tol-mode", default="abs", choices=["abs", "rhs"],
                   help="rhs: scale tol by ||b|| (f32-attainable semantics)")
    p.add_argument("--k", type=int, default=20)

    p = sub.add_parser("sweep", help="lkdvRK convergence-order error sweep")
    p.add_argument("--parallel", action="store_true")
    p.add_argument("--N", type=int, default=10)
    p.add_argument("--M", type=int, default=400)
    p.add_argument("--plot", action="store_true")

    sub.add_parser("bench", help="headline benchmark (one JSON line)")

    p = sub.add_parser(
        "dist-bench",
        help="multi-host distributed benchmark: run once per host process "
             "(env SPIS_COORDINATOR/SPIS_NUM_PROCESSES/SPIS_PROCESS_ID), or "
             "--spawn N to validate with N local CPU processes and print "
             "the scaling-efficiency table",
    )
    p.add_argument("--problem", default="swe",
                   choices=["lkdv", "lkdvrk", "heat", "swe"])
    p.add_argument("--M", type=int, default=32)
    p.add_argument("--k", type=int, default=20)
    p.add_argument("--tol", type=float, default=1e-6)
    p.add_argument("--spawn", type=int, default=None, metavar="N",
                   help="spawn jobs with 1..N processes locally (CPU devices) "
                        "and print the efficiency table")
    p.add_argument("--devices-per-process", type=int, default=4)

    args = parser.parse_args(argv)
    from ..config import enable_compile_cache

    enable_compile_cache()

    if args.cmd == "single":
        from .single_solve import single_solve

        single_solve(args.problem, k=args.k, tol=args.tol, M=args.M,
                     degree=args.degree, plot=args.plot)
    elif args.cmd == "evolve":
        from .evolve import deviation_plotter, evolve

        if args.plot:
            deviation_plotter(args.problem, tol=args.tol, N=args.N, M=args.M,
                              degree=args.degree, k=args.k)
        else:
            out = evolve(args.problem, N=args.N, M=args.M, degree=args.degree,
                         k=args.k, tol=args.tol)
            for key in ("dm", "dmo", "de"):
                if key in out:
                    print(f"final {key}: {out[key][-1]:.3e}")
    elif args.cmd == "timed":
        from .timed_solve import timed_solve

        timed_solve(args.problem, sizes=args.sizes, tol=args.tol, k=args.k,
                    tol_mode=args.tol_mode)
    elif args.cmd == "sweep":
        from .error_sweep import error_plot, run_sweep

        run_sweep(parallel=args.parallel, N=args.N, M=args.M)
        if args.plot:
            error_plot()
    elif args.cmd == "bench":
        import runpy

        runpy.run_path("bench.py", run_name="__main__")
    elif args.cmd == "dist-bench":
        if args.spawn:
            from .scaling import dist_efficiency

            counts = sorted({1, args.spawn})
            dist_efficiency(args.problem, M=args.M, k=args.k, tol=args.tol,
                            process_counts=counts,
                            devices_per_process=args.devices_per_process)
        else:
            from .scaling import dist_bench_worker

            dist_bench_worker(args.problem, M=args.M, k=args.k, tol=args.tol)


if __name__ == "__main__":
    main()
