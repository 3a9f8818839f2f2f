"""Multi-host strong-scaling artifact → docs/SCALING.md.

Runs the distributed benchmark (experiments.scaling.dist_efficiency) as
1-process and 2-process local CPU jobs — forming global meshes over gloo
collectives — and writes the BASELINE efficiency table together with the
measured collective-latency floor that dominates it on a loopback surrogate.
This is the CI-able certificate for the "≥80% efficiency at 2 hosts" north
star (BASELINE.md): on a real cluster the same code path is launched once
per host (``python -m structurepreservingiterativesolvers_tpu dist-bench``
with ``SPIS_COORDINATOR`` / ``SPIS_NUM_PROCESSES`` / ``SPIS_PROCESS_ID``)
and one process drives all GPUs of its host.

Reference gap being filled: the reference has NO distributed backend at all
(SURVEY §2.3/§5.8; its only parallelism is the independent-run Popen pool,
reference lkdvRK/ErrorGenerator.py:13-54).
"""

import json
import os
import sys

sys.path.insert(0, ".")

OUT = "docs/SCALING.md"

HEADER = """# Multi-host scaling (distributed CGMRES)

Strong scaling of the sharded CGMRES solve and DIA SpMV across *process*
(host-surrogate) counts.  Each row is one distributed job: N processes ×
{dpp} virtual CPU device(s) each, one global host-major mesh, gloo
collectives across process boundaries — the code path a multi-host GPU
cluster runs per host (`parallel/distributed.py::init_distributed` +
`global_mesh`), with the network taking the place of the loopback gloo
transport.

efficiency = t_base · d_base / (t_N · d_N)  (strong scaling, devices-normalised).

## What this artifact certifies (and what it cannot)

On this machine ({ncpu} cores) the cross-process collective latency floor is
**{coll_ms:.0f} ms per reduction** (measured below: one global sum of a
2×8-element sharded vector — the shape of every MGS inner product).  A k=20
Arnoldi sweep issues hundreds of such reductions, so the 2-process rows are
latency-bound by the loopback-gloo transport, not by the framework: the
efficiency columns on this host measure gloo, not the solver.  What the
table **does** certify is the part that transfers to a cluster:

* the multi-process code path runs end-to-end (jax.distributed init,
  host-major global mesh, GSPMD collectives across process boundaries);
* step counts are identical on every mesh, and the constraint certificate
  holds on the global mesh (deviation <1e-10) — asserted in
  `tests/test_distributed.py`;
* the per-device compute (SpMV shards, replicated KKT endgame) partitions
  exactly as designed.

On GPUs the same reduction runs over NVLink within a host and the network
across hosts (not measured).  The artifact to produce on a real cluster is
one `dist-bench` run per host; the table schema is identical.

Generated by scripts/run_dist_scaling.py.

"""


def main():
    ncpu = os.cpu_count() or 1
    from structurepreservingiterativesolvers_tpu.experiments.scaling import (
        dist_efficiency,
    )

    sections = []
    for dpp, M in ((1, 64), (4, 32)):
        rows = dist_efficiency(
            problem="swe", M=M, k=20, tol=1e-6,
            process_counts=(1, 2), devices_per_process=dpp,
            to_markdown=False,
        )
        sections.append((dpp, M, rows))

    from structurepreservingiterativesolvers_tpu.experiments.report import (
        markdown_table,
    )

    cols = ["hosts", "devices", "n", "nnz", "spmv_time_s", "spmv_nnz_per_s",
            "collective_latency_s", "solve_time_s", "steps", "deviation",
            "spmv_efficiency", "solve_efficiency"]
    coll_ms = max(
        r.get("collective_latency_s", 0.0) * 1e3
        for _, _, rows in sections for r in rows if r["hosts"] > 1
    )

    with open(OUT, "w") as f:
        f.write(HEADER.format(ncpu=ncpu, coll_ms=coll_ms,
                              dpp="1 / 4"))
        for dpp, M, rows in sections:
            total = max(r["devices"] for r in rows)
            f.write(
                f"## swe M={M} (k=20, tol=1e-6), {dpp} device(s)/process "
                f"(max {total} devices on {ncpu} cores — "
                f"{total / ncpu:.2g}× oversubscribed)\n\n"
            )
            f.write(markdown_table(
                [{c: r[c] for c in cols if c in r} for r in rows],
                floatfmt=".3g"))
            f.write("\n\n")
            f.write(
                f"Certificates on the {rows[-1]['hosts']}-process global "
                f"mesh: safety={rows[-1]['safety']}, "
                f"deviation={rows[-1]['deviation']:.3g}, steps identical "
                f"across meshes: "
                f"{all(r['steps'] == rows[0]['steps'] for r in rows)}.\n\n"
            )
    print("wrote", OUT)
    for _, _, rows in sections:
        print(json.dumps(rows, indent=1, default=str))


if __name__ == "__main__":
    main()
