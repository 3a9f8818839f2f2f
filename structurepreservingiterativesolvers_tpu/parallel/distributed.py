"""Multi-host (multi-process) distribution: jax.distributed init, global
meshes, and host-major device ordering.

The reference has NO distributed backend (SURVEY §2.3/§5.8 — its only
parallelism is the process-pool sweep, reference
lkdvRK/ErrorGenerator.py:13-54).  Here multi-host data distribution is
first-class: each host process calls :func:`init_distributed`, builds the
same global mesh, and runs the *same* jitted solver — GSPMD places psum
reductions and halo permutes on the device interconnect within a host
(NVLink) and on the network across hosts.  On one host, a single process
drives all its GPUs; several processes are for several hosts.

Device ordering matters: :func:`global_mesh` orders devices host-major, so a
1-D row sharding keeps consecutive row blocks on the same host and the ring
halo exchange of the DIA SpMV crosses the network only at the ``num_hosts``
host boundaries per sweep (everything else stays within a host).
:func:`host_chip_mesh` exposes the explicit 2-D (hosts × chips)
factorisation for layouts that want to reduce hierarchically.

Works identically on real clusters and on multi-process CPU validation runs
(``--xla_force_host_platform_device_count`` per process + gloo collectives),
which is how ``tests/test_distributed.py`` exercises it.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from .mesh import ROWS

HOSTS = "hosts"
CHIPS = "chips"


def init_distributed(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> tuple:
    """Initialise the JAX distributed runtime for this process.

    Arguments fall back to the ``SPIS_COORDINATOR`` / ``SPIS_NUM_PROCESSES``
    / ``SPIS_PROCESS_ID`` environment variables, and finally to JAX's own
    cluster auto-detection (Slurm, Open MPI).  Returns
    ``(process_id, num_processes)``.  Idempotent: calling again after a
    successful init is a no-op.
    """
    import jax

    coordinator = coordinator or os.environ.get("SPIS_COORDINATOR")
    if num_processes is None and os.environ.get("SPIS_NUM_PROCESSES"):
        num_processes = int(os.environ["SPIS_NUM_PROCESSES"])
    if process_id is None and os.environ.get("SPIS_PROCESS_ID"):
        process_id = int(os.environ["SPIS_PROCESS_ID"])

    already = getattr(jax.distributed.initialize, "_spis_done", False)
    if not already and (num_processes is None or num_processes > 1):
        jax.distributed.initialize(
            coordinator_address=coordinator,
            num_processes=num_processes,
            process_id=process_id,
        )
        jax.distributed.initialize._spis_done = True
    return jax.process_index(), jax.process_count()


def _devices_host_major():
    import jax

    return sorted(jax.devices(), key=lambda d: (d.process_index, d.id))


def global_mesh(axis: str = ROWS):
    """1-D mesh over ALL global devices, host-major: consecutive shards stay
    on one host, so ring halos cross the network only at host boundaries."""
    import jax
    from jax.sharding import Mesh

    return Mesh(np.asarray(_devices_host_major()), (axis,))


def host_chip_mesh():
    """2-D (hosts, chips) mesh — the network × interconnect factorisation."""
    import jax
    from jax.sharding import Mesh

    devs = _devices_host_major()
    nh = jax.process_count()
    nc = len(devs) // nh
    return Mesh(np.asarray(devs).reshape(nh, nc), (HOSTS, CHIPS))


def is_coordinator() -> bool:
    import jax

    return jax.process_index() == 0


def spawn_local(num_processes: int, argv: list, env_extra: Optional[dict] = None,
                port: int = 12973, timeout: float = 600.0,
                devices_per_process: int = 4):
    """Spawn ``num_processes`` copies of this package's CLI as local
    processes forming one distributed job over CPU devices — the
    validation harness for the multi-host path when only one host exists
    (the reference's only concurrency is a similar Popen fan-out,
    lkdvRK/ErrorGenerator.py:45-47, but of *independent* runs; these
    processes form a single collective job).

    Returns the list of (returncode, stdout) per process.
    """
    import subprocess
    import sys

    procs = []
    for pid in range(num_processes):
        env = dict(os.environ)
        env.update(env_extra or {})
        env["SPIS_COORDINATOR"] = f"localhost:{port}"
        env["SPIS_NUM_PROCESSES"] = str(num_processes)
        env["SPIS_PROCESS_ID"] = str(pid)
        # CPU validation: each process contributes exactly
        # ``devices_per_process`` virtual devices — any inherited
        # xla_force_host_platform_device_count (e.g. from the test
        # conftest) is stripped so the global device count is deterministic.
        # Forced, not defaulted: children inheriting an accelerator platform
        # would each try to reserve the same device.
        env["JAX_PLATFORMS"] = "cpu"
        # a multi-process CPU job hangs in its first cross-process
        # collective when its processes load the solver from the persistent
        # compile cache, so the validation workers always compile afresh
        env["JAX_ENABLE_COMPILATION_CACHE"] = "false"
        import re

        flags = re.sub(
            r"--xla_force_host_platform_device_count=\d+", "",
            env.get("XLA_FLAGS", ""),
        ).strip()
        env["XLA_FLAGS"] = (
            f"{flags} --xla_force_host_platform_device_count="
            f"{devices_per_process}"
        ).strip()
        procs.append(
            subprocess.Popen(
                [sys.executable, "-m", "structurepreservingiterativesolvers_tpu"]
                + argv,
                stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT,
                text=True,
                env=env,
            )
        )
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        outs.append((p.returncode, out))
    return outs
