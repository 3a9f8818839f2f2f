"""Profiling and throughput instrumentation.

Replacement for the reference's hand-rolled wall-clock phase timers
(reference solvers.py:140-146,299-314): a context manager around
``jax.profiler`` for device traces, a median timer for work that ends in
``block_until_ready``, the card's name and power limit for labelling device
numbers, and throughput counters (nnz/s, iterations/s) computed from solve
metadata.
"""

from __future__ import annotations

import contextlib
import statistics
import subprocess
import time
from typing import Callable


@contextlib.contextmanager
def device_trace(logdir: str):
    """Capture a jax profiler trace viewable in TensorBoard/XProf."""
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class Stopwatch:
    """Wall-clock phase timer with the reference's timings-dict shape."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.marks = {}

    def mark(self, name: str):
        self.marks[name] = time.perf_counter() - self.t0
        return self.marks[name]


def median_time(fn: Callable, reps: int = 5, warmup: int = 1) -> float:
    """Median wall seconds of ``fn()`` (blocked until its outputs are
    ready) over ``reps`` calls, after ``warmup`` untimed calls (compile)."""
    import jax

    for _ in range(warmup):
        jax.block_until_ready(fn())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def gpu_name_power_limit() -> str:
    """``name, power.limit`` of the first GPU as nvidia-smi reports them, read
    in a child process that does not touch JAX; "not available" without
    nvidia-smi.  A card set below its maximum power runs slower under load,
    so every device number is reported beside this."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return "not available"
    lines = r.stdout.strip().splitlines()
    return lines[0].strip() if r.returncode == 0 and lines else "not available"


def spmv_throughput(nnz: int, seconds: float) -> float:
    return nnz / seconds if seconds > 0 else float("inf")


def solve_throughput(info: dict, nnz: int, seconds: float) -> dict:
    """Counters for a Krylov solve: per-iteration cost and effective nnz/s
    (each iteration reads the operator at least twice: SpMV + true
    residual)."""
    steps = max(info.get("steps", 0), 1)
    return {
        "iterations_per_s": steps / seconds,
        "spmv_nnz_per_s": 2 * steps * nnz / seconds,
        "seconds_per_iteration": seconds / steps,
    }
