"""On-device batched solves via vmap.

SURVEY §7's experiment plan: "sweep fan-out via vmap where shapes allow".
The reference fans out parameter sweeps as OS processes
(lkdvRK/ErrorGenerator.py); when the operator is shared and only the
right-hand side / initial guess / constraint targets vary (time-step
batches, ensemble ICs, tolerance studies), a single vmapped solve keeps the
whole sweep on the accelerator with one compiled program.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..precond.base import as_preconditioner, is_operand_preconditioner
from ..solvers.cgmres import _build_core


def batch_constraints(cons_list: Sequence) -> Tuple[tuple, tuple]:
    """Merge per-item constraint pytrees into one batched pytree + vmap axes.

    Leaves identical across items are shared (axis None); varying leaves are
    stacked on a new leading axis (axis 0).  Comparison is by value, so there
    is no shape-collision guessing."""
    td0 = jax.tree_util.tree_structure(tuple(cons_list[0]))
    flats = [jax.tree_util.tree_flatten(tuple(c))[0] for c in cons_list]
    leaves, axes = [], []
    for i in range(len(flats[0])):
        ls = [f[i] for f in flats]
        same = all(
            l is ls[0]
            or (
                hasattr(l, "shape")
                and l.shape == ls[0].shape
                and bool(jnp.all(l == ls[0]))
            )
            for l in ls[1:]
        )
        if same:
            leaves.append(ls[0])
            axes.append(None)
        else:
            leaves.append(jnp.stack(ls))
            axes.append(0)
    batched = jax.tree_util.tree_unflatten(td0, leaves)
    in_axes = jax.tree_util.tree_unflatten(td0, axes)
    return batched, in_axes


def cgmres_many(
    A,
    Bs: jnp.ndarray,  # (batch, n) right-hand sides
    constraints_list: Sequence[Sequence] = (),  # per-item constraint lists
    X0s: Optional[jnp.ndarray] = None,
    k: int = 30,
    tol: float = 1e-8,
    contol: float = 10.0,
    ctol: float = 1e-12,
    pre=None,
    mixed: Optional[bool] = None,
):
    """Solve A x_i = b_i for a batch of right-hand sides with per-item
    constraint targets, as ONE vmapped device program."""
    Bs = jnp.asarray(Bs)
    X0s = jnp.zeros_like(Bs) if X0s is None else jnp.asarray(X0s, Bs.dtype)
    if constraints_list:
        cons, cons_axes = batch_constraints(list(constraints_list))
    else:
        cons, cons_axes = (), ()
    m = len(cons)
    if mixed is None:
        mixed = Bs.dtype == jnp.float32 and jax.config.jax_enable_x64
    if is_operand_preconditioner(pre):
        static_pre, pre_op = None, pre
    else:
        static_pre = as_preconditioner(pre) if pre is not None else None
        pre_op = None

    core = _build_core(int(k), m, static_pre, False, False, bool(mixed),
                       ("q",) * m)
    dt = Bs.dtype

    vm = jax.vmap(
        lambda b, x0, cons_: core(
            A, b, x0, cons_, jnp.asarray(tol, dt), jnp.asarray(contol, dt),
            jnp.asarray(ctol, dt), pre_op,
        ),
        in_axes=(0, 0, cons_axes),
    )
    out = vm(Bs, X0s, cons)
    steps_h, dev_h, safety_h, res_h = jax.device_get(
        (out.steps, out.deviation, out.safety, out.res)
    )  # one batched fetch (each np.asarray would be its own round trip)
    return out.x, {
        "steps": steps_h,
        "deviation": dev_h,
        "safety": safety_h,
        "res": res_h,
    }
