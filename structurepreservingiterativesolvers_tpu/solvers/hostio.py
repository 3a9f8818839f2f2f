"""Host↔device traffic minimisation for the solver wrappers.

The reference solver's state lives on the host (reference
``solvers.py:58-127``); here it lives on the device, and each solve's host
traffic is kept to one dispatch and one fetch:

* ``dscalar`` caches device-resident scalar operands (tolerances), so the
  put happens once per distinct value instead of once per solve;
* result fetches are batched into a single ``jax.device_get`` per solve
  (in the solver modules).

On a locally attached GPU a put costs microseconds; whether the cache earns
its place is an open measurement (ROADMAP, Speed 7).
"""

from __future__ import annotations

from functools import lru_cache

import jax.numpy as jnp


@lru_cache(maxsize=1024)
def _device_scalar(value: float, dtype_name: str):
    return jnp.asarray(value, jnp.dtype(dtype_name))


def dscalar(value, dtype):
    """Device scalar for ``value`` with a process-lifetime put cache."""
    return _device_scalar(float(value), jnp.dtype(dtype).name)
