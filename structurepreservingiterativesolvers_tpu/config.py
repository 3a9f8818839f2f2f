"""Global configuration for the framework.

The reference code (reference ``solvers.py:138``) needs constraint deviations
at the 1e-12 level, which requires float64 accumulation, so x64 is enabled
globally and ``default_dtype`` is float64 (``SPIS_FORCE_DTYPE`` overrides it;
``SPIS_DISABLE_X64=1`` opts out of x64 and makes the default float32).
float32 storage remains a supported choice per call (``dtype=`` on the model
assemblers): the constraint path then runs in f64 / double-f32.

Matrix products default to ``"highest"`` precision: on GPUs with tensor
cores XLA would otherwise be free to run float32 products (the CGS2
``Q @ w`` / ``h @ Q`` passes, reduction SpMMs, the snap projection) in TF32,
whose ~1e-3 relative error would wreck basis orthogonality and the invariant
certificate.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp

if os.environ.get("SPIS_DISABLE_X64", "0") != "1":
    jax.config.update("jax_enable_x64", True)
jax.config.update("jax_default_matmul_precision", "highest")

# Fixed per-checkout cache location: the directory is part of the cache key,
# so a path that moved between runs would never hit.
_CHECKOUT_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache; returns its directory.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
    nothing is set here; otherwise the cache lives in ``<checkout>/.jax_cache``.
    Called by the entry points (CLI, ``bench.py``, ``chip_smoke.py``), not on
    import, so library users and the tests keep JAX's default."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    os.makedirs(_CHECKOUT_CACHE, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", _CHECKOUT_CACHE)
    return _CHECKOUT_CACHE


def default_dtype():
    """float64 under x64 (the default), else float32; ``SPIS_FORCE_DTYPE``
    overrides both."""
    if os.environ.get("SPIS_FORCE_DTYPE"):
        return jnp.dtype(os.environ["SPIS_FORCE_DTYPE"])
    return jnp.dtype("float64") if jax.config.jax_enable_x64 else jnp.dtype("float32")


# Tolerance of the constraint-enforcement minimisation problem; mirrors the
# reference's hard-coded ctol (reference solvers.py:138).
CTOL = 1e-12
