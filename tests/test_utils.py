"""Utility-layer smoke tests (profiling counters, config, native fallback)."""

import numpy as np
import pytest

from structurepreservingiterativesolvers_tpu import config
from structurepreservingiterativesolvers_tpu.utils import profiling


def test_profiling_counters():
    sw = profiling.Stopwatch()
    sw.mark("a")
    assert sw.marks["a"] >= 0.0
    assert profiling.spmv_throughput(1000, 0.001) == 1e6
    out = profiling.solve_throughput({"steps": 10}, nnz=500, seconds=0.5)
    assert out["iterations_per_s"] == 20.0
    assert out["spmv_nnz_per_s"] == 2 * 10 * 500 / 0.5


def test_config_dtype_cpu():
    # under the test conftest we are on CPU with x64 enabled
    assert config.default_dtype() == np.dtype("float64")
    assert config.CTOL == 1e-12


def test_default_dtype_force_override(monkeypatch):
    monkeypatch.delenv("SPIS_FORCE_DTYPE", raising=False)
    assert config.default_dtype() == np.dtype("float64")
    monkeypatch.setenv("SPIS_FORCE_DTYPE", "float32")
    assert config.default_dtype() == np.dtype("float32")


def test_matmul_precision_is_highest():
    """Importing the package pins matrix products to full precision, so f32
    products never run as TF32 on GPUs with tensor cores."""
    import jax

    assert jax.config.jax_default_matmul_precision == "highest"


@pytest.fixture
def restore_cache_dir():
    import jax

    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_honours_env(monkeypatch, tmp_path, restore_cache_dir):
    """With JAX_COMPILATION_CACHE_DIR set, JAX reads it itself and the code
    sets no other directory."""
    import jax

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert config.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_to_checkout(monkeypatch, restore_cache_dir):
    import os

    import jax

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = config.enable_compile_cache()
    root = os.path.dirname(os.path.dirname(os.path.abspath(config.__file__)))
    assert path == os.path.join(root, ".jax_cache")
    assert os.path.isdir(path)
    assert jax.config.jax_compilation_cache_dir == path


def test_checkpoint_roundtrip(tmp_path):
    from structurepreservingiterativesolvers_tpu.utils.checkpoint import (
        load_state,
        save_state,
    )

    path = str(tmp_path / "c.npz")
    save_state(path, 7, np.arange(5.0), {"mass": [1.0, 2.0], "time": [0.0, 0.1]})
    step, z, series = load_state(path)
    assert step == 7
    np.testing.assert_allclose(z, np.arange(5.0))
    assert series["mass"] == [1.0, 2.0]
    assert load_state(str(tmp_path / "missing.npz")) is None
