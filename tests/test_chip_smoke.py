"""``chip_smoke.py`` on the CPU: every phase function runs at a tiny size
(the checks inside each phase are the same ones the GPU run makes), and the
script itself refuses to run without a GPU."""

import importlib.util
import os

import pytest

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(_ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TINY = {
    "heat": ("phase_heat", dict(M=16)),
    "swe": ("phase_swe", dict(M=16)),
    "lkdvrk": ("phase_lkdvrk", dict(M=20, N=2)),
    "parity": ("phase_parity",
               dict(cases=(("heat", 16), ("swe", 8), ("lkdv", 10)))),
    "f32": ("phase_f32", dict(M=32)),
    "kernels": ("phase_kernels", dict(M=32, reps=5, big=1 << 12)),
    "sharded": ("phase_sharded", dict(M=15, n_devices=4)),
}


@pytest.mark.parametrize("phase", sorted(TINY))
def test_phase_runs_at_tiny_size(smoke, phase):
    name, kwargs = TINY[phase]
    line = getattr(smoke, name)(**kwargs)
    assert isinstance(line, str) and line


def test_main_refuses_cpu_backend(smoke, capsys):
    assert smoke.main([]) != 0
    out = capsys.readouterr()
    assert out.out == ""
    assert "not a GPU" in out.err
