"""ctypes bindings for the in-tree C++ host kernels (``native/``).

Compiles ``native/spkernels.cpp`` on first use (g++ -O3, cached as an
untracked shared library next to the source).  Falls back gracefully:
callers check ``available()`` and use scipy equivalents otherwise.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _native_dir() -> str:
    return os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "native")


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    src = os.path.join(_native_dir(), "spkernels.cpp")
    so = os.path.join(_native_dir(), "libspkernels.so")
    try:
        if not os.path.exists(so) or os.path.getmtime(so) < os.path.getmtime(src):
            # build beside the target, then rename: a concurrent loader sees
            # either no library or a complete one
            tmp = f"{so}.{os.getpid()}.tmp"
            subprocess.run(
                ["g++", "-O3", "-march=native", "-shared", "-fPIC", src, "-o", tmp],
                check=True, capture_output=True,
            )
            os.replace(tmp, so)
        lib = ctypes.CDLL(so)
        i64p = ctypes.POINTER(ctypes.c_int64)
        f64p = ctypes.POINTER(ctypes.c_double)
        lib.csr_spmv_f64.argtypes = [ctypes.c_int64, i64p, i64p, f64p, f64p, f64p]
        lib.ilu0_factor_f64.restype = ctypes.c_int64
        lib.ilu0_factor_f64.argtypes = [ctypes.c_int64, i64p, i64p, f64p, i64p]
        lib.ilu0_solve_f64.argtypes = [ctypes.c_int64, i64p, i64p, f64p, i64p,
                                       f64p, f64p]
        _LIB = lib
    except Exception:  # noqa: BLE001 — no native toolchain: fall back
        _LIB = None
    return _LIB


def available() -> bool:
    return _load() is not None


def _as_i64(a):
    return np.ascontiguousarray(a, dtype=np.int64)


def _ptr(a, typ):
    return a.ctypes.data_as(ctypes.POINTER(typ))


def csr_spmv(A_csr, x: np.ndarray) -> np.ndarray:
    lib = _load()
    assert lib is not None
    n = A_csr.shape[0]
    indptr = _as_i64(A_csr.indptr)
    indices = _as_i64(A_csr.indices)
    data = np.ascontiguousarray(A_csr.data, dtype=np.float64)
    x = np.ascontiguousarray(x, dtype=np.float64)
    y = np.empty(n, dtype=np.float64)
    lib.csr_spmv_f64(n, _ptr(indptr, ctypes.c_int64), _ptr(indices, ctypes.c_int64),
                     _ptr(data, ctypes.c_double), _ptr(x, ctypes.c_double),
                     _ptr(y, ctypes.c_double))
    return y


class ILU0:
    """Native ILU(0) factor with a scipy-spilu-like ``.solve`` interface
    (the reference's preconditioner protocol, solvers.py:64-66)."""

    def __init__(self, A_csr):
        import scipy.sparse as sp

        lib = _load()
        if lib is None:
            raise RuntimeError("native kernels unavailable")
        A = sp.csr_matrix(A_csr).sorted_indices()
        n = A.shape[0]
        self.n = n
        self.indptr = _as_i64(A.indptr)
        self.indices = _as_i64(A.indices)
        self.data = np.ascontiguousarray(A.data, dtype=np.float64).copy()
        self.diag_pos = np.empty(n, dtype=np.int64)
        rc = lib.ilu0_factor_f64(
            n, _ptr(self.indptr, ctypes.c_int64), _ptr(self.indices, ctypes.c_int64),
            _ptr(self.data, ctypes.c_double), _ptr(self.diag_pos, ctypes.c_int64),
        )
        if rc != 0:
            raise ZeroDivisionError(f"zero pivot at row {rc - 1}")
        self._lib = lib

    def solve(self, b: np.ndarray) -> np.ndarray:
        b = np.ascontiguousarray(b, dtype=np.float64)
        x = np.empty(self.n, dtype=np.float64)
        self._lib.ilu0_solve_f64(
            self.n, _ptr(self.indptr, ctypes.c_int64),
            _ptr(self.indices, ctypes.c_int64), _ptr(self.data, ctypes.c_double),
            _ptr(self.diag_pos, ctypes.c_int64), _ptr(b, ctypes.c_double),
            _ptr(x, ctypes.c_double),
        )
        return x
