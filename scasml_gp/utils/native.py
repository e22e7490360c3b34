"""ctypes bindings for the native C++ schedule builder (native/schedule.cc).

The library is built from the committed source with g++ on first use into
native/build/ (not tracked), and rebuilt whenever it is missing or older than
native/schedule.cc; if no toolchain is available every entry point returns
None and callers fall back to the pure-Python implementations in
scasml_gp/picard/schedule.py.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
_SRC = os.path.join(_ROOT, "native", "schedule.cc")
_BUILD_DIR = os.path.join(_ROOT, "native", "build")
_LIB_PATH = os.path.join(_BUILD_DIR, "libscasml_schedule.so")

_lock = threading.Lock()
_lib = None
_lib_failed = False


def _compile() -> bool:
    """Build into a private temporary file, then rename it into place, so
    processes building at the same time never load a half-written library."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
    cmd = ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", _SRC, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, _LIB_PATH)
        return True
    except (OSError, subprocess.SubprocessError):
        if os.path.exists(tmp):
            os.remove(tmp)
        return False


def _stale() -> bool:
    """True when the library is missing or older than its source."""
    return not os.path.exists(_LIB_PATH) or (
        os.path.getmtime(_LIB_PATH) < os.path.getmtime(_SRC)
    )


def get_lib() -> Optional[ctypes.CDLL]:
    """Load (building if necessary) the native library, or None."""
    global _lib, _lib_failed
    with _lock:
        if _lib is not None or _lib_failed:
            return _lib
        if not os.path.exists(_SRC) or (_stale() and not _compile()):
            _lib_failed = True
            return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError:
            _lib_failed = True
            return None
        i64p = ctypes.POINTER(ctypes.c_int64)
        f64p = ctypes.POINTER(ctypes.c_double)
        lib.leggauss.argtypes = [ctypes.c_int, ctypes.c_double, ctypes.c_double,
                                 f64p, f64p]
        lib.leggauss.restype = None
        lib.picard_tables.argtypes = [ctypes.c_int, ctypes.c_double, i64p, i64p,
                                      i64p, f64p, f64p, ctypes.c_int64]
        lib.picard_tables.restype = ctypes.c_int64
        lib.count_quadrature.argtypes = [ctypes.c_int, ctypes.c_int, i64p, i64p,
                                         i64p, ctypes.c_int, ctypes.c_int]
        lib.count_quadrature.restype = ctypes.c_int64
        lib.count_full_history.argtypes = [ctypes.c_int, ctypes.c_int64,
                                           ctypes.c_int, ctypes.c_int]
        lib.count_full_history.restype = ctypes.c_int64
        _lib = lib
        return _lib


def _ptr64(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _ptrf(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def native_leggauss(npts: int, a: float, b: float):
    lib = get_lib()
    if lib is None:
        return None
    x = np.zeros(npts, np.float64)
    w = np.zeros(npts, np.float64)
    lib.leggauss(npts, a, b, _ptrf(x), _ptrf(w))
    return x, w


def native_picard_tables(rhomax: int, T: float):
    """(Mf, Mg, Q, c, w) or None. Same layout as schedule.approx_parameters."""
    lib = get_lib()
    if lib is None:
        return None
    Mf = np.zeros((rhomax, rhomax), np.int64)
    Mg = np.zeros((rhomax, rhomax + 1), np.int64)
    Q = np.zeros((rhomax, rhomax), np.int64)
    qcap = max(4 * rhomax + 8, 16)
    while True:
        c = np.zeros((qcap, qcap), np.float64)
        w = np.zeros((qcap, qcap), np.float64)
        qmax = lib.picard_tables(
            rhomax, T, _ptr64(Mf), _ptr64(Mg), _ptr64(Q), _ptrf(c), _ptrf(w),
            qcap,
        )
        if qmax >= 0:
            q = int(max(qmax, 1))
            return Mf, Mg, Q, c[:q, :q].copy(), w[:q, :q].copy()
        qcap = int(-qmax) + 1


def native_count_quadrature(n, rho, Mf, Mg, Q, count_fg=False):
    lib = get_lib()
    if lib is None:
        return None
    rhomax = Mf.shape[0]
    Mf = np.ascontiguousarray(Mf, np.int64)
    Mg = np.ascontiguousarray(Mg, np.int64)
    Q = np.ascontiguousarray(Q, np.int64)
    return int(
        lib.count_quadrature(int(n), int(rho), _ptr64(Mf), _ptr64(Mg),
                             _ptr64(Q), rhomax, int(count_fg))
    )


def native_count_full_history(n, M, scasml_variant=False, count_fg=False):
    lib = get_lib()
    if lib is None:
        return None
    return int(
        lib.count_full_history(int(n), int(M), int(scasml_variant),
                               int(count_fg))
    )
