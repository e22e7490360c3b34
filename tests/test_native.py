"""Native C++ schedule builder vs the pure-Python reference implementation."""

import numpy as np
import pytest

from scasml_gp.picard.schedule import (
    approx_parameters,
    count_evaluations_full_history,
    count_evaluations_quadrature,
    leggauss,
)
from scasml_gp.utils.native import (
    get_lib,
    native_count_full_history,
    native_count_quadrature,
    native_leggauss,
    native_picard_tables,
)

pytestmark = pytest.mark.skipif(
    get_lib() is None, reason="no C++ toolchain available"
)


@pytest.mark.parametrize("npts", [1, 2, 3, 5, 8, 13])
def test_native_leggauss_matches_numpy(npts):
    xn, wn = native_leggauss(npts, 0.0, 0.5)
    xp, wp = leggauss(npts, 0.0, 0.5)
    np.testing.assert_allclose(xn, xp, rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(wn, wp, rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("rhomax", [1, 2, 3, 5, 7])
def test_native_tables_match_python(rhomax):
    Mf, Mg, Q, c, w = native_picard_tables(rhomax, 0.5)
    ref = approx_parameters(rhomax, 0.5, backend="python")
    np.testing.assert_array_equal(Mf, ref.Mf)
    np.testing.assert_array_equal(Mg, ref.Mg)
    np.testing.assert_array_equal(Q, ref.Q)
    np.testing.assert_allclose(c, ref.c, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(w, ref.w, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("n,rho", [(1, 1), (2, 2), (3, 3), (4, 5)])
@pytest.mark.parametrize("count_fg", [False, True])
def test_native_quadrature_counter(n, rho, count_fg):
    t = approx_parameters(rho, 0.5, backend="python")
    got = native_count_quadrature(n, rho, t.Mf, t.Mg, t.Q, count_fg=count_fg)
    want = count_evaluations_quadrature(n, rho, 0.5, count_fg=count_fg)
    assert got == want


@pytest.mark.parametrize("n,M", [(1, 2), (2, 3), (3, 4), (5, 3)])
@pytest.mark.parametrize("variant", [False, True])
def test_native_full_history_counter(n, M, variant):
    got = native_count_full_history(n, M, scasml_variant=variant)
    want = count_evaluations_full_history(n, M, scasml_variant=variant)
    assert got == want


@pytest.fixture
def private_build(monkeypatch, tmp_path):
    """The native module pointed at a copy of the source and an empty build
    directory, with nothing loaded yet."""
    import shutil

    import scasml_gp.utils.native as native

    src = tmp_path / "schedule.cc"
    shutil.copy(native._SRC, src)
    lib = tmp_path / "build" / "libscasml_schedule.so"
    monkeypatch.setattr(native, "_SRC", str(src))
    monkeypatch.setattr(native, "_BUILD_DIR", str(lib.parent))
    monkeypatch.setattr(native, "_LIB_PATH", str(lib))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_lib_failed", False)
    return native, src, lib


def test_native_library_built_when_missing(private_build):
    native, src, lib = private_build
    assert not lib.exists()
    assert native.get_lib() is not None
    assert lib.exists()
    xn, _ = native.native_leggauss(5, 0.0, 0.5)
    np.testing.assert_allclose(xn, leggauss(5, 0.0, 0.5)[0], rtol=1e-12)


def test_native_library_rebuilt_when_older_than_source(private_build):
    import os

    native, src, lib = private_build
    lib.parent.mkdir()
    lib.write_bytes(b"not a shared library")   # unloadable if kept
    old = src.stat().st_mtime - 100
    os.utime(lib, (old, old))
    assert native.get_lib() is not None
    assert lib.stat().st_mtime >= src.stat().st_mtime
