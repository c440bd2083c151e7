"""The native library is built from native/'s sources by `make` on first
use, and rebuilt when the source is newer than the library."""
import ctypes
import os
import shutil

import pytest

from graphminer_tpu import native_bridge


def test_built_from_source_when_absent(tmp_path):
    if shutil.which("make") is None or shutil.which("g++") is None:
        pytest.skip("no C++ toolchain on this machine")
    for f in ("Makefile", "graphcore.cpp"):
        shutil.copy(os.path.join(native_bridge.NATIVE_DIR, f), tmp_path)
    lib = tmp_path / native_bridge.LIB_NAME
    assert not lib.exists()
    assert native_bridge.build(str(tmp_path)) == str(lib)
    assert ctypes.CDLL(str(lib)).gm_num_threads() >= 1
    # a newer source rebuilds the library
    built = lib.stat().st_mtime_ns
    src = tmp_path / "graphcore.cpp"
    os.utime(src, ns=(built + 10**9, built + 10**9))
    assert native_bridge.build(str(tmp_path)) == str(lib)
    assert lib.stat().st_mtime_ns > built
    assert not list(tmp_path.glob("*.tmp")) + list(tmp_path.glob("*.o"))


def test_build_failure_reports_make_output(tmp_path):
    """No Makefile → no library; the error carries make's own message."""
    with pytest.raises(native_bridge.NativeBuildError, match="make"):
        native_bridge.build(str(tmp_path))
