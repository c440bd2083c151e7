"""ctypes bridge to the native C++ preprocessing library (native/graphcore.cpp).

The library is built from source on first use in each process: `make` in
native/ compiles it for the host it runs on (-march=native), and rebuilds
it whenever graphcore.cpp is newer than the library. Every entry point has
a numpy fallback in core/graph.py, so the package works without a
toolchain. The native path matters for big graphs: orientation/relabel of a
100M-edge graph is seconds in parallel C++ vs minutes in numpy.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native")
LIB_NAME = "libgraphcore.so"

_lock = threading.Lock()
_lib = None
_tried = False
_error = None     # why the library is unavailable, once get_lib() gave up


class NativeBuildError(RuntimeError):
    pass


def build(native_dir: str = NATIVE_DIR) -> str:
    """Run `make` in native_dir, which compiles graphcore.cpp into
    LIB_NAME when the library is absent or older than its source. Returns
    the library's path; raises NativeBuildError with make's output when
    the build fails (no toolchain, a compile error)."""
    try:
        subprocess.run(["make", "-s", "-C", native_dir], check=True,
                       capture_output=True, text=True, timeout=300)
    except subprocess.CalledProcessError as e:
        raise NativeBuildError((e.stdout + e.stderr)[-2000:]) from e
    except (OSError, subprocess.SubprocessError) as e:
        raise NativeBuildError(str(e)) from e
    return os.path.join(native_dir, LIB_NAME)


def unavailable_reason() -> Optional[str]:
    """Why get_lib() returned None (build or load error), else None."""
    return _error


def get_lib():
    """The loaded library or None (numpy fallback)."""
    global _lib, _tried, _error
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("GRAPHMINER_NO_NATIVE"):
            _error = "GRAPHMINER_NO_NATIVE is set"
            return None
        try:
            lib = ctypes.CDLL(build())
        except (NativeBuildError, OSError) as e:
            _error = f"{type(e).__name__}: {e}"
            return None
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        lib.gm_orient.restype = ctypes.c_int64
        lib.gm_orient.argtypes = [ctypes.c_int64, ctypes.c_int64, i64p, i32p,
                                  i64p, i32p]
        lib.gm_relabel_by_degree.restype = None
        lib.gm_relabel_by_degree.argtypes = [
            ctypes.c_int64, ctypes.c_int64, i64p, i32p, ctypes.c_int,
            i64p, i32p, i32p, i32p]
        lib.gm_sort_neighbors.restype = None
        lib.gm_sort_neighbors.argtypes = [ctypes.c_int64, i64p, i32p]
        lib.gm_edge_list.restype = ctypes.c_int64
        lib.gm_edge_list.argtypes = [ctypes.c_int64, ctypes.c_int64, i64p,
                                     i32p, ctypes.c_int, ctypes.c_int,
                                     i32p, i32p]
        lib.gm_num_threads.restype = ctypes.c_int
        if hasattr(lib, "gm_expand_multi"):
            pp = ctypes.POINTER(ctypes.c_void_p)
            lib.gm_expand_multi.restype = ctypes.c_int64
            lib.gm_expand_multi.argtypes = [
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_int64, pp, pp, ctypes.c_int64,
                i64p, i32p, i64p]
        if hasattr(lib, "gm_count_multi"):
            pp = ctypes.POINTER(ctypes.c_void_p)
            lib.gm_count_multi.restype = None
            lib.gm_count_multi.argtypes = [
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64, pp, pp, i32p]
        if hasattr(lib, "gm_expand_emit"):
            pp = ctypes.POINTER(ctypes.c_void_p)
            lib.gm_expand_emit.restype = ctypes.c_int64
            lib.gm_expand_emit.argtypes = [
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_int64, pp, pp, ctypes.c_int64,
                pp, ctypes.c_int64, i32p, i64p]
        if hasattr(lib, "gm_t3ss"):
            lib.gm_t3ss.restype = None
            lib.gm_t3ss.argtypes = [ctypes.c_int64, i64p, i32p,
                                    ctypes.c_int64, i32p]
        if hasattr(lib, "gm_c4"):
            lib.gm_c4.restype = ctypes.c_int64
            lib.gm_c4.argtypes = [ctypes.c_int64, i64p, i32p]
        if hasattr(lib, "gm_kclique"):
            lib.gm_kclique.restype = ctypes.c_int64
            lib.gm_kclique.argtypes = [ctypes.c_int64, i64p, i32p,
                                       ctypes.c_int64]
        if hasattr(lib, "gm_csr_from_coo"):
            lib.gm_csr_from_coo.restype = ctypes.c_int64
            lib.gm_csr_from_coo.argtypes = [
                ctypes.c_int64, ctypes.c_int64, i32p, i32p, ctypes.c_int,
                i64p, i32p]
        _lib = lib
        return _lib


def orient(rowptr: np.ndarray, colidx: np.ndarray):
    lib = get_lib()
    if lib is None:
        return None
    v = rowptr.shape[0] - 1
    e = colidx.shape[0]
    out_rowptr = np.zeros(v + 1, dtype=np.int64)
    out_colidx = np.zeros(e // 2 + 1, dtype=np.int32)
    kept = lib.gm_orient(v, e, np.ascontiguousarray(rowptr, np.int64),
                         np.ascontiguousarray(colidx, np.int32),
                         out_rowptr, out_colidx)
    return out_rowptr, out_colidx[:kept].copy()


def relabel_by_degree(rowptr: np.ndarray, colidx: np.ndarray,
                      descending: bool):
    lib = get_lib()
    if lib is None:
        return None
    v = rowptr.shape[0] - 1
    e = colidx.shape[0]
    out_rowptr = np.zeros(v + 1, dtype=np.int64)
    out_colidx = np.zeros(e, dtype=np.int32)
    perm = np.zeros(v, dtype=np.int32)
    inv = np.zeros(v, dtype=np.int32)
    lib.gm_relabel_by_degree(v, e, np.ascontiguousarray(rowptr, np.int64),
                             np.ascontiguousarray(colidx, np.int32),
                             int(descending), out_rowptr, out_colidx,
                             perm, inv)
    return out_rowptr, out_colidx, perm, inv


def edge_list(rowptr: np.ndarray, colidx: np.ndarray, sym_break: bool,
              ascend: bool):
    lib = get_lib()
    if lib is None:
        return None
    v = rowptr.shape[0] - 1
    e = colidx.shape[0]
    src = np.zeros(e, dtype=np.int32)
    dst = np.zeros(e, dtype=np.int32)
    n = lib.gm_edge_list(v, e, np.ascontiguousarray(rowptr, np.int64),
                         np.ascontiguousarray(colidx, np.int32),
                         int(sym_break), int(ascend), src, dst)
    return src[:n].copy(), dst[:n].copy()


def csr_from_coo(src: np.ndarray, dst: np.ndarray, n_vertices: int,
                 symmetrize: bool):
    """(rowptr, colidx) sorted+dedup'd CSR from COO, or None (numpy path)."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "gm_csr_from_coo"):
        return None
    src = np.ascontiguousarray(src, dtype=np.int32)
    dst = np.ascontiguousarray(dst, dtype=np.int32)
    e = src.shape[0]
    cap = 2 * e if symmetrize else e
    rowptr = np.zeros(n_vertices + 1, dtype=np.int64)
    colidx = np.empty(max(cap, 1), dtype=np.int32)
    n = lib.gm_csr_from_coo(n_vertices, e, src, dst, int(symmetrize),
                            rowptr, colidx)
    return rowptr, colidx[:n].copy()


def expand_multi(bases, rows, words: int, n_bits: int, start: int,
                 cap: int, out_task: np.ndarray, out_bit: np.ndarray):
    """Streamed set-bit expansion (cliquebig hot loop): for tasks from
    `start`, AND the per-task bitmap rows bases[s][rows[s][t]] and emit
    (task, bit) pairs below n_bits into out_task/out_bit (capacity cap,
    whole tasks only). Returns (n_emitted, next_start) or None (no native
    lib — numpy fallback in cliquebig)."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "gm_expand_multi"):
        return None
    n_src = len(bases)
    n_tasks = rows[0].shape[0]
    bases_c = [np.ascontiguousarray(b.view(np.uint32)) for b in bases]
    rows_c = [np.ascontiguousarray(r, dtype=np.int64) for r in rows]
    bp = (ctypes.c_void_p * n_src)(
        *[b.ctypes.data_as(ctypes.c_void_p).value for b in bases_c])
    rp = (ctypes.c_void_p * n_src)(
        *[r.ctypes.data_as(ctypes.c_void_p).value for r in rows_c])
    nxt = np.zeros(1, dtype=np.int64)
    n = lib.gm_expand_multi(
        n_tasks, start, words, n_bits, n_src,
        ctypes.cast(bp, ctypes.POINTER(ctypes.c_void_p)),
        ctypes.cast(rp, ctypes.POINTER(ctypes.c_void_p)),
        cap, out_task, out_bit, nxt)
    return int(n), int(nxt[0])


def expand_emit(bases, rows, attrs, words: int, n_bits: int, start: int,
                cap: int, out: np.ndarray):
    """State-carrying expansion: for tasks from `start`, AND the bitmap
    rows bases[s][rows[s][t]]; for every set bit below n_bits write
    [attrs[0][t], ..., attrs[-1][t], bit] into `out` ([cap, n_attr+1]
    int32, whole tasks only). Returns (n_emitted, next_start) or None."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "gm_expand_emit"):
        return None
    n_src = len(bases)
    n_tasks = rows[0].shape[0]
    bases_c = [np.ascontiguousarray(b.view(np.uint32)) for b in bases]
    rows_c = [np.ascontiguousarray(r, dtype=np.int32) for r in rows]
    attrs_c = [np.ascontiguousarray(a, dtype=np.int32) for a in attrs]
    mk = lambda arrs: ctypes.cast(
        (ctypes.c_void_p * len(arrs))(
            *[a.ctypes.data_as(ctypes.c_void_p).value for a in arrs]),
        ctypes.POINTER(ctypes.c_void_p))
    nxt = np.zeros(1, dtype=np.int64)
    assert out.flags["C_CONTIGUOUS"] and out.dtype == np.int32
    assert out.shape[1] == len(attrs) + 1
    n = lib.gm_expand_emit(
        n_tasks, start, words, n_bits, n_src, mk(bases_c), mk(rows_c),
        len(attrs), mk(attrs_c), cap, out.reshape(-1), nxt)
    return int(n), int(nxt[0])


def t3ss(rowptr: np.ndarray, colidx: np.ndarray, cs: int):
    """Sub-sub-mid 3-walk support per DAG edge (see gm_t3ss). Returns
    int32 [E_directed] with entries valid at positions where col > row,
    or None when the native lib is unavailable."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "gm_t3ss"):
        return None
    v = rowptr.shape[0] - 1
    out = np.zeros(colidx.shape[0], dtype=np.int32)
    lib.gm_t3ss(v, np.ascontiguousarray(rowptr, np.int64),
                np.ascontiguousarray(colidx, np.int32), cs, out)
    return out


def c4_anchor(rowptr: np.ndarray, colidx: np.ndarray):
    """Max-anchored 4-cycle count (gm_c4), or None without the lib."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "gm_c4"):
        return None
    v = rowptr.shape[0] - 1
    return int(lib.gm_c4(v, np.ascontiguousarray(rowptr, np.int64),
                         np.ascontiguousarray(colidx, np.int32)))


def kclique_dfs(rowptr: np.ndarray, colidx: np.ndarray, k: int):
    """Reference-style DAG DFS k-clique count (gm_kclique) — independent
    conformance backend for the bitmap/bilinear engines. None without the
    lib; input must be the oriented DAG with sorted rows."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "gm_kclique"):
        return None
    v = rowptr.shape[0] - 1
    return int(lib.gm_kclique(v, np.ascontiguousarray(rowptr, np.int64),
                              np.ascontiguousarray(colidx, np.int32), k))


def count_multi(bases, rows, words: int, n_bits: int):
    """Per-task popcount of the AND of bitmap rows (prepass for exact
    chunk quotas). Returns int32 [n] or None."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "gm_count_multi"):
        return None
    n_src = len(bases)
    n_tasks = rows[0].shape[0]
    bases_c = [np.ascontiguousarray(b.view(np.uint32)) for b in bases]
    rows_c = [np.ascontiguousarray(r, dtype=np.int32) for r in rows]
    mk = lambda arrs: ctypes.cast(
        (ctypes.c_void_p * len(arrs))(
            *[a.ctypes.data_as(ctypes.c_void_p).value for a in arrs]),
        ctypes.POINTER(ctypes.c_void_p))
    out = np.empty(n_tasks, dtype=np.int32)
    lib.gm_count_multi(n_tasks, words, n_bits, n_src, mk(bases_c),
                       mk(rows_c), out)
    return out
