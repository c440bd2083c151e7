"""Preprocessing artifact persistence.

The reference's .bin graph format doubles as its preprocessing checkpoint
(src/common/graph.cc:4-124; README.md:83-103 — converted graphs are written
once and reloaded mmap-fast forever). Here: relabeled/oriented
CSR graphs (and any numpy-array bundle) are cached as .npz keyed by content
parameters, so a second run skips the host preprocessing entirely; XLA
executables are cached separately via jax's persistent compilation cache
(enable_compile_cache).
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

_CHECKOUT = os.path.abspath(os.path.join(os.path.dirname(__file__),
                                         "..", ".."))
DEFAULT_DIR = os.environ.get("GRAPHMINER_CACHE",
                             os.path.join(_CHECKOUT, "graph_cache"))
CHECKOUT_JAX_CACHE = os.path.join(_CHECKOUT, ".jax_cache")


def _path(key: str, cache_dir: Optional[str] = None) -> str:
    d = os.path.abspath(cache_dir or DEFAULT_DIR)
    os.makedirs(d, exist_ok=True)
    safe = "".join(c if c.isalnum() or c in "-_." else "_" for c in key)
    return os.path.join(d, safe + ".npz")


def save_graph(key: str, g, cache_dir: Optional[str] = None) -> str:
    """Persist a HostGraph (CSR + labels + flags) under `key`."""
    p = _path(key, cache_dir)
    arrs = dict(rowptr=g.rowptr, colidx=g.colidx,
                is_dag=np.array([g.is_dag]))
    if g.vlabels is not None:
        arrs["vlabels"] = g.vlabels
    if g.elabels is not None:
        arrs["elabels"] = g.elabels
    tmp = p + ".tmp.npz"
    with open(tmp, "wb") as f:
        np.savez(f, **arrs)
    os.replace(tmp, p)
    return p


def load_graph(key: str, cache_dir: Optional[str] = None):
    """Load a cached HostGraph, or None on miss."""
    from ..core.graph import HostGraph
    p = _path(key, cache_dir)
    if not os.path.exists(p):
        return None
    z = np.load(p)
    return HostGraph(rowptr=z["rowptr"], colidx=z["colidx"],
                     vlabels=z["vlabels"] if "vlabels" in z else None,
                     elabels=z["elabels"] if "elabels" in z else None,
                     is_dag=bool(z["is_dag"][0]), name=key)


def cached_graph(key: str, build, cache_dir: Optional[str] = None):
    """load_graph(key) or build-and-save. `build` is a zero-arg callable."""
    g = load_graph(key, cache_dir)
    if g is not None:
        return g
    g = build()
    save_graph(key, g, cache_dir)
    return g


def enable_compile_cache() -> None:
    """Persistent XLA-executable cache, so a second process skips the
    compiles of the first (the reference has no JIT; its 'compile once' is
    the C++ build). Where JAX_COMPILATION_CACHE_DIR is set, JAX reads it
    itself and nothing is set here; otherwise executables go to
    <checkout>/.jax_cache."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    import jax
    jax.config.update("jax_compilation_cache_dir", CHECKOUT_JAX_CACHE)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
