"""Triangle counting (TC).

Parity: src/triangle/ in the reference — omp_base.cc:5-27 (vertex-parallel
Σ|N(u)∩N(v)| over the DAG) and bs_warp_edge.cuh:1-19 (edge-parallel warp
kernel). Device redesign: orient once on host, materialize the COO task list,
then a chunked edge-parallel batched intersect-count on device.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..core.device_graph import DeviceGraph
from ..ops import setops
from ..utils.exec import sum_chunked
from ..types import round_up, LANE


def _edge_tc_kernel(dg: DeviceGraph, width: int, backend: str,
                    src: jax.Array, dst: jax.Array,
                    width_b: int = None) -> jax.Array:
    a = dg.gather_rows(src, width)
    b = dg.gather_rows(dst, width_b or width)
    return setops.intersect_count(a, b, backend=backend)


@functools.partial(jax.jit,
                   static_argnames=("width", "width_b", "chunk", "backend"))
def _tc_device(dg: DeviceGraph, src, dst, *, width: int, chunk: int,
               backend: str, width_b: int = None) -> jax.Array:
    fn = functools.partial(_edge_tc_kernel, dg, width, backend,
                           width_b=width_b)
    return sum_chunked(fn, (src, dst), chunk)


def triangle_count(g, chunk: int = 16384, backend: str = "auto",
                   bucketed: bool = True) -> int:
    """Exact triangle count of an undirected graph (HostGraph).

    bucketed=True partitions edges by endpoint degree class and runs one
    fixed-width kernel per class pair (the device analogue of the reference's
    warp/CTA strategy dispatch) — the default; exactness is unaffected."""
    if not g.is_dag:
        g = g.orientation()
    dg = DeviceGraph.from_host(g)
    src, dst = g.edge_list()
    if not bucketed:
        width = max(8, g.max_degree)
        total = _tc_device(dg, jnp.asarray(src), jnp.asarray(dst),
                           width=width, chunk=chunk, backend=backend)
        return int(total)

    from ..utils.bucketing import bucket_edge_tasks, pick_chunk
    deg = np.diff(g.rowptr)
    order, groups = bucket_edge_tasks(deg[src], deg[dst], max(8, g.max_degree))
    src, dst = src[order], dst[order]
    total = 0
    for s, e, wa, wb in groups:
        c = pick_chunk(e - s, max_chunk=chunk)
        total += int(_tc_device(dg, jnp.asarray(src[s:e]), jnp.asarray(dst[s:e]),
                                width=wa, width_b=wb, chunk=c, backend=backend))
    return total


def triangle_count_fast(g, **kw) -> int:
    """Hub-bitmap + closed-core matmul engine — a fast TC path
    (ops/hubcore.py). ~5-10x the bucketed-intersect path on power-law
    graphs; exact."""
    from ..ops.hubcore import triangle_count_fast as _fast
    return _fast(g, **kw)


def triangle_count_hybrid(g, core_size: int = 16384, chunk: int = 16384,
                          backend: str = "auto") -> int:
    """Hybrid matmul/elementwise exact triangle count (the device realisation of the
    reference's matrix/ GEMM+intersection split, omp_mm.cpp:104-215).

    Ascending-degree relabel → orientation points to higher ids → the
    high-degree core [V-C, V) is closed under out-neighbors, so core-core
    edges are counted entirely by matmuls (ops/dense_core.py); edges with a
    tail endpoint go through the bucketed intersect path with small widths."""
    from ..ops.dense_core import core_triangles
    from ..utils.bucketing import bucket_edge_tasks, pick_chunk

    assert not g.is_dag, "hybrid path needs the undirected graph (it relabels)"
    rg = g.relabel_by_degree(descending=False).orientation()
    v = rg.n_vertices
    c = min(core_size, v)
    core_start = v - c

    total = core_triangles(rg, core_start)

    dg = DeviceGraph.from_host(rg)
    src, dst = rg.edge_list()
    tail = (src < core_start) | (dst < core_start)
    src, dst = src[tail], dst[tail]
    if src.size:
        deg = np.diff(rg.rowptr)
        order, groups = bucket_edge_tasks(deg[src], deg[dst],
                                          max(8, rg.max_degree))
        src, dst = src[order], dst[order]
        for s, e, wa, wb in groups:
            ck = pick_chunk(e - s, max_chunk=chunk)
            total += int(_tc_device(dg, jnp.asarray(src[s:e]),
                                    jnp.asarray(dst[s:e]),
                                    width=wa, width_b=wb, chunk=ck,
                                    backend=backend))
    return int(total)


@functools.partial(jax.jit, static_argnames=("width", "chunk", "backend"))
def _tc_per_edge_device(dg: DeviceGraph, src, dst, *, width: int, chunk: int,
                        backend: str) -> jax.Array:
    from ..utils.exec import map_chunked
    fn = functools.partial(_edge_tc_kernel, dg, width, backend)
    return map_chunked(fn, (src, dst), chunk)


def triangles_per_edge(g, src, dst, chunk: int = 4096,
                       backend: str = "auto") -> jax.Array:
    """tri_e = |N(u) ∩ N(v)| per (u,v) task on the *given* graph (use the
    undirected graph for full per-edge triangle support — the building block
    of the motif formula path and FSM edge support)."""
    dg = DeviceGraph.from_host(g)
    width = max(8, g.max_degree)
    out = _tc_per_edge_device(dg, jnp.asarray(src), jnp.asarray(dst),
                              width=width, chunk=chunk, backend=backend)
    return out[: src.shape[0]]
