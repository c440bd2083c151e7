"""k-clique counting (k-CL).

Parity: src/clique/ — automine_omp.h:2-183 (DAG nested DFS) and
clique{4,5}_warp_edge.cuh GPU kernels. Device: clique_plan(k) interpreted by the
frontier engine over the oriented DAG.
"""
from __future__ import annotations

from ..core.plan import clique_plan
from ..engine.frontier import count_pattern


def clique_count(g, k: int, chunk: int = 1024, backend: str = "auto",
                 fast: bool = False) -> int:
    """Exact k-clique count.

    fast=True routes k=4,5 through the hi/lo-split matmul clique engine
    (ops/cliquek.py — the clique4/5_warp_edge.cuh analogue), k>=6 through
    the streamed recursive hi/lo engine (ops/cliquebig.py — the OSDI
    Fig-11 large-clique path), and k=3 through the stream engine; plain
    runs use the plan-interpreting frontier."""
    assert k >= 3
    if fast and not g.is_dag:
        if k == 3:
            from ..ops.stream import triangle_count_stream
            return triangle_count_stream(g)
        if k in (4, 5):
            from ..ops.cliquek import cliquek_count_fast
            return cliquek_count_fast(g, k)
        from ..ops.cliquebig import cliquebig_count
        return cliquebig_count(g, k)
    return count_pattern(g, clique_plan(k), chunk=chunk, backend=backend)
