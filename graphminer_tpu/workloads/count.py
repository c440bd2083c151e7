"""Subgraph counting (SC) via pattern decomposition + inclusion–exclusion.

Parity: src/count/ in the reference — count-only kernels that derive pattern
counts from cheaper enumerations plus arithmetic corrections
(cpu_kernels/6path.h:1-108 and friends). The device redesign leans on the same
building blocks as the motif formula path (per-edge/per-vertex triangle
support) with closed forms where they exist, and falls back to generic
frontier-engine enumeration (plan_from_pattern) for the rest.

Conformance anchor: hourglass on citeseer = 16,034 (src/count/README.md:41),
reproduced exactly by Σ_v C(t_v,2) − 2·Σ_e C(tri_e,2).
"""
from __future__ import annotations

import numpy as np

from ..core.pattern_graph import NAMED_PATTERNS
from ..core.plan import plan_from_pattern, SGL_PLANS, clique_plan
from ..engine.frontier import count_pattern
from .motif import motif4_count, _comb2
from .triangle import triangles_per_edge, triangle_count


def _triangle_supports(g, chunk=4096):
    src, dst = g.edge_list(sym_break=True)
    tri_e = np.asarray(triangles_per_edge(g, src, dst, chunk=chunk),
                       dtype=np.int64)
    t2 = np.zeros(g.n_vertices, dtype=np.int64)
    np.add.at(t2, src, tri_e)
    np.add.at(t2, dst, tri_e)
    return tri_e, t2 // 2


def hourglass_count(g, chunk: int = 4096) -> int:
    """Two triangles sharing exactly one vertex: Σ_v C(t_v,2) − 2·Σ_e C(tri_e,2)."""
    tri_e, t_v = _triangle_supports(g, chunk)
    return int(_comb2(t_v).sum() - 2 * _comb2(tri_e).sum())


def sc_count(g, pattern: str, chunk: int = 2048) -> int:
    """Count-only subgraph counting for a named pattern.

    Routes to: closed-form decomposition (hourglass, 4-motif family) →
    hand-tuned plan (SGL set, cliques) → generic generated plan."""
    p = pattern.lower()
    if p == "hourglass":
        return hourglass_count(g, chunk)
    if p in ("4path", "3star", "tailedtriangle", "tailed_triangle",
             "diamond", "4cycle"):
        m = motif4_count(g, chunk=chunk)
        key = {"tailed_triangle": "tailedtriangle"}.get(p, p)
        return m[key]
    if p in ("triangle",):
        return triangle_count(g, chunk=chunk)
    if p in ("4clique", "5clique"):
        return count_pattern(g, clique_plan(int(p[0])), chunk=chunk)
    if p in SGL_PLANS:
        return count_pattern(g, SGL_PLANS[p], chunk=chunk)
    if p in NAMED_PATTERNS:
        return count_pattern(g, plan_from_pattern(NAMED_PATTERNS[p], name=p),
                             chunk=chunk)
    raise ValueError(f"unknown pattern {pattern!r}")
