"""k-motif counting (k-MC): all induced connected k-vertex pattern counts.

Parity: src/motif/ in the reference — the *formula* backend
(omp_formula.cc:39-47, cmap_formula.h): enumerate only the expensive patterns
(triangles per edge, 4-cliques, 4-cycles), derive the rest arithmetically by
inclusion–exclusion over non-induced counts. This maps perfectly onto an accelerator:
two frontier-engine enumerations + batched per-edge intersect counts + dense
degree arithmetic, instead of 6 nested-loop passes.

Counts are exact and match the reference's README tables
(src/motif/README.md:49-60) — verified on citeseer in tests.
"""
from __future__ import annotations

from typing import Dict

import jax.numpy as jnp
import numpy as np

from ..core.plan import clique_plan, RECTANGLE
from ..engine.frontier import count_pattern
from .triangle import triangle_count, triangles_per_edge

MOTIF3_NAMES = ("wedge", "triangle")
MOTIF4_NAMES = ("4path", "3star", "4cycle", "tailedtriangle", "diamond", "4clique")


def _comb2(x):
    return x * (x - 1) // 2


def _comb3(x):
    return x * (x - 1) * (x - 2) // 6


def motif3_count(g, chunk: int = 4096, fast: bool = False) -> Dict[str, int]:
    """Induced 3-motifs: wedges = Σ C(d,2) − 3T, triangles = T."""
    if fast:
        from ..ops.ring import triangle_count_ring
        t = triangle_count_ring(g)
    else:
        t = triangle_count(g, chunk=chunk)
    d = g.degrees().astype(np.int64)
    wedges = int(_comb2(d).sum()) - 3 * t
    return {"wedge": wedges, "triangle": t}


def motif4_count(g, chunk: int = 2048, fast: bool = False) -> Dict[str, int]:
    """Induced 4-motifs via pattern decomposition.

    Non-induced building blocks:
      k4        — 4-clique enumeration (DAG frontier engine)
      c4_ni     — rectangle enumeration (= C4 + D + 3·K4)
      diamond_ni = Σ_e C(tri_e, 2)
      tt_ni      = Σ_v t_v (d_v − 2)
      p4_ni      = Σ_e (d_u−1)(d_v−1) − 3T
      s3_ni      = Σ_v C(d_v, 3)
    then invert the containment matrix (verified against brute force).

    fast=True rides the fast engines for the expensive terms: tri_e from
    the hi/lo-core tri-support pass (ops/tri_support.py) and K4 from the
    hi/lo matmul clique engine (ops/cliquek.py). All degree/tri formulas are
    relabel-invariant, so they are evaluated in tri_support's
    degree-ascending id space (d = sorted degrees)."""
    if fast:
        from ..ops.cliquek import cliquek_count_fast
        from ..ops.tri_support import tri_support
        ts = tri_support(g)
        src, dst = ts.src, ts.dst
        tri_e = ts.tri.astype(np.int64)
        d = np.sort(g.degrees().astype(np.int64))   # ascending relabel
        nv = ts.n_vertices
        k4 = cliquek_count_fast(g, 4)
    else:
        d = g.degrees().astype(np.int64)
        nv = g.n_vertices
        src, dst = g.edge_list(sym_break=True)
        tri_e = np.asarray(triangles_per_edge(g, src, dst, chunk=chunk),
                           dtype=np.int64)
        k4 = count_pattern(g, clique_plan(4), chunk=chunk)
    t_total = int(tri_e.sum()) // 3

    # per-vertex triangle participation: each triangle at v contributes to 2
    # of v's incident edges
    t2 = np.zeros(nv, dtype=np.int64)
    np.add.at(t2, src, tri_e)
    np.add.at(t2, dst, tri_e)
    t_v = t2 // 2

    if fast:
        # round 5: the max-anchored codegree engine (ops/rectangle.py)
        # replaces the frontier for the last expensive building block —
        # every motif4 term now has a fast-engine path
        from ..ops.rectangle import rectangle_count_fast
        c4_ni = rectangle_count_fast(g)
    else:
        c4_ni = count_pattern(g, RECTANGLE, chunk=chunk)

    diamond_ni = int(_comb2(tri_e).sum())
    tt_ni = int((t_v * (d - 2)).sum())
    p4_ni = int(((d[src] - 1) * (d[dst] - 1)).sum()) - 3 * t_total
    s3_ni = int(_comb3(d).sum())

    K4 = k4
    D = diamond_ni - 6 * K4
    C4 = c4_ni - D - 3 * K4
    TT = tt_ni - 4 * D - 12 * K4
    S3 = s3_ni - TT - 2 * D - 4 * K4
    P4 = p4_ni - 2 * TT - 4 * C4 - 6 * D - 12 * K4
    return {"4path": P4, "3star": S3, "4cycle": C4, "tailedtriangle": TT,
            "diamond": D, "4clique": K4}


# --------------------------------------------------------------------------
# generic k-motif counting: non-induced enumeration + containment inversion
# --------------------------------------------------------------------------
# The reference's automine_5motif (src/motif/gpu_kernels/, 21 counters) runs
# one fused DFS; here each of the 21 patterns is counted NON-induced by the
# frontier engine (plans from plan_from_pattern) or a closed form, and the
# induced vector is recovered by inverting the integer containment matrix
# N[q][p] = #spanning subgraphs of p isomorphic to q (Möbius inversion over
# the 5-vertex pattern lattice — exact, verified against brute force).

import functools as _functools
import itertools as _itertools


@_functools.lru_cache(maxsize=None)
def _connected_patterns(k: int):
    """All connected k-vertex graphs up to isomorphism, by edge count."""
    from ..core.pattern_graph import PatternGraph
    all_edges = list(_itertools.combinations(range(k), 2))
    seen = {}
    for mask in range(1, 1 << len(all_edges)):
        edges = tuple(e for i, e in enumerate(all_edges) if mask >> i & 1)
        touched = set()
        for u, v in edges:
            touched.add(u); touched.add(v)
        if len(touched) != k:
            continue
        p = PatternGraph.from_edges(edges, k)
        if not _is_connected(p):
            continue
        key = p.canonical_key()
        if key not in seen:
            seen[key] = p
    return tuple(sorted(seen.values(), key=lambda p: p.n_edges))


def _is_connected(p) -> bool:
    n = p.n_vertices
    adj = p.adjacency()
    seen = {0}
    stack = [0]
    while stack:
        u = stack.pop()
        for v in range(n):
            if adj[u, v] and v not in seen:
                seen.add(v); stack.append(v)
    return len(seen) == n


@_functools.lru_cache(maxsize=None)
def _containment_matrix(k: int) -> np.ndarray:
    """M[qi][pi] = #edge subsets E' of pattern p with (V, E') ≅ pattern q.
    Upper triangular (by edge count) with unit diagonal → exact inversion."""
    pats = _connected_patterns(k)
    keys = {p.canonical_key(): i for i, p in enumerate(pats)}
    n = len(pats)
    m = np.zeros((n, n), dtype=np.int64)
    from ..core.pattern_graph import PatternGraph
    for pi, p in enumerate(pats):
        edges = p.edges
        for mask in range(1, 1 << len(edges)):
            sub = tuple(e for i, e in enumerate(edges) if mask >> i & 1)
            touched = set()
            for u, v in sub:
                touched.add(u); touched.add(v)
            if len(touched) != k:
                continue
            q = PatternGraph.from_edges(sub, k)
            qi = keys.get(q.canonical_key())
            if qi is not None:
                m[qi, pi] += 1
    return m


def _comb(x, r):
    out = np.ones_like(x)
    for i in range(r):
        out = out * (x - i)
    for i in range(2, r + 1):
        out = out // i
    return out


def motif_generic_count(g, k: int, chunk: int = 2048):
    """Induced k-motif counts for every connected k-vertex pattern.

    Returns {PatternGraph: count}. Stars use the Σ C(d, k-1) closed form;
    every other pattern is enumerated non-induced by the frontier engine."""
    from ..core.plan import plan_from_pattern
    from ..engine.frontier import count_patterns_fused
    pats = _connected_patterns(k)
    star_key = _star_pattern(k).canonical_key()
    noninduced = np.zeros(len(pats), dtype=object)
    # all non-star patterns run FUSED: shared prep/tasks, one multi-plan
    # device program per task shape (the automine_5motif fused-counter
    # economics — src/motif/gpu_kernels/)
    enum_idx = [i for i, p in enumerate(pats)
                if p.canonical_key() != star_key]
    fused = count_patterns_fused(
        g, [plan_from_pattern(pats[i]) for i in enum_idx], chunk=chunk)
    for i, c in zip(enum_idx, fused):
        noninduced[i] = c
    for i, p in enumerate(pats):
        if p.canonical_key() == star_key:
            d = g.degrees().astype(np.int64)
            noninduced[i] = int(_comb(d, k - 1).sum())
    m = _containment_matrix(k)
    # back-substitution from the densest pattern (clique) downward; matrix is
    # upper triangular with 1s on the diagonal in edge-count order
    n = len(pats)
    induced = [0] * n
    for i in range(n - 1, -1, -1):
        acc = int(noninduced[i])
        for j in range(i + 1, n):
            acc -= int(m[i, j]) * induced[j]
        induced[i] = acc
    return {p: induced[i] for i, p in enumerate(pats)}


def _star_pattern(k: int):
    from ..core.pattern_graph import PatternGraph
    return PatternGraph.from_edges([(0, i) for i in range(1, k)], k)


# preferred display names for 5-vertex NAMED_PATTERNS entries that share a
# canonical form with an alias (e.g. pentagon == 5cycle)
_MOTIF5_PREFERRED = ("5path", "4star", "pentagon", "house", "hourglass",
                     "semihouse", "tailed_diamond", "5clique")


def motif5_count(g, chunk: int = 2048) -> Dict[str, int]:
    """All 21 induced 5-vertex motif counts, keyed by a readable name."""
    from ..core.pattern_graph import NAMED_PATTERNS
    named = {p.canonical_key(): nm for nm, p in NAMED_PATTERNS.items()
             if p.n_vertices == 5}
    for nm in _MOTIF5_PREFERRED:            # aliases resolve to these names
        named[NAMED_PATTERNS[nm].canonical_key()] = nm
    counts = motif_generic_count(g, 5, chunk=chunk)
    out = {}
    anon = 0
    for p, c in counts.items():
        nm = named.get(p.canonical_key())
        if nm is None:
            nm = f"5motif_{p.n_edges}e_{anon}"
            anon += 1
        out[nm] = c
    return out


def motif_count(g, k: int, chunk: int = 2048,
                fast: bool = False) -> Dict[str, int]:
    if k == 3:
        return motif3_count(g, chunk=chunk, fast=fast)
    if k == 4:
        return motif4_count(g, chunk=chunk, fast=fast)
    if k == 5:
        return motif5_count(g, chunk=chunk)
    raise NotImplementedError(f"k={k} motifs not yet supported (have 3, 4, 5)")
