"""Plan-interpreting frontier engine.

Executes a core.plan.Plan over chunks of edge tasks — the device redesign of the
reference's two execution strategies in one engine:

* the generated DFS nested loops (src/*/cpu_kernels/*.h, clique4_warp_edge.cuh)
  become a statically-unrolled recursion over plan levels, one batched chunk of
  embeddings per step instead of one embedding per warp;
* the Pangolin BFS extend (extend_alloc → scan → extend_insert,
  src/pangolin/clique/base.cu:16-226) becomes the level-expansion primitive:
  candidate tiles [B, W] are compacted with a cumsum+scatter into a dense
  frontier, which is consumed in fixed-size sub-chunks by a lax.while_loop —
  so deep levels do O(#live embeddings) work, not O(B · W^depth).

Shape discipline: every array is static-shape; only while-loop trip counts are
data dependent. A dead embedding is marked by SENTINEL in its newest vertex
slot and contributes exactly 0 everywhere.

Why there is no generic cmap here (design decision, measured): the
reference's cmap (include/cmap.h) is an O(1) per-candidate membership
probe. Batched on a device, a per-candidate bitmap probe is a dependent
dynamic gather (take_along_axis) per candidate, not cheaper than the
O(w^2) broadcast compare it would replace (ops/ring.py
_tail_pairs_partials note). The device counterpart is restructuring
membership into bulk popcount(row AND) over packed core bitmaps, which is
exactly what the specialized engines do (ops/hubcore, stream, ring,
cliquek, cliquebig, tri_support); the interpreter keeps the vectorized
set-algebra path for arbitrary plans.

Two engines are kept:
  engine="compact"  (default) — compaction + while_loop, fast and scalable
  engine="map"      — direct nested lax.map over candidate slots; simple,
                      used as a differential reference in tests
"""
from __future__ import annotations

import functools
from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp

from ..core.device_graph import DeviceGraph
from ..core.plan import Plan, Level
from ..ops import setops
from ..utils.exec import sum_chunked, pad_to_chunks
from ..types import SENTINEL, cdiv


def _build_candidates(dg: DeviceGraph, lp: Level, verts: List[jax.Array],
                      sets: Dict[int, jax.Array], width: int,
                      backend: str, cand: Optional[jax.Array] = None,
                      idx: int = 0, wf: Optional[int] = None,
                      cand_sets: Optional[Dict[int, jax.Array]] = None):
    """Candidate tile C [B, w] for the next vertex + optional upper bound.
    Rows of dead embeddings (newest vertex == SENTINEL) come out all-SENTINEL.

    width: tile width for rows of the edge-task endpoints v0/v1 (and sets
    derived from them) — the task's degree class under bucketed execution.
    wf: full width for rows of deeper vertices (candidates can be hubs of any
    degree, so their rows must never be truncated); defaults to width.
    cand: optional [k, V] int8 per-query-vertex candidate bitmap (the query
    workload's GQL/NLF filter, filter.cc parity) — candidates with
    cand[idx][v] == 0 are masked out."""
    wf = wf or width

    def row_w(j: int) -> int:
        return width if j < 2 else wf

    kind, j = lp.source
    if kind == 'adj':
        c = dg.gather_rows(verts[j], row_w(j))
    elif kind == 'cand':
        # candidate-set-indexed execution (query_plan.h:10 GQL ordering):
        # iterate the small GLOBAL filtered candidate list of this level and
        # probe adjacency, instead of gathering full rows and masking
        c = jnp.broadcast_to(cand_sets[j][None, :],
                             (verts[0].shape[0], cand_sets[j].shape[0]))
    else:
        c = sets[j]
    for j in lp.intersect:
        c = setops.intersect(c, dg.gather_rows(verts[j], row_w(j)),
                             backend=backend)
    for j in lp.difference:
        c = setops.difference(c, dg.gather_rows(verts[j], row_w(j)),
                              backend=backend)
    if lp.exclude:
        anc = jnp.stack([verts[j] for j in lp.exclude], axis=1)
        c = setops.exclude(c, anc)
    if lp.vlabel is not None:
        c = jnp.where(dg.labels_of(c) == lp.vlabel, c, SENTINEL)
    if cand is not None:
        v = cand.shape[1]
        ok = cand[idx][jnp.clip(c, 0, v - 1)] != 0
        c = jnp.where(ok & (c != SENTINEL), c, SENTINEL)
    if lp.lbound:  # symmetry order v > max(v_j) (vertex_gen.py:83-100)
        lower = functools.reduce(jnp.maximum, [verts[j] for j in lp.lbound])
        c = jnp.where(c > lower[:, None], c, SENTINEL)
    upper = None
    if lp.bound:
        upper = functools.reduce(jnp.minimum, [verts[j] for j in lp.bound])
    dead = verts[-1][:, None] == SENTINEL
    c = jnp.where(dead, SENTINEL, c)
    return c, upper


def _is_pair_collapse(plan: Plan, idx: int) -> bool:
    """True when level idx stores a set S and the final level just
    re-enumerates S with bound v_{idx} (ordered pairs inside S) — then
    Σ_{v∈S} |{u ∈ S : u < v}| = n(n-1)/2 with n = |S|. (The diamond
    shortcut — reference counts these pairs explicitly, diamond.h:7-11.)"""
    if idx != plan.k - 2:              # level idx must be second-to-last
        return False
    lvl = idx - 2
    nxt = plan.levels[lvl + 1]
    cur = plan.levels[lvl]
    return (cur.store and nxt.source == ('set', idx)
            and nxt.bound == (idx,) and not nxt.intersect
            and not nxt.difference and not nxt.exclude)


def _final_count(c: jax.Array, upper, last_vert: jax.Array) -> jax.Array:
    cnt = setops.count_valid(c, upper)
    return jnp.where(last_vert == SENTINEL, 0, cnt).astype(jnp.int64)


# --------------------------------------------------------------------------
# engine = "map": nested lax.map over candidate slots (reference engine)
# --------------------------------------------------------------------------

def _descend_map(dg, plan, idx, verts, sets, width, backend,
                 cand=None, wf=None, cand_sets=None) -> jax.Array:
    lp = plan.levels[idx - 2]
    c, upper = _build_candidates(dg, lp, verts, sets, width, backend,
                                 cand, idx, wf, cand_sets)

    if idx == plan.k - 1:
        return _final_count(c, upper, verts[-1])

    if upper is not None:
        c = setops.bounded(c, upper)

    if _is_pair_collapse(plan, idx):
        n = setops.count_valid(c).astype(jnp.int64)
        return n * (n - 1) // 2

    if lp.store:
        sets = dict(sets)
        sets[idx] = c

    def slot_body(col):  # [B] vertex ids for this slot
        cnt = _descend_map(dg, plan, idx + 1, verts + [col], sets, width,
                           backend, cand, wf, cand_sets)
        return jnp.where(col == SENTINEL, 0, cnt)

    per_slot = jax.lax.map(slot_body, jnp.transpose(c))  # [W, B] int64
    return jnp.sum(per_slot, axis=0)


# --------------------------------------------------------------------------
# engine = "compact": cumsum+scatter frontier compaction + while_loop
# --------------------------------------------------------------------------

def _compact(c: jax.Array) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Flatten live candidate slots into a dense frontier.

    c: [B, W] SENTINEL-masked candidates.
    Returns (vflat [B*W] vertices, pflat [B*W] parent rows, n live). Slots
    beyond n are vertex=SENTINEL / parent=0. This is the extend_alloc → scan →
    extend_insert step of the Pangolin engine as one vectorized op."""
    b, w = c.shape
    cap = b * w
    flat = c.reshape(-1)
    mask = flat != SENTINEL
    pos = jnp.cumsum(mask) - 1
    n = pos[-1] + 1
    tgt = jnp.where(mask, pos, cap)  # out-of-range → dropped
    vflat = jnp.full((cap,), SENTINEL, jnp.int32).at[tgt].set(flat, mode='drop')
    parents = jax.lax.broadcasted_iota(jnp.int32, (b, w), 0).reshape(-1)
    pflat = jnp.zeros((cap,), jnp.int32).at[tgt].set(parents, mode='drop')
    return vflat, pflat, n.astype(jnp.int32)


def _descend_compact(dg, plan, idx, emb, sets, width, sub, backend,
                     cand=None, wf=None, cand_sets=None) -> jax.Array:
    """emb: [B, idx] embeddings (row = (v0..v_{idx-1})); returns int64 scalar."""
    b = emb.shape[0]
    verts = [emb[:, j] for j in range(idx)]
    lp = plan.levels[idx - 2]
    c, upper = _build_candidates(dg, lp, verts, sets, width, backend,
                                 cand, idx, wf, cand_sets)

    if idx == plan.k - 1:
        return jnp.sum(_final_count(c, upper, verts[-1]))

    if upper is not None:
        c = setops.bounded(c, upper)

    if _is_pair_collapse(plan, idx):
        n = setops.count_valid(c).astype(jnp.int64)
        return jnp.sum(n * (n - 1) // 2)

    if lp.store:
        sets = dict(sets)
        sets[idx] = c

    vflat, pflat, n = _compact(c)
    n_iters = (n + sub - 1) // sub

    def body(i, total):
        start = i * sub
        vs = jax.lax.dynamic_slice(vflat, (start,), (sub,))
        ps = jax.lax.dynamic_slice(pflat, (start,), (sub,))
        new_emb = jnp.concatenate([emb[ps], vs[:, None]], axis=1)
        new_sets = {l: s[ps] for l, s in sets.items()}
        return total + _descend_compact(dg, plan, idx + 1, new_emb, new_sets,
                                        width, sub, backend, cand, wf,
                                        cand_sets)

    # init carry derives from emb so its sharding metadata (vma) matches the
    # shard-varying body output under shard_map; XLA folds the 0* away
    init = (0 * emb[0, 0]).astype(jnp.int64)
    return jax.lax.fori_loop(0, n_iters, body, init)


# --------------------------------------------------------------------------
# drivers
# --------------------------------------------------------------------------

@functools.partial(jax.jit,
                   static_argnames=("plan", "width", "chunk", "backend", "wf"))
def _count_device_map(dg: DeviceGraph, src, dst, cand=None, cand_sets=None,
                      *, plan: Plan, width: int, chunk: int, backend: str,
                      wf: Optional[int] = None) -> jax.Array:
    def fn(s, d):
        return _descend_map(dg, plan, 2, [s, d], {}, width, backend, cand,
                            wf, cand_sets)
    return sum_chunked(fn, (src, dst), chunk)


@functools.partial(jax.jit,
                   static_argnames=("plan", "width", "chunk", "sub",
                                    "backend", "wf"))
def _count_device_compact(dg: DeviceGraph, src, dst, cand=None,
                          cand_sets=None, *, plan: Plan,
                          width: int, chunk: int, sub: int,
                          backend: str, wf: Optional[int] = None) -> jax.Array:
    srcs, dsts = pad_to_chunks((src, dst), chunk)

    def body(xs):
        s, d = xs
        emb = jnp.stack([s, d], axis=1)
        return _descend_compact(dg, plan, 2, emb, {}, width, sub, backend,
                                cand, wf, cand_sets)

    return jnp.sum(jax.lax.map(body, (srcs, dsts)))


@functools.partial(jax.jit,
                   static_argnames=("plans", "width", "chunk", "sub",
                                    "backend", "wf"))
def _count_device_multi(dg: DeviceGraph, src, dst, *, plans, width: int,
                        chunk: int, sub: int, backend: str,
                        wf: Optional[int] = None) -> jax.Array:
    """Evaluate SEVERAL plans over the same edge-task chunks in ONE device
    program — the device analogue of the reference's fused multi-counter motif
    DFS (src/motif/gpu_kernels/ automine_5motif, 21 counters in one kernel).
    Plans sharing a level-2 op signature share the level-2 candidate build
    via XLA common-subexpression elimination; the graph, task list, chunking
    and dispatch are shared outright. Returns int64 [len(plans)]."""
    srcs, dsts = pad_to_chunks((src, dst), chunk)

    def body(xs):
        s, d = xs
        emb = jnp.stack([s, d], axis=1)
        return jnp.stack([
            _descend_compact(dg, p, 2, emb, {}, width, sub, backend,
                             None, wf) for p in plans])

    return jnp.sum(jax.lax.map(body, (srcs, dsts)), axis=0)


def count_patterns_fused(g, plans, chunk: int = 2048,
                         sub: Optional[int] = None, backend: str = "auto",
                         bucketed: Optional[bool] = None) -> list:
    """Count many patterns in shared passes: plans are grouped by their
    edge-task shape (symmetry breaking / DAG use); each group shares host
    prep, the device graph, the task list, and ONE compiled multi-plan
    program per width class. Returns counts aligned with `plans`."""
    import numpy as np
    from ..utils.profiling import PROFILER
    out = [None] * len(plans)
    groups = {}
    for i, p in enumerate(plans):
        groups.setdefault((p.use_dag, p.edge_sym_break), []).append(i)
    for (use_dag, sym), idxs in groups.items():
        gg = g.orientation() if use_dag and not g.is_dag else g
        dg = DeviceGraph.from_host(gg)
        src, dst = gg.edge_list(sym_break=sym)
        wf = max(8, gg.max_degree)
        group_plans = tuple(plans[i] for i in idxs)
        PROFILER.count("edge_tasks", int(src.shape[0]) * len(group_plans))
        buck = bucketed if bucketed is not None else wf > 64

        def run(s, d, w, ck):
            return _count_device_multi(dg, s, d, plans=group_plans, width=w,
                                       chunk=ck, sub=sub or ck,
                                       backend=backend, wf=wf)

        with PROFILER.phase("device_count"):
            if not buck:
                totals = np.asarray(run(jnp.asarray(src), jnp.asarray(dst),
                                        wf, chunk))
            else:
                from ..utils.bucketing import width_class, pick_chunk
                deg = np.diff(gg.rowptr)
                cls, widths = width_class(np.maximum(deg[src], deg[dst]), wf)
                order = np.argsort(cls, kind="stable")
                src, dst, cls = src[order], dst[order], cls[order]
                bounds = np.searchsorted(cls, np.arange(len(widths) + 1))
                totals = np.zeros(len(group_plans), dtype=np.int64)
                for ci in range(len(widths)):
                    b, e = int(bounds[ci]), int(bounds[ci + 1])
                    if b == e:
                        continue
                    ck = pick_chunk(e - b, max_chunk=chunk)
                    totals += np.asarray(run(jnp.asarray(src[b:e]),
                                             jnp.asarray(dst[b:e]),
                                             widths[ci], ck))
        for j, i in enumerate(idxs):
            out[i] = int(totals[j]) // plans[i].multiplicity
    return out


def _plan_refs_deep_rows(plan: Plan) -> bool:
    """True when any level gathers the adjacency row of a vertex matched at
    level >= 2 (a candidate, whose degree is unbounded by the task class)."""
    for lp in plan.levels:
        kind, j = lp.source
        if kind == 'adj' and j >= 2:
            return True
        if any(x >= 2 for x in lp.intersect) or \
           any(x >= 2 for x in lp.difference):
            return True
    return False


def count_pattern(g, plan: Plan, chunk: int = 2048, sub: Optional[int] = None,
                  backend: str = "auto", width: Optional[int] = None,
                  engine: str = "compact", cand=None,
                  bucketed: Optional[bool] = None,
                  cand_sets: Optional[Dict[int, "jax.Array"]] = None,
                  tasks=None) -> int:
    """End-to-end: host preprocessing per the plan, then chunked device count.

    bucketed=True groups edge tasks by the degree class of their endpoints
    and runs one fixed-width variant per class — candidate tiles then track
    the task's real degrees instead of max_degree (the device analogue of the
    reference's warp/CTA strategy dispatch, common.mk:73-74,100-104 and
    rectangle_nested_balanced.cuh work distribution). Rows of deeper-level
    vertices are still gathered at full width (wf) for exactness. Defaults
    to on when the graph's max degree is > 4x the class it would pick.

    cand: optional numpy bool/int8 [k, V] candidate matrix (query workload's
    GQL/NLF/k-core filter) — restricts both the edge-task list (v0/v1) and
    every level's candidate tiles.
    tasks: optional explicit (src, dst) edge-task arrays (already in g's id
    space, consistent with the plan's symmetry breaking) — used by hybrid
    engines that split the task list across strategies (e.g. the 4-clique
    core/tail split, ops/clique4.py)."""
    import numpy as np
    from ..utils.profiling import PROFILER
    if plan.use_dag and not g.is_dag:
        assert tasks is None, "explicit tasks must come with the final graph"
        with PROFILER.phase("orient"):
            g = g.orientation()
    with PROFILER.phase("prep"):
        dg = DeviceGraph.from_host(g)
        if tasks is not None:
            src, dst = np.asarray(tasks[0]), np.asarray(tasks[1])
        else:
            src, dst = g.edge_list(sym_break=plan.edge_sym_break)
    if cand is not None:
        cand_h = np.asarray(cand).astype(np.int8)
        keep = (cand_h[0][src] != 0) & (cand_h[1][dst] != 0)
        src, dst = src[keep], dst[keep]
        cand = jnp.asarray(cand_h)
    if plan.v0_label is not None or plan.v1_label is not None:
        vl = g.vlabels.astype(src.dtype)
        keep = (vl[src] == plan.v0_label) if plan.v0_label is not None else \
            (src == src)
        if plan.v1_label is not None:
            keep &= vl[dst] == plan.v1_label
        src, dst = src[keep], dst[keep]
    wf = max(8, g.max_degree)
    if plan.k == 2:  # single-edge pattern: the task list itself is the answer
        return int(src.shape[0]) // plan.multiplicity
    # per-op accounting (reference common.h:72-74 time_ops / intersect.cc
    # call counters): every edge task runs the plan's level-2 set ops once;
    # deeper levels are data-dependent and tracked as "edge_tasks" here.
    n_ops_l2 = 1 + len(plan.levels[0].intersect) + len(plan.levels[0].difference)
    PROFILER.count("edge_tasks", int(src.shape[0]))
    PROFILER.count("set_ops_level2", int(src.shape[0]) * n_ops_l2)

    if cand_sets is not None:
        cand_sets = {k: jnp.asarray(v) for k, v in cand_sets.items()}

    def run(s, d, w, ck):
        if engine == "map":
            return _count_device_map(dg, s, d, cand, cand_sets, plan=plan,
                                     width=w, chunk=ck, backend=backend,
                                     wf=wf)
        return _count_device_compact(dg, s, d, cand, cand_sets, plan=plan,
                                     width=w, chunk=ck, sub=sub or ck,
                                     backend=backend, wf=wf)

    if bucketed is None:
        bucketed = width is None and wf > 64 and src.shape[0] > 0
    if not bucketed or width is not None:
        with PROFILER.phase("device_count"):
            total = int(run(jnp.asarray(src), jnp.asarray(dst),
                            width or wf, chunk))
        return total // plan.multiplicity

    from ..utils.bucketing import width_class, pick_chunk
    deg = np.diff(g.rowptr)
    cls, widths = width_class(np.maximum(deg[src], deg[dst]), wf)
    order = np.argsort(cls, kind="stable")
    src, dst, cls = src[order], dst[order], cls[order]
    bounds = np.searchsorted(cls, np.arange(len(widths) + 1))
    total = 0
    with PROFILER.phase("device_count"):
        for ci in range(len(widths)):
            b, e = int(bounds[ci]), int(bounds[ci + 1])
            if b == e:
                continue
            ck = pick_chunk(e - b, max_chunk=chunk)
            total += int(run(jnp.asarray(src[b:e]), jnp.asarray(dst[b:e]),
                             widths[ci], ck))
    return total // plan.multiplicity
