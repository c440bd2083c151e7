"""Hub-bitmap + closed-core matmul engine for edge-parallel counting.

Device redesign of two reference strategies at once:
 * the cmap/ccode connectivity map (include/cmap.h — O(1) membership test)
   becomes a per-vertex PACKED BITMAP over the high-degree core, tested with
   elementwise vector AND + population_count;
 * the matrix/ GEMM subsystem (src/matrix/omp_mm.cpp:104-215 — dense
   high-degree block counted via A@A ⊙ A) becomes a 0/1 matmul contraction
   over bit-expanded core bitmap rows.

Layout. Vertices are relabeled ascending by degree and the graph oriented
toward higher (degree, id) (graph.cc:233-279 semantics), so every out-edge
points to a HIGHER id and the core [V-C, V) is CLOSED under out-neighbors.
Each vertex row of the device table is

    [ CB: words int32 — bitmap of N+(v) ∩ core over the core universe
    | T : wt_pad int32 slots — N+(v) \\ core, sorted, SENTINEL padded ]

For an edge (u, v):
    |N+(u) ∩ N+(v)| = popcount(CB[u] & CB[v]) + |T[u] ∩ T[v]|
and T[v] is empty whenever v is in the core (closure), so every edge whose
dst lands in the core is pure popcount — and those never become gather
tasks at all. The SPOKE GEMM counts all of them (core-core AND tail-core)
in bulk, gather-free: for a vertex u with core-neighbor indicator
x_u = bits(CB[u]) ∈ {0,1}^C,

    Σ_{v ∈ N+(u) ∩ core} popcount(CB[u] & CB[v]) = x_uᵀ B x_u,

where B = [C, C] is the bit-expanded core block (row v = bits(CB[cs+v])).
Stacking rows X = bits(CB) over every u with ≥2 core out-neighbors:

    Σ_{(u,v) ∈ E, v ∈ core} |N+(u) ∩ N+(v)| = Σ sum(X ⊙ (X @ B)).

X streams through a matrix product at memory bandwidth instead of paying
a random row gather per task; on power-law graphs this covers the large
majority of edges. (This generalizes the reference's matrix/ subsystem,
src/matrix/omp_mm.cpp:104-215, from the dense high-degree block to every
hub-pointing edge.)

Only edges whose dst is OUTSIDE the core (both endpoints low-degree) remain
as gather tasks: popcount + a narrow tail broadcast-compare (tails are short
because high-degree targets live in the bitmap). All bucket groups and the
spoke GEMM run in ONE dispatch; partial sums return as int32 vectors summed
on the host in Python ints (exact for arbitrarily large totals; device int64
is unavailable without x64 mode).
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..types import SENTINEL, round_up, cdiv

# T-slot width classes (powers of four — tails are short by design).
T_CLASSES = (0, 16, 64, 256, 1024, 4096)
DEFAULT_CORE = 4096
DEFAULT_CHUNK = 32768
SMALL_CHUNK = 4096


# --------------------------------------------------------------------------
# layout construction (host, vectorized numpy — one-time per graph)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class HubLayout:
    """Device-resident hub-bitmap table for a degree-ascending oriented DAG."""
    table: jax.Array        # int32 [V, words + wt_pad]
    words: int              # core bitmap words (= padded C/32)
    core_start: int         # cs; core = ids [cs, V)
    core_size: int          # C = V - cs
    wt_pad: int             # padded T width (0 if no vertex has a tail)
    t_width: np.ndarray     # host int32 [V] — true T width per vertex
    n_vertices: int

    @property
    def row_width(self) -> int:
        return self.words + self.wt_pad


def build_hub_layout(g, core: int = DEFAULT_CORE) -> HubLayout:
    """g must be relabel_by_degree(descending=False).orientation() output."""
    assert g.is_dag, "hub layout requires the oriented DAG"
    v = g.n_vertices
    c = min(core, v)
    cs = v - c
    words = round_up(max(1, cdiv(c, 32)), 8)

    deg = np.diff(g.rowptr).astype(np.int64)
    src = np.repeat(np.arange(v, dtype=np.int64), deg)
    col = g.colidx.astype(np.int64)

    is_core_nb = col >= cs
    # T width per vertex = # out-neighbors below cs. Rows are sorted
    # ascending and core ids are the largest, so T is the row PREFIX.
    t_width = np.bincount(src[~is_core_nb], minlength=v).astype(np.int32)
    wt_max = int(t_width.max(initial=0))
    wt_pad = round_up(max(8, wt_max), 8) if wt_max else 0

    table = np.zeros((v, words + wt_pad), dtype=np.uint32)
    cu = src[is_core_nb]
    cc = col[is_core_nb] - cs
    np.bitwise_or.at(table, (cu, cc >> 5),
                     np.uint32(1) << (cc & 31).astype(np.uint32))
    if wt_pad:
        tpart = np.full((v, wt_pad), SENTINEL, dtype=np.int32)
        tu = src[~is_core_nb]
        tv = col[~is_core_nb].astype(np.int32)
        row_starts = np.concatenate(
            [[0], np.cumsum(t_width, dtype=np.int64)[:-1]])
        slot = np.arange(tu.shape[0], dtype=np.int64) - row_starts[tu]
        tpart[tu, slot] = tv
        table[:, words:] = tpart.view(np.uint32)

    table_d = jax.device_put(table.view(np.int32))
    return HubLayout(table=table_d, words=words, core_start=cs, core_size=c,
                     wt_pad=wt_pad, t_width=t_width, n_vertices=v)


# --------------------------------------------------------------------------
# task bucketing (host)
# --------------------------------------------------------------------------

def t_class_of(w: np.ndarray) -> np.ndarray:
    """Smallest T_CLASSES entry >= w (0 stays 0)."""
    bounds = np.asarray(T_CLASSES)
    idx = np.searchsorted(bounds, w, side="left")
    return bounds[idx].astype(np.int32)


@dataclasses.dataclass(frozen=True)
class TailTables:
    """Deduplicated endpoint-row tables for the tail (sub-core) edge tasks.

    Tail task lists are highly redundant (rmat18: 784k tasks over 135k
    distinct srcs / 56k distinct dsts). At prep we gather each distinct
    endpoint's table row ONCE into a compact device table; per-count
    dispatches then gather from these much smaller, cache-friendlier
    tables instead of the full [V, W] table."""
    src_rows: jax.Array     # [Ns, words + wt_pad] rows of distinct tail srcs
    dst_rows: jax.Array     # [Nd, words + wt_pad] rows of distinct tail dsts


def bucket_tail_tasks(layout: HubLayout, src: np.ndarray, dst: np.ndarray):
    """Bucket sub-core edge tasks (both endpoints outside the core) for the
    fused dispatch. Tasks are re-indexed against deduplicated endpoint-row
    tables (TailTables) and bucketed by tail-width class
    (t_class(wt_u), t_class(wt_v)); wa == 0 or wb == 0 means one side's T is
    empty and the kernel is popcount-only. Sorted by dst index for gather
    locality.

    Returns (TailTables, [(src_idx_tasks, dst_idx_tasks, wa, wb), ...])."""
    us, si = np.unique(src, return_inverse=True)
    ud, di = np.unique(dst, return_inverse=True)
    tables = TailTables(
        src_rows=layout.table[jnp.asarray(us.astype(np.int64))],
        dst_rows=layout.table[jnp.asarray(ud.astype(np.int64))])
    si = si.astype(np.int32)
    di = di.astype(np.int32)
    wa = t_class_of(layout.t_width[src])
    wb = t_class_of(layout.t_width[dst])
    # popcount-only tasks all share one bucket regardless of one-sided width
    wa = np.where(np.minimum(wa, wb) == 0, 0, wa)
    wb = np.where(np.minimum(wa, wb) == 0, 0, wb)
    key = wa.astype(np.int64) * 8192 + wb
    o = np.lexsort((di, key))
    si, di, key = si[o], di[o], key[o]
    groups = []
    if key.size:
        change = np.nonzero(np.diff(key))[0] + 1
        starts = np.concatenate([[0], change])
        stops = np.concatenate([change, [key.shape[0]]])
        for b, e in zip(starts, stops):
            groups.append((si[b:e], di[b:e],
                           int(key[b] // 8192), int(key[b] % 8192)))
    return tables, groups


def pack_groups(groups, chunk: int = DEFAULT_CHUNK):
    """Pad each group's task-index arrays to a chunk multiple, reshape to
    [n_chunks, chunk], and ship to device. Small groups drop to SMALL_CHUNK
    to bound padding waste (two chunk shapes total → few compiled variants).
    Returns (device_arrays, static_spec); spec = ((wa, wb, ck), ...)."""
    arrs, spec = [], []
    for src, dst, wa, wb in groups:
        n = src.shape[0]
        ck = chunk if n > chunk // 2 else min(SMALL_CHUNK, chunk)
        n_chunks = max(1, cdiv(n, ck))
        pad = n_chunks * ck - n
        s = np.pad(src.astype(np.int32), (0, pad), constant_values=SENTINEL)
        d = np.pad(dst.astype(np.int32), (0, pad), constant_values=SENTINEL)
        arrs.append((jnp.asarray(s.reshape(n_chunks, ck)),
                     jnp.asarray(d.reshape(n_chunks, ck))))
        spec.append((wa, wb, ck))
    return tuple(arrs), tuple(spec)


# --------------------------------------------------------------------------
# device kernels
# --------------------------------------------------------------------------

def _gather_rows(table, ids, width: int, words: int):
    """Gather [B, width] prefix rows; invalid ids (e.g. SENTINEL task
    padding) -> bitmap part 0 and T part SENTINEL, contributing exactly 0."""
    v = table.shape[0]
    safe = jnp.clip(ids, 0, v - 1)
    ok = (ids >= 0) & (ids < v)
    rows = table[:, :width][safe]
    bm = jnp.where(ok[:, None], rows[:, :words], 0)
    if width > words:
        t = jnp.where(ok[:, None], rows[:, words:], SENTINEL)
        return bm, t
    return bm, None


def _chunk_counts(src_rows, dst_rows, words: int, wa: int, wb: int, su, dv):
    """Per-chunk int32 Σ of |N+(u) ∩ N+(v)| over the task chunk (su, dv) —
    indices into the deduplicated TailTables."""
    bmu, tu = _gather_rows(src_rows, su, words + wa, words)
    bmv, tv = _gather_rows(dst_rows, dv, words + wb, words)
    hub = jnp.sum(jax.lax.population_count(bmu & bmv), dtype=jnp.int32)
    if tu is None or tv is None:
        return hub
    # broadcast-compare tail intersection; a-side SENTINEL slots are invalid
    # (real ids never equal SENTINEL, so b-side padding can't false-match)
    m = jnp.any(tu[:, :, None] == tv[:, None, :], axis=-1) & (tu != SENTINEL)
    return hub + jnp.sum(m, dtype=jnp.int32)


def _tail_partials_body(src_rows, dst_rows, group_arrays, spec, words: int):
    outs = []
    for (schunks, dchunks), (wa, wb, _ck) in zip(group_arrays, spec):
        body = functools.partial(_chunk_counts, src_rows, dst_rows, words,
                                 wa, wb)
        outs.append(jax.lax.map(lambda xs: body(xs[0], xs[1]),
                                (schunks, dchunks)))
    return jnp.concatenate(outs) if outs else jnp.zeros((1,), jnp.int32)


@functools.partial(jax.jit, static_argnames=("spec", "words"))
def _tail_partials(src_rows, dst_rows, group_arrays, *, spec, words: int):
    """ONE dispatch over all bucket groups -> int32 per-chunk partial sums
    concatenated across groups. Per-chunk bound: chunk * max_count < 2^31."""
    return _tail_partials_body(src_rows, dst_rows, group_arrays, spec, words)


def _expand_bits(rows, cpad: int, dtype=jnp.bfloat16):
    """[n, words] int32 -> [n, words*32] 0/1 of `dtype`; column w*32+b = bit b
    of word w = core-local vertex id w*32+b (same order as the bitmap packing
    in build_hub_layout). bfloat16 by default: 0/1 products are exact, and
    with f32 accumulation every integer below 2^24 is exact."""
    shifts = jax.lax.broadcasted_iota(jnp.int32, (1, 1, 32), 2)
    bits = jax.lax.shift_right_logical(rows[:, :, None], shifts) & 1
    return bits.reshape(rows.shape[0], cpad).astype(dtype)


def _spoke_gemm_body(table, spoke, words: int, c: int, tile: int):
    """Σ_{(u,v) ∈ E, v ∈ core} |N+(u) ∩ N+(v)| = Σ_u x_uᵀ B x_u
    = sum(B ⊙ (XᵀX)) — the gather-free matmul path (module docstring) in Gram
    form: ONE [cpad, N] @ [N, cpad] contraction whose output is the tiny
    [cpad, cpad] co-occurrence matrix, masked by the core adjacency bits and
    reduced. B is read once and there is no per-row epilogue (measured ~3x
    the throughput of the X ⊙ (X @ B) form, which re-streams B per row tile).

    spoke = [N, words] compacted bitmap rows of every vertex with ≥2 core
    out-neighbors, N % tile == 0 (zero pad rows contribute 0). Returns int32
    per-core-row partials [cpad] (row sum <= C·N < 2^31 for N < 2^19; larger
    N is sliced so each Gram accumulation stays < 2^24 per entry — exact in
    f32 — and row sums stay < 2^31).

    Exactness: 0/1 operands exact in bf16; per-slice Gram entries are counts
    <= slice rows <= 2^22 < 2^24, accumulated exactly in f32 by the matmul,
    then promoted to int32 (verified bit-exact vs numpy)."""
    v = table.shape[0]
    cpad = words * 32
    bbits = table[v - c:, :words]                       # packed core rows
    n = spoke.shape[0]
    # slice rows so f32 Gram entries stay exact and int32 row sums bounded
    slab = tile
    while slab < n and slab < (1 << 22) and slab * 2 * cpad * 2 < (1 << 30):
        slab *= 2
    n_slabs = cdiv(n, slab)
    np_ = n_slabs * slab
    spoke_p = jnp.pad(spoke, ((0, np_ - n), (0, 0))) if np_ > n else spoke

    def body(i, gram):
        rows = _expand_bits(
            jax.lax.dynamic_slice(spoke_p, (i * slab, 0), (slab, words)),
            cpad)
        g = jax.lax.dot_general(rows, rows, (((0,), (0,)), ((), ())),
                                preferred_element_type=jnp.float32)
        return gram + g.astype(jnp.int32)

    gram = jax.lax.fori_loop(
        0, n_slabs, body, jnp.zeros((cpad, cpad), jnp.int32))
    # mask by core adjacency: B[i, j] = bit j of core row i (rows i >= c are
    # absent -> masked to 0); row sums <= C * N < 2^31
    mask = _expand_bits(bbits, cpad, dtype=jnp.int32)   # [c, cpad]
    masked = gram[:c, :] * mask
    return jnp.sum(masked, axis=1, dtype=jnp.int32)


@functools.partial(jax.jit, static_argnames=("words", "c", "tile"))
def _spoke_gemm_partials(table, spoke, *, words: int, c: int, tile: int):
    return _spoke_gemm_body(table, spoke, words, c, tile)


@functools.partial(jax.jit, static_argnames=("spec", "words", "c", "tile"))
def _fused_partials(table, spoke, src_rows, dst_rows, group_arrays, *, spec,
                    words: int, c: int, tile: int):
    """Tail groups + spoke GEMM in ONE dispatch -> (tail_partials,
    spoke_partials). One dispatch and one host pull per count."""
    tails = _tail_partials_body(src_rows, dst_rows, group_arrays, spec, words)
    spokes = _spoke_gemm_body(table, spoke, words, c, tile)
    return tails, spokes


# --------------------------------------------------------------------------
# engine
# --------------------------------------------------------------------------

class TriangleEngine:
    """Prepared single-dispatch triangle counter over the hub layout.

    Parity: the fused fast path for src/triangle (omp_base.cc:5-27 /
    bs_warp_edge.cuh) and src/matrix/omp_mm.cpp in one engine. The heavy
    prep (relabel, orient, layout build, spoke compaction, bucketing)
    happens once; count() is one fused dispatch:
      * spoke GEMM — every edge whose dst is in the core, gather-free matmul;
      * gather groups — only edges with BOTH endpoints outside the core
        (popcount + short tail compare)."""

    def __init__(self, g, core: int = DEFAULT_CORE,
                 chunk: int = DEFAULT_CHUNK, tile: int = 512):
        if g.is_dag:
            raise ValueError("TriangleEngine wants the undirected graph")
        rg = g.relabel_by_degree(descending=False).orientation()
        self.g = rg
        self.layout = build_hub_layout(rg, core=core)
        lay = self.layout
        self._tile = tile
        self.spoke = self._build_spoke(rg, lay, tile)
        src, dst = rg.edge_list()
        cs = lay.core_start
        tail = dst < cs          # dst >= cs edges all live in the spoke GEMM
        self.tables, groups = bucket_tail_tasks(lay, src[tail], dst[tail])
        self.group_arrays, self.spec = pack_groups(groups, chunk=chunk)
        self.n_tail_tasks = int(tail.sum())

    @staticmethod
    def _build_spoke(rg, lay: HubLayout, tile: int) -> jax.Array:
        """Compact the bitmap rows with >=2 core out-neighbors (others
        contribute 0 to x_uᵀ B x_u), pad the row count to a tile multiple."""
        deg = np.diff(rg.rowptr)
        keep = np.nonzero(deg - lay.t_width >= 2)[0].astype(np.int32)
        n = round_up(max(int(keep.shape[0]), 1), tile)
        rows = lay.table[jnp.asarray(keep), :lay.words]   # one-time gather
        return jnp.pad(rows, ((0, n - keep.shape[0]), (0, 0)))

    def count_tail(self) -> int:
        """Edges with both endpoints outside the core (gather groups)."""
        lay = self.layout
        if not self.group_arrays:
            return 0
        parts = _tail_partials(self.tables.src_rows, self.tables.dst_rows,
                               self.group_arrays, spec=self.spec,
                               words=lay.words)
        return int(np.asarray(parts, dtype=np.int64).sum())

    def count_core(self) -> int:
        """Edges whose dst is in the core (spoke GEMM)."""
        lay = self.layout
        if lay.core_size < 1:
            return 0
        parts = _spoke_gemm_partials(lay.table, self.spoke, words=lay.words,
                                     c=lay.core_size, tile=self._tile)
        return int(np.asarray(parts, dtype=np.int64).sum())

    def count(self) -> int:
        lay = self.layout
        if not self.group_arrays:
            return self.count_core()
        if lay.core_size < 1:
            return self.count_tail()
        tails, spokes = _fused_partials(lay.table, self.spoke,
                                        self.tables.src_rows,
                                        self.tables.dst_rows,
                                        self.group_arrays,
                                        spec=self.spec, words=lay.words,
                                        c=lay.core_size, tile=self._tile)
        return (int(np.asarray(tails, dtype=np.int64).sum())
                + int(np.asarray(spokes, dtype=np.int64).sum()))


def triangle_count_fast(g, core: int = DEFAULT_CORE,
                        chunk: int = DEFAULT_CHUNK) -> int:
    """Exact TC via the hub-bitmap + closed-core matmul engine."""
    return TriangleEngine(g, core=core, chunk=chunk).count()
