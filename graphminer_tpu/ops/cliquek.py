"""k-clique counting (k = 4, 5) — hi/lo-split core bilinears as matmuls.

Parity: src/clique/gpu_kernels/clique4_warp_edge.cuh:3-31 and
clique5_warp_edge.cuh (per-edge/per-triangle W = iterated N+ intersections,
then counting adjacent pairs inside W), and the OSDI Fig-11 large-clique
configurations (src/clique/README.md).

Device reformulation. Over the degree-ascending oriented DAG with the closed
core (top `core` ids), a k-clique a < b < … is anchored at its lowest edge
(a, b). If b ∈ core, every later vertex lies in the core (closure), so the
whole residual problem lives in core bitmaps:

* k = 4:  #4cl(a,b) = #DAG edges inside y₂ = CB[a] & CB[b]  = q(y₂)
* k = 5:  #5cl(a,b) = #DAG triangles inside y₂
                    = Σ_{c ∈ y₂} q(y₂ & C[c])      (per-TRIANGLE tasks)

where q(y) = Σ_{d ∈ y} popcount(C[d] & y) counts DAG edges inside y.

The bilinear q costs |core|² MACs per task if done densely — 99% wasted on
zero bits. Measured on rmat18: the TOP-1024 core ids hold 99.1% of all
wedge-bitmap bits (power law). So q is split by the smaller endpoint d:

* d ∈ HI (top `hi` ids):  the partner is forced ∈ HI (ascending DAG), so
  q_hh(y_hi) = x_hiᵀ B_hh x_hi — a [slab, hi] @ [hi, hi] matmul bilinear,
  16× fewer MACs than the full-core form at hi = 1024.
* d ∈ LO (core below hi): rare (≤ 1% of bits). Enumerated on the host into
  explicit sparse tasks; each costs one fused row-AND + popcount:
    k=4: (a, b, d)    → popcount(CB[a] & CB[b] & C[d])
    k=5: (a, b, c, d) → popcount(CB[a] & CB[b] & C[c] & C[d]),
         c ∈ y₂ ∩ IN(d) (in-neighbors of d inside the core).

If b ∉ core, both endpoints are low-out-degree sub-core vertices: those
edge tasks run the generic bucketed frontier engine with clique_plan(k).
The split is exact and disjoint.
"""
from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..types import SENTINEL, cdiv, round_up
from .hubcore import _expand_bits

CORE = 4096
HI = 1024
SLAB = 2048
CHUNK_EDGES = 1 << 16       # host bit-expansion chunk


# --------------------------------------------------------------------------
# host-side layout + task enumeration
# --------------------------------------------------------------------------

def _core_bitmaps(rg, cs: int, c: int, words: int):
    """(bm [V, words], C [c, words], INB [c, words]) uint32 host arrays:
    N+ ∩ core bitmaps for all vertices, core rows, core-internal
    in-neighbor (transpose) rows."""
    v = rg.n_vertices
    deg = np.diff(rg.rowptr).astype(np.int64)
    src = np.repeat(np.arange(v, dtype=np.int64), deg)
    col = rg.colidx.astype(np.int64)
    m = col >= cs
    bm = np.zeros((v, words), dtype=np.uint32)
    cc = (col[m] - cs).astype(np.int64)
    np.bitwise_or.at(bm, (src[m], cc >> 5),
                     np.uint32(1) << (cc & 31).astype(np.uint32))
    core = bm[cs:]
    inb = np.zeros((c, words), dtype=np.uint32)
    mm = m & (src >= cs)                      # core→core edges
    sl = (src[mm] - cs).astype(np.int64)
    np.bitwise_or.at(inb, (cc[src[m] >= cs], sl >> 5),
                     np.uint32(1) << (sl & 31).astype(np.uint32))
    return bm, core, inb


def _enum_tasks(bm: np.ndarray, core: np.ndarray, inb: np.ndarray,
                ea: np.ndarray, eb: np.ndarray, c: int, lo_cut: int,
                hi_words: int, k: int):
    """Chunked host enumeration over case-A edges.

    Returns (y2hi, tri, lo) where
      y2hi: int32 [n_edges, hi_words] — the hi-region slice of
            y₂ = CB[a] & CB[b] per case-A edge, MATERIALIZED so the
            count-time hi bilinear reads it sequentially (zero gathers for
            k=4, one aligned row gather for k=5; a column-sliced gather
            from the [V, words] table measured 50× the aligned gather wall)
      tri : k=5 only — int32 [T, 2] triangle tasks (edge_row, c_core_local)
      lo  : int32 [L, k-1] sparse lo tasks (k=4: (a,b,d); k=5: (a,b,c,d)),
            d = core-local id below the word-aligned hi cut `lo_cut`."""
    words = bm.shape[1]
    y2hi = np.empty((ea.shape[0], hi_words), dtype=np.uint32)
    tri_parts, lo_parts = [], []
    for s in range(0, ea.shape[0], CHUNK_EDGES):
        a = ea[s:s + CHUNK_EDGES].astype(np.int64)
        b = eb[s:s + CHUNK_EDGES].astype(np.int64)
        y2 = bm[a] & bm[b]
        y2hi[s:s + CHUNK_EDGES] = y2[:, words - hi_words:]
        if k == 4 and lo_cut == 0:
            continue
        if k == 4:      # only the lo words are ever enumerated
            bits = np.unpackbits(y2[:, : lo_cut // 32].view(np.uint8),
                                 axis=1, bitorder="little")
        else:
            bits = np.unpackbits(y2.view(np.uint8), axis=1,
                                 bitorder="little")
        if k == 5:
            ei, cl = np.nonzero(bits[:, :c])
            tri_parts.append(np.stack(
                [s + ei, cl.astype(np.int64)], axis=1))
        if lo_cut > 0:
            ei, dl = np.nonzero(bits[:, :lo_cut])
            if k == 4:
                lo_parts.append(np.stack(
                    [a[ei], b[ei], dl.astype(np.int64)], axis=1))
            else:
                # c ∈ y₂ ∩ IN(d): second host expansion per (edge, d) pair
                w = y2[ei] & inb[dl]
                wb = np.unpackbits(w.view(np.uint8), axis=1,
                                   bitorder="little")
                pi, cl2 = np.nonzero(wb[:, :c])
                lo_parts.append(np.stack(
                    [a[ei[pi]], b[ei[pi]], cl2.astype(np.int64),
                     dl[pi].astype(np.int64)], axis=1))
    def cat(parts, width):
        if not parts:
            return np.zeros((0, width), dtype=np.int32)
        return np.concatenate(parts).astype(np.int32)
    return y2hi.view(np.int32), cat(tri_parts, 2), cat(lo_parts, k - 1)


def _emit_all(bases, rows, attrs, words: int, n_bits: int, ncol: int,
              cap: int = 32 << 20) -> np.ndarray:
    """Collect the native expander's full output as one [n, ncol] int32
    array (resumable over the bounded buffer)."""
    from .. import native_bridge
    n = rows[0].shape[0]
    parts = []
    buf = np.empty((cap, ncol), np.int32)
    start = 0
    while start < n:
        n_em, nxt = native_bridge.expand_emit(bases, rows, attrs, words,
                                              n_bits, start, cap, buf)
        if n_em == 0 and nxt == start:
            raise RuntimeError("expander cap too small")
        if n_em:
            parts.append(buf[:n_em].copy())
        start = nxt
    return (np.concatenate(parts) if parts
            else np.zeros((0, ncol), np.int32))


def _enum_tasks_native(bm, core, inb, ea, eb, c: int, lo_cut: int,
                       hi_words: int, k: int):
    """Native (C++/OpenMP ctz) version of _enum_tasks' bit enumeration —
    the numpy unpackbits path measured 164 s (k=4) / 255 s (k=5) of prep
    on rmat18; the expander reads rows + emits tasks directly. Returns
    None when the native lib is unavailable."""
    from .. import native_bridge
    lib = native_bridge.get_lib()
    if lib is None or not hasattr(lib, "gm_expand_emit"):
        return None
    words = bm.shape[1]
    n = ea.shape[0]
    y2hi = np.empty((max(n, 1), hi_words), dtype=np.uint32)
    y2hi[:] = 0
    for s in range(0, n, CHUNK_EDGES):
        a = ea[s:s + CHUNK_EDGES].astype(np.int64)
        b = eb[s:s + CHUNK_EDGES].astype(np.int64)
        y2hi[s:s + a.shape[0]] = (bm[a] & bm[b])[:, words - hi_words:]
    ea32 = np.ascontiguousarray(ea.astype(np.int32))
    eb32 = np.ascontiguousarray(eb.astype(np.int32))
    eidx = np.arange(n, dtype=np.int32)
    tri = np.zeros((0, 2), np.int32)
    lo = np.zeros((0, k - 1), np.int32)
    if n:
        if k == 5:
            # (edge_row, c1) triangle tasks over the whole core
            tri = _emit_all([bm, bm], [ea32, eb32], [eidx], words, c, 2)
        if lo_cut > 0:
            ed = _emit_all([bm, bm], [ea32, eb32], [ea32, eb32], words,
                           lo_cut, 3)           # (a, b, d) with d < lo_cut
            if k == 4:
                lo = ed
            elif ed.shape[0]:
                # c ∈ y₂ ∩ IN(d): one more level; output (a, b, d, c) →
                # reorder to (a, b, c, d)
                abdc = _emit_all(
                    [bm, bm, inb],
                    [np.ascontiguousarray(ed[:, 0]),
                     np.ascontiguousarray(ed[:, 1]),
                     np.ascontiguousarray(ed[:, 2])],
                    [np.ascontiguousarray(ed[:, j]) for j in range(3)],
                    words, c, 4)
                lo = abdc[:, [0, 1, 3, 2]]
    return y2hi.view(np.int32), tri, lo


# --------------------------------------------------------------------------
# device kernels
# --------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("words", "hi_words"))
def _hi_adj_bf16(core_dev, *, words: int, hi_words: int):
    """B_hh [hi_dim, hi_dim] bf16: DAG adjacency among the hi-region core
    ids (the top `hi_words` WORDS of the bitmap space — word-aligned; row j
    = core-local id lo_cut + j, zero rows beyond c never match a set bit)."""
    c = core_dev.shape[0]
    hi_dim = hi_words * 32
    lo_cut = words * 32 - hi_dim
    rows = core_dev[lo_cut:, words - hi_words:]    # [c - lo_cut, hi_words]
    x = _expand_bits(rows, hi_dim)
    pad = hi_dim - (c - lo_cut)
    if pad > 0:
        x = jnp.concatenate([x, jnp.zeros((pad, hi_dim), jnp.bfloat16)])
    return x


@functools.partial(jax.jit, static_argnames=("hi_words", "slab"))
def _edge_hi_bilinear(y2hi, bhh, *, hi_words: int, slab: int):
    """k=4 hi part: Σ_e q_hh(y₂_hi) → int32 [n_slabs, 2] lo/hi-16 sums.
    y2hi: [n, hi_words] MATERIALIZED per-edge hi slices — the slab loop is
    a pure sequential stream + matmul (no gathers at all)."""
    hi = hi_words * 32
    rows = y2hi.reshape(-1, slab, hi_words)

    def body(y):
        x = _expand_bits(y, hi)
        z = jax.lax.dot_general(x, bhh, (((1,), (0,)), ((), ())),
                                preferred_element_type=jnp.float32)
        per = jnp.sum(x.astype(jnp.float32) * z, axis=1).astype(jnp.int32)
        return jnp.stack([jnp.sum(per & 0xFFFF, dtype=jnp.int32),
                          jnp.sum(per >> 16, dtype=jnp.int32)])

    return jax.lax.map(body, rows)


@functools.partial(jax.jit,
                   static_argnames=("hi_words", "tcl", "rows_step"))
def _tri_stream_bilinear(y2rows, cmat, core_hi, bhh, *, hi_words: int,
                         tcl: int, rows_step: int):
    """k=5 hi part over one triangle-count-class bucket.

    y2rows: [n, hi_words] per-edge y₂ hi slices, MATERIALIZED in task
    order — a sequential stream, no big-table gathers (the round-4
    per-task y2hi_tab gather paid the ~65 ns gather wall and capped the
    engine at ~12M tasks/s). cmat: [n, tcl] core-local c ids (SENTINEL
    padded). Each (row, slot) task computes q_hh(y₂_hi & C_hi[c]) — the
    only gather is the [c, hi_words] core table (~512 KB, cache-hot).
    Returns int32 [n_steps, 2] lo/hi-16 partial sums (rows_step * tcl
    tasks per step keeps the int32 partials exact)."""
    hi = hi_words * 32
    c = core_hi.shape[0]
    rr = y2rows.reshape(-1, rows_step, hi_words)
    cc = cmat.reshape(-1, rows_step, tcl)
    # tasks per map step (rows_step * tcl) are sized for matmul efficiency
    # (~2^18 — small steps serialize the pipeline, the r4 lax.map lesson);
    # int32 exactness comes from INNER blocks of <= 2^15 tasks
    # (per-task q < 2^16 in the lo16 lane after the split)
    block = min(1 << 15, rows_step * tcl)

    def body(xs):
        y2, cl = xs
        ok = (cl >= 0) & (cl < c)
        yc = core_hi[jnp.where(ok, cl, 0)]           # [rs, tcl, hw]
        y = jnp.where(ok[:, :, None], y2[:, None, :] & yc, 0)
        x = _expand_bits(y.reshape(-1, hi_words), hi)
        z = jax.lax.dot_general(x, bhh, (((1,), (0,)), ((), ())),
                                preferred_element_type=jnp.float32)
        per = jnp.sum(x.astype(jnp.float32) * z, axis=1).astype(jnp.int32)
        p = per.reshape(-1, block)
        return jnp.stack([jnp.sum(p & 0xFFFF, axis=1, dtype=jnp.int32),
                          jnp.sum(p >> 16, axis=1, dtype=jnp.int32)],
                         axis=1)

    return jax.lax.map(body, (rr, cc)).reshape(-1, 2)


@functools.partial(jax.jit, static_argnames=("hi_words", "slab"))
def _tri_hi_bilinear(y2hi_tab, core_hi, bhh, trow, tcl, *, hi_words: int,
                     slab: int):
    """k=5 hi part: Σ_t q_hh(y₃_hi), y₃_hi = y2hi[edge_row] & C_hi[c].
    Both gathers are full aligned rows from dedicated [*, hi_words]
    tables (a column-sliced gather from the [V, words] table measured
    ~1.2 µs/row — 50× the aligned gather wall)."""
    ne = y2hi_tab.shape[0]
    c = core_hi.shape[0]
    hi = hi_words * 32
    rr = trow.reshape(-1, slab)
    cc = tcl.reshape(-1, slab)

    def body(xs):
        r, cl = xs
        ok = (r >= 0) & (r < ne) & (cl >= 0) & (cl < c)
        ya = y2hi_tab[jnp.where(ok, r, 0)]
        yc = core_hi[jnp.where(ok, cl, 0)]
        y = jnp.where(ok[:, None], ya & yc, 0)
        x = _expand_bits(y, hi)
        z = jax.lax.dot_general(x, bhh, (((1,), (0,)), ((), ())),
                                preferred_element_type=jnp.float32)
        per = jnp.sum(x.astype(jnp.float32) * z, axis=1).astype(jnp.int32)
        return jnp.stack([jnp.sum(per & 0xFFFF, dtype=jnp.int32),
                          jnp.sum(per >> 16, dtype=jnp.int32)])

    return jax.lax.map(body, (rr, cc))


@functools.partial(jax.jit, static_argnames=("words", "chunk", "nrow"))
def _lo_popcount(bm, core_dev, cols, *, words: int, chunk: int, nrow: int):
    """Sparse lo tasks: popcount of the AND of 2 bm rows + (nrow-2) core
    rows. cols: int32 [n, nrow] (a, b, [c,] d) — padded rows SENTINEL."""
    v = bm.shape[0]
    c = core_dev.shape[0]
    xx = cols.reshape(-1, chunk, cols.shape[1])

    def body(x):
        ok = x[:, 0] >= 0
        y = bm[jnp.where(ok, x[:, 0], 0)] & \
            bm[jnp.where(ok & (x[:, 1] >= 0), x[:, 1], 0)]
        for j in range(2, x.shape[1]):
            idx = x[:, j]
            okj = ok & (idx >= 0) & (idx < c)
            y = y & core_dev[jnp.where(okj, idx, 0)]
            ok = okj
        pc = jax.lax.population_count(jnp.where(ok[:, None], y, 0))
        return jnp.sum(pc, dtype=jnp.int32)

    return jax.lax.map(body, xx)


TRI_CLASSES = (2, 8, 32, 128, 512, 2048)


def _bucket_tris(y2hi: np.ndarray, tri: np.ndarray,
                 classes=TRI_CLASSES):
    """Group per-triangle tasks by edge into triangle-count classes (the
    stream-engine bucketing applied to k=5 prefix tasks).

    tri: [T, 2] (edge_row, c) sorted by edge_row (native expander order).
    Returns [(y2rows [n, hw], cmat [n, tcl])...] — per bucket, row i holds
    one edge's y₂ hi slice and up to tcl of its c ids; edges with more
    triangles than the top class split across rows (same y₂ replicated)."""
    from .stream import _split_wide
    if tri.shape[0] == 0:
        return []
    erow = tri[:, 0].astype(np.int64)
    c1 = tri[:, 1]
    uedge, istart = np.unique(erow, return_index=True)
    tcnt = np.diff(np.concatenate([istart, [erow.shape[0]]]))
    top = classes[-1]
    rd, roff, rlen = _split_wide(uedge, tcnt, top)
    rstart = np.repeat(istart, np.maximum(1, -(-tcnt // top))) + roff
    wcl = np.asarray(classes)[np.searchsorted(classes, rlen, side="left")]
    out = []
    for wc in classes:
        m = wcl == wc
        if not m.any():
            continue
        n_d = int(m.sum())
        # rows per kernel step: step * wc tasks ~ 2^15 keeps the expanded
        # [tasks, hi] bf16 temp + f32 z small (larger steps spill them to
        # device memory); int32 partials are exact per step
        step = max(1, (1 << 15) // wc)
        npad = round_up(max(n_d, 8), max(8, step))
        cm = np.full((npad, wc), SENTINEL, dtype=np.int32)
        starts_b, lens_b = rstart[m], rlen[m]
        flat = starts_b[:, None] + np.arange(wc, dtype=np.int64)[None, :]
        valid = np.arange(wc)[None, :] < lens_b[:, None]
        cm[:n_d][valid] = c1[flat[valid]]
        rows = np.zeros((npad, y2hi.shape[1]), dtype=np.int32)
        rows[:n_d] = y2hi[rd[m]]
        rt = np.zeros(npad, dtype=np.int32)
        rt[:n_d] = lens_b
        out.append((rows, cm, step, rt))
    return out


# --------------------------------------------------------------------------
# engine
# --------------------------------------------------------------------------

def _pad_rows(x: np.ndarray, mult: int, fill=SENTINEL) -> np.ndarray:
    n = x.shape[0]
    npad = round_up(max(n, mult), mult)
    if npad == n:
        return x
    pad = np.full((npad - n,) + x.shape[1:], fill, dtype=x.dtype)
    return np.concatenate([x, pad])


class CliqueKEngine:
    """Prepared k-clique counter (k = 4 or 5) over the hi/lo core split.

    Exact: hi bilinear (matmul) + sparse lo tasks + sub-core frontier tail.
    Per-task integers < 2^24 (f32-exact); totals summed int64 on host."""

    def __init__(self, g, k: int, core: int = CORE, hi: int = 0,
                 slab: int = SLAB, tail: bool = True):
        """hi = 0 picks the default per k: 1024 for k=4 (per-edge tasks,
        bit mass in the top 1024 ids), 512 for k=5 (per-triangle tasks:
        y₃ bits concentrate harder, and the bilinear's hi² MACs/task
        dominate — 4x fewer MACs beats the small extra lo population)."""
        if not hi:
            hi = HI if k == 4 else HI // 2
        assert k in (4, 5), "bilinear fast path covers k=4,5; use the frontier"
        from ..core.plan import clique_plan
        from ..engine.frontier import count_pattern
        rg = g if g.is_dag else \
            g.relabel_by_degree(descending=False).orientation()
        self.k = k
        v = rg.n_vertices
        c = min(core, v)
        cs = v - c
        words = round_up(max(1, cdiv(c, 32)), 8)
        self.words = words
        # hi slice must reach the valid bits [0, c): hi_dim >= words*32 - c
        # (top bits are padding when c < the 8-word-rounded bit space)
        self.hi_words = min(max(1, hi // 32, words - c // 32), words)
        lo_cut = (words - self.hi_words) * 32      # word-aligned hi cut
        self.slab = slab

        bm, core_np, inb = _core_bitmaps(rg, cs, c, words)
        src, dst = rg.edge_list()
        case_a = dst >= cs
        self.n_edges = int(src.shape[0])
        ea = src[case_a].astype(np.int64)
        eb = dst[case_a].astype(np.int64)
        self.n_core_edges = int(ea.shape[0])

        self.bm = jnp.asarray(bm.view(np.int32))
        self.core = jnp.asarray(core_np.view(np.int32))
        # dedicated aligned hi-slice core table (column-sliced gathers from
        # the full-width table hit a 50×-slower misaligned path — measured)
        self.core_hi = jnp.asarray(
            np.ascontiguousarray(core_np[:, words - self.hi_words:])
            .view(np.int32))
        self.bhh = _hi_adj_bf16(self.core, words=words,
                                hi_words=self.hi_words)

        nat = _enum_tasks_native(bm, core_np, inb, ea, eb, c, lo_cut,
                                 self.hi_words, k)
        if nat is not None:
            y2hi, tri, lo = nat
        else:
            y2hi, tri, lo = _enum_tasks(bm, core_np, inb, ea, eb, c, lo_cut,
                                        self.hi_words, k)
        self.n_tri = int(tri.shape[0])
        self.n_lo = int(lo.shape[0])
        if k == 4:
            self.y2hi = jnp.asarray(_pad_rows(y2hi, slab, fill=0))
            self.tri_buckets = ()
        else:
            # per-edge grouped triangle-task buckets: the y₂ side becomes a
            # sequential materialized stream (no big-table gathers)
            self.tri_buckets = tuple(
                (jnp.asarray(rows), jnp.asarray(cm), step, rt)
                for rows, cm, step, rt in _bucket_tris(y2hi, tri))
        self.lo_cols = jnp.asarray(_pad_rows(lo, 4096)) if lo.size else None

        self.tail_total = 0
        if tail and (~case_a).any():
            self.tail_total = count_pattern(
                rg, clique_plan(k), chunk=4096,
                tasks=(src[~case_a], dst[~case_a]))

    # tasks per dispatch: host-chunking bounds each dispatch's size and
    # its output buffer.
    DISPATCH_TASKS = 16 << 20

    def _hi_total(self, args) -> int:
        outs = []
        if self.k == 4:
            (y2hi,) = args
            step = round_up(self.DISPATCH_TASKS, self.slab)
            for s in range(0, y2hi.shape[0], step):
                outs.append(_edge_hi_bilinear(y2hi[s:s + step], self.bhh,
                                              hi_words=self.hi_words,
                                              slab=self.slab))
        else:
            for rows, cm, step, _rt in args:
                tcl = int(cm.shape[1])
                # rows per dispatch: a multiple of the kernel step keeping
                # tasks/dispatch bounded
                rstep = round_up(max(step, self.DISPATCH_TASKS // tcl),
                                 step)
                for s in range(0, rows.shape[0], rstep):
                    outs.append(_tri_stream_bilinear(
                        rows[s:s + rstep], cm[s:s + rstep], self.core_hi,
                        self.bhh, hi_words=self.hi_words, tcl=tcl,
                        rows_step=step))
        total = 0
        for lohi in outs:       # pulled AFTER all dispatches are queued
            a = np.asarray(lohi, dtype=np.int64)
            total += int(a[:, 0].sum() + (a[:, 1].sum() << 16))
        return total

    def _hi_args(self):
        return (self.y2hi,) if self.k == 4 else self.tri_buckets

    def _lo_total(self) -> int:
        if self.lo_cols is None:
            return 0
        parts = _lo_popcount(self.bm, self.core, self.lo_cols,
                             words=self.words, chunk=4096,
                             nrow=int(self.lo_cols.shape[1]))
        return int(np.asarray(parts, dtype=np.int64).sum())

    def count(self) -> int:
        return (self._hi_total(self._hi_args())
                + self._lo_total() + self.tail_total)

    def timed_slope(self, samples: int = 3):
        """Marginal k-clique edge throughput via the full-vs-half slope over
        the hi-bilinear pass (the dominant term; see stream.timed_slope)."""
        import time
        args_f = self._hi_args()
        if self.k == 4:
            n = args_f[0].shape[0]
            nh = max(self.slab, n // 2 // self.slab * self.slab)
            full_tasks = self.n_core_edges
            half_tasks = min(nh, full_tasks)
            roll = lambda args, i: tuple(jnp.roll(a, i, axis=0)
                                         for a in args)
            args_h = (args_f[0][:nh],)
        else:
            def halve(b):
                rows, cm, step, rt = b
                h = max(step, rows.shape[0] // 2 // step * step)
                return (rows[:h], cm[:h], step, rt[:h])
            args_h = tuple(halve(b) for b in args_f)
            full_tasks = self.n_tri
            half_tasks = sum(int(b[3].sum()) for b in args_h)
            roll = lambda args, i: tuple(
                (jnp.roll(r, i, axis=0), jnp.roll(c, i, axis=0), s, rt)
                for r, c, s, rt in args)
        _ = self._hi_total(args_f)
        _ = self._hi_total(args_h)
        tf, th = [], []
        for i in range(samples):
            t0 = time.time()
            _ = self._hi_total(roll(args_f, i + 1))
            tf.append(time.time() - t0)
            t0 = time.time()
            _ = self._hi_total(roll(args_h, i + 1))
            th.append(time.time() - t0)
        dt = min(tf) - min(th)
        # edge-equivalents: tasks for k=4 ARE edges; k=5 tasks are
        # triangles — report task throughput scaled back to case-A edges
        de = full_tasks - half_tasks
        if dt < 0.1 * min(tf):
            # slope washed out by fixed dispatch costs — report the honest
            # dispatch-inclusive rate instead of an inflated quotient
            tasks_per_s = full_tasks / min(tf)
        else:
            tasks_per_s = de / dt
        scale = self.n_core_edges / max(full_tasks, 1)
        return {"edges_per_s": tasks_per_s * scale,
                "tasks_per_s": tasks_per_s,
                "latency_s": min(tf), "times_full": tf, "times_half": th}


def cliquek_count_fast(g, k: int, core: int = CORE, hi: int = HI) -> int:
    """Exact k-clique count (k = 4, 5) via the hi/lo matmul engine."""
    return CliqueKEngine(g, k, core=core, hi=hi).count()
