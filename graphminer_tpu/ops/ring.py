"""Ring engine: memory-lean bucketed edge counting — O(V·row + E·4B) HBM.

Successor of the materialized stream (ops/stream.py, O(E·row_w) HBM — 3.28 GB
for rmat18, ~35 GB for LiveJournal). The ring engine holds every row ONCE and
pays per task only an int32 index or a short list slot, so LiveJournal-class
graphs fit a single chip:

* Phase C — tasks whose dst lands in the CORE (top `core` ids of the
  degree-ascending relabeled DAG; the large majority of oriented edges on
  power-law graphs). Tasks are grouped BY SRC (forward CSR order): each src's
  core bitmap row CB[u] is stored once per bucket row, and each task
  contributes one core-local dst index. Count = popcount(CB[u] & CORE[dst]).
  The 4096-row core table is 2 MB and is read by one fused gather.
  Parity: the cached two-phase fetch+intersect of the reference GPU library
  (include/set_intersect.cuh:39-105, search.cuh:53-79) — the shared-memory
  cache becomes the small, cache-resident core table.

* Phase T — tasks whose dst is OUTSIDE the core (both endpoints sub-core).
  |N+(u) ∩ N+(v)| = popcount(CB[u] & CB[v]) + |T[u] ∩ T[v]| over the hub
  row encoding: the bitmap part fused-gathers two rows per task from the
  O(V·words) bitmap table; the tail part gathers each side's SHORT tail
  from per-class tail tables (every vertex's tail stored ONCE at its own
  width class — memory O(E), never O(Σ tail²) like per-task list
  materialization would be). Parity: the merge intersection of
  VertexSet.h:265-289 as batched vector ops.

Both phases run in ONE fused dispatch returning int32 partial sums (or
per-task counts for workloads that need them, e.g. diamond's Σ C(tri_e, 2)).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..types import SENTINEL, cdiv, round_up

CORE = 4096
# src core-out-degree classes for phase C (dst-index slots per src row)
C_CLASSES = (4, 16, 64, 256, 1024, 4096)
# src sub-core-out-degree classes for the phase-T bitmap buckets
B_CLASSES = (4, 16, 64, 256, 1024)
# out-degree classes for phase T tail-list rows (power-of-2: measured 1.9x
# less padded compare work than a 4x ladder on rmat20)
T_CLASSES = (8, 16, 32, 64, 128, 256, 512, 1024, 2048)
# tasks per lax.map step (large: small steps serialize the pipeline)
TASK_BLOCK = 1 << 20


def _class_of(w: np.ndarray, classes) -> np.ndarray:
    b = np.asarray(classes)
    assert w.size == 0 or int(w.max()) <= classes[-1], \
        "width classes must cover the data (see _cover)"
    return b[np.searchsorted(classes, w, side="left")].astype(np.int32)


def _cover(classes, maxw: int):
    """Extend the class ladder (doubling) until it covers maxw."""
    out = [c for c in classes if c < maxw]
    top = out[-1] if out else 8
    while top < maxw:
        top *= 2
    out.append(top)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class CBucket:
    """Phase-C bucket: srcs whose core-out-degree class is `wc`."""
    wc: int
    src_bm: jax.Array    # int32 [n, words] core bitmaps, one row per src
    dst_loc: jax.Array   # int32 [n, wc] core-local dst ids, SENTINEL padded
    n_tasks: int
    row_tasks: Optional[np.ndarray] = None   # host int32 [n] tasks per row


@dataclasses.dataclass(frozen=True)
class TBucket:
    """Phase-T tail-compare bucket: tasks where BOTH endpoints have
    non-empty tails, keyed by their tail-width classes. Carries only row
    slots into the per-class tail tables."""
    ta: int              # tail-table index for src side
    tv: int              # tail-table index for dst side
    src_slot: jax.Array  # int32 [n] row in tail_tables[ta], SENTINEL padded
    dst_slot: jax.Array  # int32 [n] row in tail_tables[tv]
    n_tasks: int


@dataclasses.dataclass(frozen=True)
class RingLayout:
    core_bm: jax.Array   # int32 [C, words] core rows' bitmaps (closed core)
    # DENSE bitmap table: int32 [len(csrc), words] core bitmaps of only the
    # vertices with a non-zero core bitmap, indexed by csrc RANK (not global
    # vertex id); bbucket dst_loc carries rank ids into it
    bm_table: Optional[jax.Array]
    tail_tables: Tuple[jax.Array, ...]  # per-class [n_k, wt_k] sorted tails
    words: int
    core_start: int
    core_size: int
    cbuckets: Tuple[CBucket, ...]
    # phase-T bitmap pass, grouped BY SRC exactly like phase C: src bitmap
    # row stored once, dst RANK ids gathered from the dense bm_table —
    # halves the gather volume vs the earlier flat per-task pair gathers.
    # Rows whose src bitmap is all-zero are dropped at build (contribute 0).
    bbuckets: Tuple[CBucket, ...]
    tbuckets: Tuple[TBucket, ...]
    n_tasks: int         # total oriented edges
    n_core_tasks: int
    n_b_tasks: int       # tail tasks carried by bbuckets (zero-CB rows cut)

    def nbytes(self) -> int:
        n = self.core_bm.size
        if self.bm_table is not None:
            n += self.bm_table.size
        for t in self.tail_tables:
            n += t.size
        for b in self.cbuckets + self.bbuckets:
            n += b.src_bm.size + b.dst_loc.size
        for b in self.tbuckets:
            n += b.src_slot.size + b.dst_slot.size
        return n * 4


def _pack_bitmaps(cols_local: np.ndarray, row_of: np.ndarray, n_rows: int,
                  words: int) -> np.ndarray:
    """Scatter core-local column ids into packed uint32 bitmaps."""
    bm = np.zeros((n_rows, words), dtype=np.uint32)
    np.bitwise_or.at(bm, (row_of, cols_local >> 5),
                     np.uint32(1) << (cols_local & 31).astype(np.uint32))
    return bm.view(np.int32)


def _bucket_by_src(wsrc: np.ndarray, starts: np.ndarray, cols: np.ndarray,
                   src_rows: np.ndarray, classes) -> list:
    """Group per-src task lists into width-class CBuckets.

    wsrc: [ns] tasks per src; starts: [ns] offsets into cols (src-major);
    cols: flat dst ids; src_rows: [ns, words] bitmap row per src."""
    words = src_rows.shape[1]
    out = []
    if wsrc.size == 0:
        return out
    classes = _cover(classes, int(wsrc.max()))
    cls = _class_of(wsrc, classes)
    for k in classes:
        m = cls == k
        if not m.any():
            continue
        n_d = int(m.sum())
        n_pad = round_up(n_d, 8)
        dl = np.full((n_pad, k), SENTINEL, dtype=np.int32)
        st, ln = starts[m], wsrc[m]
        pos = st[:, None] + np.arange(k, dtype=np.int64)[None, :]
        valid = np.arange(k)[None, :] < ln[:, None]
        dl[:n_d][valid] = cols[np.minimum(pos, cols.shape[0] - 1)][valid]
        bm = np.zeros((n_pad, words), dtype=np.int32)
        bm[:n_d] = src_rows[m]
        rt = np.zeros(n_pad, dtype=np.int32)
        rt[:n_d] = ln
        out.append(CBucket(wc=int(k), src_bm=jnp.asarray(bm),
                           dst_loc=jnp.asarray(dl),
                           n_tasks=int(ln.sum()), row_tasks=rt))
    return out


def build_ring(g, core: int = CORE, c_classes=C_CLASSES,
               b_classes=B_CLASSES, t_classes=T_CLASSES,
               phases: str = "CT") -> RingLayout:
    """g: undirected host graph (or already-oriented DAG). Relabels
    ascending by degree, orients, splits tasks into phase C / phase T.

    phases="C" skips the phase-T structures (the hybrid engine covers
    sub-core tasks with a materialized stream instead — ops/hybrid.py)."""
    rg = g if g.is_dag else g.relabel_by_degree(descending=False).orientation()
    v = rg.n_vertices
    c = min(core, v)
    cs = v - c
    words = round_up(max(1, cdiv(c, 32)), 8)

    deg = np.diff(rg.rowptr).astype(np.int64)
    src = np.repeat(np.arange(v, dtype=np.int64), deg)
    col = rg.colidx.astype(np.int64)
    in_core = col >= cs

    # ---- phase C: group core-dst tasks by src ------------------------------
    # rows are sorted ascending, core ids are the largest → the core part is
    # the row SUFFIX; per-src core out-degree:
    wc = np.bincount(src[in_core], minlength=v).astype(np.int64)
    csrc = np.nonzero(wc)[0]
    core_cols = (col[in_core] - cs).astype(np.int32)   # core-local, src-major
    core_src = src[in_core]
    # bitmaps of N+(u) ∩ core for every src that has core out-neighbors
    rank = np.full(v, -1, dtype=np.int64)
    rank[csrc] = np.arange(csrc.shape[0])
    src_bm_all = _pack_bitmaps(core_cols, rank[core_src], csrc.shape[0], words)

    starts = np.concatenate([[0], np.cumsum(wc[csrc])[:-1]])
    n_core_tasks = int(wc.sum())
    cbuckets = _bucket_by_src(wc[csrc], starts, core_cols, src_bm_all,
                              c_classes)

    # ---- phase T: sub-core-dst tasks --------------------------------------
    # |N+(u) ∩ N+(v)| = popcount(CB[u] & CB[v]) + |T[u] ∩ T[v]|. The bitmap
    # part is grouped by src (bbuckets): the src row is stored once, dst
    # rows are fused-gathered from bm_table [V, words] — half the gather
    # volume of per-task pair gathers; rows with an all-zero src bitmap are
    # dropped (they contribute 0). The tail part gathers each side's short
    # tail from per-class tables (each tail stored ONCE).
    tsrc = src[~in_core].astype(np.int64)
    tdst = col[~in_core].astype(np.int64)
    tbuckets = []
    bbuckets = []
    tail_tables = []
    bm_table = None
    n_b_tasks = 0
    if tsrc.size and "T" in phases:
        # DENSE bitmap table: only vertices with a non-zero core bitmap
        # (the csrc set) have rows — dst slots store the csrc RANK, and
        # tasks whose dst has an all-zero bitmap (contribute 0) are dropped
        # at build. vs the earlier [V, words] table this cuts layout bytes
        # (1.25 → 0.98 GB on rmat20) and build time (44 → 14 s); gather
        # throughput is row-count-bound, so phase-B speed is unchanged.
        bm_table = jnp.asarray(src_bm_all)

        # bbuckets: tail tasks grouped by src (tasks are src-major already);
        # keep only tasks where BOTH endpoints have non-zero core bitmaps
        rank_b = np.full(v, -1, dtype=np.int64)
        rank_b[csrc] = np.arange(csrc.shape[0])
        keep_t = (wc[tsrc] > 0) & (rank_b[tdst] >= 0)
        ksrc = tsrc[keep_t]
        kdst = rank_b[tdst[keep_t]].astype(np.int32)    # dense rank ids
        wt_all = np.bincount(ksrc, minlength=v).astype(np.int64)
        bsrc = np.nonzero(wt_all)[0]
        if bsrc.size:
            bstarts = np.concatenate([[0], np.cumsum(wt_all[bsrc])[:-1]])
            rows = src_bm_all[rank_b[bsrc]]
            bbuckets = _bucket_by_src(wt_all[bsrc], bstarts,
                                      kdst, rows, b_classes)
            n_b_tasks = sum(b.n_tasks for b in bbuckets)

        # tails: out-neighbors below cs = sorted row prefix, per vertex
        tw = np.bincount(src[~in_core], minlength=v).astype(np.int64)
        has = np.nonzero(tw)[0]
        classes = _cover(t_classes, int(tw[has].max())) if has.size else ()
        cls_idx = np.full(v, -1, dtype=np.int64)
        slot = np.full(v, -1, dtype=np.int64)
        widths = []
        for ki, k in enumerate(classes):
            mem = has[(_class_of(tw[has], classes) == k)]
            if mem.size == 0:
                widths.append(0)
                tail_tables.append(jnp.zeros((1, int(k)), jnp.int32))
                continue
            widths.append(int(k))
            cls_idx[mem] = ki
            slot[mem] = np.arange(mem.size)
            rows = _gather_lists(rg.rowptr, rg.colidx, mem, int(k),
                                 round_up(mem.size, 8))
            rows = np.where((rows != SENTINEL) & (rows < cs), rows, SENTINEL)
            tail_tables.append(jnp.asarray(rows))
        # tail-compare buckets: both sides with non-empty tails
        both = (tw[tsrc] > 0) & (tw[tdst] > 0)
        bs, bd = tsrc[both], tdst[both]
        if bs.size:
            key = cls_idx[bs] * 64 + cls_idx[bd]
            order = np.argsort(key, kind="stable")
            bs, bd, key = bs[order], bd[order], key[order]
            change = np.nonzero(np.diff(key))[0] + 1
            b0 = np.concatenate([[0], change])
            b1 = np.concatenate([change, [key.shape[0]]])
            for b, e in zip(b0, b1):
                ia, iv = int(key[b] // 64), int(key[b] % 64)
                n_d = int(e - b)
                n_pad = round_up(n_d, 8)
                sl_a = np.full(n_pad, SENTINEL, np.int32)
                sl_v = np.full(n_pad, SENTINEL, np.int32)
                sl_a[:n_d] = slot[bs[b:e]]
                sl_v[:n_d] = slot[bd[b:e]]
                tbuckets.append(TBucket(ta=ia, tv=iv,
                                        src_slot=jnp.asarray(sl_a),
                                        dst_slot=jnp.asarray(sl_v),
                                        n_tasks=n_d))

    core_rows = np.arange(cs, v, dtype=np.int64)
    cb_rank = np.zeros(c, dtype=np.int64)
    core_bm = np.zeros((c, words), dtype=np.uint32)
    # core rows: out-neighbors all in core (closure under ascending ids)
    cdeg = deg[core_rows]
    csrc2 = np.repeat(np.arange(c, dtype=np.int64), cdeg)
    ccol = np.concatenate([rg.colidx[rg.rowptr[x]:rg.rowptr[x + 1]]
                           for x in core_rows]) if cdeg.sum() else \
        np.empty(0, dtype=np.int32)
    del cb_rank
    if ccol.size:
        ccl = (ccol.astype(np.int64) - cs).astype(np.int32)
        assert ccl.min() >= 0, "core not closed under out-neighbors"
        np.bitwise_or.at(core_bm, (csrc2, ccl >> 5),
                         np.uint32(1) << (ccl & 31).astype(np.uint32))

    return RingLayout(core_bm=jnp.asarray(core_bm.view(np.int32)),
                      bm_table=bm_table, tail_tables=tuple(tail_tables),
                      words=words, core_start=cs, core_size=c,
                      cbuckets=tuple(cbuckets), bbuckets=tuple(bbuckets),
                      tbuckets=tuple(tbuckets),
                      n_tasks=int(col.shape[0]), n_core_tasks=n_core_tasks,
                      n_b_tasks=n_b_tasks)


def _gather_lists(rowptr, colidx, vids: np.ndarray, width: int,
                  n_pad: int) -> np.ndarray:
    """[n_pad, width] out-lists (host gather), SENTINEL padded/truncated."""
    out = np.full((n_pad, width), SENTINEL, dtype=np.int32)
    st = rowptr[vids]
    ln = np.minimum(rowptr[vids + 1] - st, width)
    pos = st[:, None] + np.arange(width, dtype=np.int64)[None, :]
    valid = np.arange(width)[None, :] < ln[:, None]
    out[:vids.shape[0]][valid] = colidx[np.minimum(pos, colidx.shape[0] - 1)][valid]
    return out


# --------------------------------------------------------------------------
# count kernels
# --------------------------------------------------------------------------

def _cbucket_partials(core_bm, src_bm, dst_loc, *, words: int, wc: int,
                      per_task: bool):
    """popcount(CB[u] & CORE[dst]) per task via fused gather."""
    c = core_bm.shape[0]
    n = src_bm.shape[0]
    # cap the [chunk, wc, words] gathered-row intermediate at ~64 MB in case
    # XLA materializes it (RESOURCE_EXHAUSTED observed at larger steps)
    chunk = max(8, min(TASK_BLOCK // max(wc * words // 8, 8),
                       (64 << 20) // (wc * words * 4)))
    n_chunks = cdiv(n, chunk)
    pad = n_chunks * chunk - n
    if pad:
        src_bm = jnp.concatenate([src_bm, jnp.zeros((pad, words), jnp.int32)])
        dst_loc = jnp.concatenate(
            [dst_loc, jnp.full((pad, wc), SENTINEL, jnp.int32)])
    sb = src_bm.reshape(n_chunks, chunk, words)
    dl = dst_loc.reshape(n_chunks, chunk, wc)

    def body(xs):
        s, d = xs
        ok = (d >= 0) & (d < c)
        rows = core_bm[jnp.where(ok, d, 0)]           # fused gather
        rows = jnp.where(ok[:, :, None], rows, 0)
        pc = jax.lax.population_count(s[:, None, :] & rows)
        if per_task:
            return jnp.sum(pc, axis=2, dtype=jnp.int32)   # [chunk, wc]
        return jnp.sum(pc, dtype=jnp.int32)

    return jax.lax.map(body, (sb, dl))


def _tail_pairs_partials(table_a, table_b, sa, sb, *, per_task: bool):
    """|T[u] ∩ T[v]| per task via per-class tail-table gathers + compare.

    Broadcast compare throughout: the O(wa·wb) elementwise compares are
    cheap next to the row gathers that bound this phase, while a
    binary-search variant (`setops._member_bs`) adds a dependent gather per
    level."""
    wa, wb = table_a.shape[1], table_b.shape[1]
    n = sa.shape[0]
    chunk = max(8, min(TASK_BLOCK // max(wa * wb // 8, 8),
                       (64 << 20) // ((wa + wb) * 4)))
    n_chunks = cdiv(n, chunk)
    pad = n_chunks * chunk - n
    if pad:
        sa = jnp.concatenate([sa, jnp.full((pad,), SENTINEL, jnp.int32)])
        sb = jnp.concatenate([sb, jnp.full((pad,), SENTINEL, jnp.int32)])
    aa = sa.reshape(n_chunks, chunk)
    bb = sb.reshape(n_chunks, chunk)
    na, nb = table_a.shape[0], table_b.shape[0]

    def body(xs):
        ia, ib = xs
        oka = (ia >= 0) & (ia < na)
        okb = (ib >= 0) & (ib < nb)
        ra = jnp.where(oka[:, None], table_a[jnp.where(oka, ia, 0)],
                       SENTINEL)
        rb = jnp.where(okb[:, None], table_b[jnp.where(okb, ib, 0)],
                       SENTINEL)
        m = (ra[:, :, None] == rb[:, None, :]) & (ra != SENTINEL)[:, :, None]
        if per_task:
            return jnp.sum(m, axis=(1, 2), dtype=jnp.int32)
        return jnp.sum(m, dtype=jnp.int32)

    return jax.lax.map(body, (aa, bb))


@functools.partial(jax.jit,
                   static_argnames=("cspec", "bspec", "tspec", "words"))
def _ring_partials(core_bm, carrays, bm_table, barrays, tail_tables,
                   tslot_arrays, salt, *, cspec, bspec, tspec, words: int):
    """ONE dispatch over all buckets → concatenated int32 partial sums.
    salt permutes the output order only (benchmark dispatch distinctness)."""
    outs = []
    for (src_bm, dst_loc), wc in zip(carrays, cspec):
        outs.append(_cbucket_partials(core_bm, src_bm, dst_loc, words=words,
                                      wc=wc, per_task=False))
    for (src_bm, dst_loc), wc in zip(barrays, bspec):
        # phase-T bitmap pass: same kernel, dst rows from the full table
        outs.append(_cbucket_partials(bm_table, src_bm, dst_loc, words=words,
                                      wc=wc, per_task=False))
    for (sa, sb), (ia, iv) in zip(tslot_arrays, tspec):
        outs.append(_tail_pairs_partials(tail_tables[ia],
                                         tail_tables[iv], sa, sb,
                                         per_task=False))
    parts = jnp.concatenate(outs) if outs else jnp.zeros((1,), jnp.int32)
    return jnp.roll(parts, salt)


class RingEngine:
    """Prepared triangle counter over the ring layout.

    Parity: the fused fast path for src/triangle (omp_base.cc:5-27,
    bs_warp_edge.cuh) at O(V·row + E·4B) device memory."""

    def __init__(self, g, core: int = CORE):
        self.layout = build_ring(g, core=core)
        lay = self.layout
        self.carrays = tuple((b.src_bm, b.dst_loc) for b in lay.cbuckets)
        self.cspec = tuple(b.wc for b in lay.cbuckets)
        self.barrays = tuple((b.src_bm, b.dst_loc) for b in lay.bbuckets)
        self.bspec = tuple(b.wc for b in lay.bbuckets)
        self.tslot_arrays = tuple((b.src_slot, b.dst_slot)
                                  for b in lay.tbuckets)
        self.tspec = tuple((b.ta, b.tv) for b in lay.tbuckets)
        self.n_edges = lay.n_tasks

    def partials(self, salt: int = 0):
        lay = self.layout
        bm = lay.bm_table if lay.bm_table is not None else lay.core_bm
        return _ring_partials(lay.core_bm, self.carrays, bm, self.barrays,
                              lay.tail_tables, self.tslot_arrays,
                              jnp.int32(salt), cspec=self.cspec,
                              bspec=self.bspec, tspec=self.tspec,
                              words=lay.words)

    def count(self) -> int:
        from ..utils.profiling import PROFILER
        PROFILER.count("edge_tasks", self.n_edges)
        PROFILER.count("set_ops_level2", self.n_edges)  # 1 intersection/task
        with PROFILER.phase("device_count"):
            return int(np.asarray(self.partials(), dtype=np.int64).sum())

    def timed_count(self, iters: int = 8):
        """(count, seconds/iter) — `iters` salted back-to-back dispatches,
        ONE host pull inside the timed window (see stream.timed_count)."""
        import time
        _ = self.count()
        t0 = time.time()
        outs = [self.partials(salt=i + 1) for i in range(iters)]
        _ = np.asarray(outs[-1])
        dt = (time.time() - t0) / iters
        totals = [int(np.asarray(o, dtype=np.int64).sum()) for o in outs]
        if any(t != totals[0] for t in totals):
            raise RuntimeError(f"salted dispatches disagree: {totals}")
        return totals[0], dt

    def _frac(self, denom: int = 8) -> "RingEngine":
        """First-1/denom-rows view of every bucket (slope timing; the small
        fraction keeps the full-vs-fraction time delta large)."""
        h = lambda n: max(8, n // denom // 8 * 8)
        eng = object.__new__(RingEngine)
        eng.layout = self.layout
        eng.carrays = tuple((bm[: h(bm.shape[0])], dl[: h(dl.shape[0])])
                            for bm, dl in self.carrays)
        eng.cspec = self.cspec
        eng.barrays = tuple((bm[: h(bm.shape[0])], dl[: h(dl.shape[0])])
                            for bm, dl in self.barrays)
        eng.bspec = self.bspec
        eng.tslot_arrays = tuple((sa[: h(sa.shape[0])],
                                  sb[: h(sb.shape[0])])
                                 for sa, sb in self.tslot_arrays)
        eng.tspec = self.tspec
        # edge-equivalent of the sliced work: core tasks exactly; a tail
        # task's work is split across a bbucket slot (bitmap part) and a
        # tbucket slot (tail part), so prorate the sliced slot counts back
        # to edges by the full engine's slots-per-tail-edge ratio.
        lay = self.layout
        frac_b = sum(int(b.row_tasks[: h(b.row_tasks.shape[0])].sum())
                     for b in lay.bbuckets)
        frac_t = sum(min(h(sa.shape[0]), b.n_tasks)
                     for (sa, _), b in zip(eng.tslot_arrays, lay.tbuckets))
        n_tail = lay.n_tasks - lay.n_core_tasks
        n_tb = sum(b.n_tasks for b in lay.tbuckets)
        slots = lay.n_b_tasks + n_tb
        eng.n_edges = (
            sum(int(b.row_tasks[: h(b.row_tasks.shape[0])].sum())
                for b in lay.cbuckets)
            + (n_tail * (frac_b + frac_t)) // max(slots, 1))
        return eng

    def timed_slope(self, samples: int = 5):
        """Marginal device throughput via the full-vs-fraction two-size
        slope, which cancels the fixed per-dispatch cost (see
        stream.timed_slope)."""
        import time
        half = self._frac(8)
        _ = self.count()
        _ = half.count()

        def sample(eng, salt):
            t0 = time.time()
            _ = np.asarray(eng.partials(salt=salt))
            return time.time() - t0

        tf, th = [], []
        for i in range(samples):
            tf.append(sample(self, 2 * i + 1))
            th.append(sample(half, 2 * i + 2))
        dt = min(tf) - min(th)
        de = self.n_edges - half.n_edges
        return {"edges_per_s": de / max(dt, 1e-9), "latency_s": min(tf),
                "times_full": tf, "times_half": th,
                "tasks_full": self.n_edges, "tasks_half": half.n_edges}


def triangle_count_ring(g, core: int = CORE, **kw) -> int:
    """Exact TC via the memory-lean ring engine."""
    return RingEngine(g, core=core, **kw).count()
