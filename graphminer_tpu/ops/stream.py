"""Bucketed reverse-CSR stream engine: gather-free edge-parallel counting.

The hot TC path. ops/hubcore.py splits edges into a spoke GEMM and
per-task gather groups; this engine replaces both with a pure stream:

  * Tasks (u, v) are grouped BY DST — the task list is exactly the reverse
    CSR of the oriented DAG. Dst rows are read once per dst, in order.
  * Dsts are bucketed by (in-degree class, dst-tail-width class); each bucket
    stores a PREP-TIME MATERIALIZED src-row tensor [n_dst, width, row_w]
    (the task-aligned stream). At count time every input is a sequential
    device-memory read instead of a random row gather.
  * Per task: |N+(u) ∩ N+(v)| = popcount(CB[u] & CB[v]) + |T[u] ∩ T[v]|
    over the HubLayout row encoding (hub-core bitmap + short sorted tail,
    see ops/hubcore.py docstring). Core closure means dst-in-core buckets
    skip the T part entirely (T[v] = ∅), so most edges are pure elementwise
    AND+popcount; the remaining tail tasks pay wta*wtv broadcast compares,
    kept tight by the per-bucket width classes.
  * Each bucket reduces as ONE fused broadcast-reduce (row groups sized
    for exact int32 partials) instead of a lax.map chunk loop, which
    serializes the pipeline.
  * Dst word-span bucket classes (WS_CLASSES) slice BOTH sides' bitmap rows
    to the dst's top-word span — lossless (a & 0 = 0) and, with
    degree-ascending ids, most dst rows live entirely in the top 32 words.
    This cuts the rmat18 layout from 3.28 GB to 2.12 GB (exact plan_only
    sizing). At rmat19+ the bytes/task grow (~870 B at 19, ~1285 B at 20):
    the fat part is sub-core dst T-compare slots, and bigger cores only add
    bitmap words (rmat19: 4096/8192/16384-core = 6.8/10.9/20.9 GB). The
    lever there is a second-level bitmap for mid-degree tail ids, not core
    size.

This replaces both reference device strategies at once — the warp
binary-search intersection (include/set_intersect.cuh:6-105) and the matrix
subsystem (src/matrix/omp_mm.cpp:104-215) — with fixed-shape streaming that
XLA runs at memory bandwidth. Memory cost: every task slot materializes
its dst-span slice of the src row (2.12 GB for rmat18, whose CSR is
15 MB), so this engine is for graphs up to ~2^19-2^20 DAG-edges-per-GB of
device memory. ops/ring.py is the memory-lean successor
(O(V * row + E * 4B)) that scales to LiveJournal-class graphs.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..types import SENTINEL, cdiv, round_up
from .hubcore import HubLayout, build_hub_layout

# Dst in-degree classes. Dsts with more in-neighbors than the top class are
# split across multiple padded rows (same dst row replicated).
WIDTH_CLASSES = (2, 8, 32, 128, 512, 2048)
# Dst tail-width classes (sub-core dsts only): the T-compare costs
# wta * wtv_class elementwise ops per task, so tight dst classes matter.
WTV_CLASSES = (0, 16, 48)
# Dst word-span classes (round 5). popcount(CB[u] & CB[v]) only needs the
# word range where the DST row has set bits (a & 0 = 0 — src bits outside
# are irrelevant), and ids ascend by degree, so dst core-neighbors cluster
# in the TOP words: bucketing dsts by top-word span and slicing BOTH sides'
# rows to it cuts the materialized stream (and with it the bytes read per
# task — the engine is memory-bound) by ~2-3x. Lossless.
WS_CLASSES = (8, 32)
# Target tasks per lax.map step (chunk_d = TASK_BLOCK / width). Large on
# purpose: small steps serialize the pipeline. Per-step int32 partial sums
# stay exact as long as TASK_BLOCK * max_count_per_task < 2^31.
TASK_BLOCK = 1 << 20


@dataclasses.dataclass(frozen=True)
class Bucket:
    """One (in-degree class, dst-T class, word-span class) group of dsts
    with padded src-index lists. wtv == 0 covers both core dsts (closure:
    T[v] = ∅) and sub-core dsts with empty tails — either way the
    T-compare is skipped. ws = bitmap words kept (the TOP ws words of the
    core space — every set bit of every dst row in the bucket lies there)."""
    width: int              # src slots per dst row (in-degree class)
    wtv: int                # dst T slots kept (0 -> popcount only)
    wta: int                # src T slots kept (0 when wtv == 0)
    ws: int                 # bitmap words kept (dst top-word span class)
    n_dst: int              # padded dst-row count
    dst_rows: jax.Array     # [n_dst, ws + wtv]
    src_rows: jax.Array     # [n_dst, width, ws + wta]
    n_tasks: int            # true (unpadded) task count
    row_tasks: Optional[np.ndarray] = None  # host int32 [n_dst] true tasks/row

    @property
    def spec(self):
        return (self.width, self.wtv, self.wta, self.ws)


@dataclasses.dataclass(frozen=True)
class StreamLayout:
    """Prepared device-resident stream for one oriented graph."""
    layout: HubLayout
    buckets: Tuple[Bucket, ...]
    n_tasks: int

    def nbytes(self) -> int:
        return sum((b.dst_rows.size + b.src_rows.size) * 4
                   for b in self.buckets)


def _split_wide(dst: np.ndarray, indeg: np.ndarray, top: int):
    """Split dsts with in-degree > top into ceil(indeg/top) rows of <= top.
    Returns (row_dst, row_off, row_len) per padded row."""
    reps = np.maximum(1, -(-indeg // top))
    owner = np.repeat(np.arange(dst.shape[0]), reps)
    row_dst = dst[owner]
    starts = np.concatenate([[0], np.cumsum(reps)[:-1]])
    local = np.arange(row_dst.shape[0]) - starts[owner]
    row_off = local * top
    row_len = np.minimum(indeg[owner] - row_off, top)
    return row_dst, row_off, row_len


@functools.partial(jax.jit,
                   static_argnames=("width", "words", "wtv", "wta", "ws"))
def _materialize(table, dsts, src_idx, *, width: int, words: int, wtv: int,
                 wta: int, ws: int):
    """Gather dst rows + task-aligned src rows on device (prep-time only),
    sliced to the bucket's top-ws bitmap words (CB top + T slots are
    contiguous columns [words - ws, words + wt) of the layout row).

    SENTINEL src slots materialize as bitmap=0 / T=SENTINEL so they
    contribute exactly 0 at count time."""
    v = table.shape[0]
    lo = words - ws
    rows_d = table[dsts][:, lo:words + wtv]
    safe = jnp.clip(src_idx, 0, v - 1)
    ok = (src_idx >= 0) & (src_idx < v)
    rows_s = table[safe.reshape(-1)][:, lo:words + wta].reshape(
        src_idx.shape[0], width, ws + wta)
    bm = jnp.where(ok[:, :, None], rows_s[:, :, :ws], 0)
    if wta == 0:
        return rows_d, bm
    t = jnp.where(ok[:, :, None], rows_s[:, :, ws:], SENTINEL)
    return rows_d, jnp.concatenate([bm, t], axis=2)


def build_stream(g, core: int = 4096, classes=WIDTH_CLASSES,
                 wtv_classes=WTV_CLASSES,
                 dst_below: Optional[int] = None, plan_only: bool = False):
    """g: undirected host graph (or an already-oriented DAG). Relabels
    ascending by degree, orients, builds the HubLayout and the bucketed
    reverse-CSR stream.

    dst_below: keep only tasks with dst id < dst_below (the hybrid engine
    materializes just the sub-core tasks this way and routes core-dst tasks
    through the ring phase-C table — ops/hybrid.py).

    plan_only: return the EXACT materialized byte count instead of
    building (the HBM pre-budget for bench gating — nothing bucket-sized
    touches the device)."""
    if g.is_dag:
        rg = g
    else:
        rg = g.relabel_by_degree(descending=False).orientation()
    if plan_only:
        # host-only shadow of build_hub_layout's shape arithmetic — no
        # device allocation for the pre-budget estimate
        import types
        v_ = rg.n_vertices
        c_ = min(core, v_)
        cs_ = v_ - c_
        deg_ = np.diff(rg.rowptr).astype(np.int64)
        src_ = np.repeat(np.arange(v_, dtype=np.int64), deg_)
        tw = np.bincount(src_[rg.colidx.astype(np.int64) < cs_],
                         minlength=v_).astype(np.int32)
        wt_max = int(tw.max(initial=0))
        lay = types.SimpleNamespace(
            words=round_up(max(1, cdiv(c_, 32)), 8), core_start=cs_,
            wt_pad=round_up(max(8, wt_max), 8) if wt_max else 0,
            t_width=tw, table=None)
    else:
        lay = build_hub_layout(rg, core=core)
    v = rg.n_vertices

    deg = np.diff(rg.rowptr).astype(np.int64)
    src = np.repeat(np.arange(v, dtype=np.int64), deg).astype(np.int32)
    dst = rg.colidx.astype(np.int32)
    if dst_below is not None:
        keep = dst < dst_below
        src, dst = src[keep], dst[keep]

    # reverse CSR: tasks sorted by dst, then src
    order = np.lexsort((src, dst))
    src_o, dst_o = src[order], dst[order]
    udst, istart = np.unique(dst_o, return_index=True)
    indeg = np.diff(np.concatenate([istart, [dst_o.shape[0]]])).astype(
        np.int64)

    top = classes[-1]
    rd, roff, rlen = _split_wide(udst, indeg, top)
    rstart = np.repeat(istart, np.maximum(1, -(-indeg // top))) + roff
    wclass = np.asarray(classes)[np.searchsorted(classes, rlen, side="left")]
    # dst T class: core dsts and empty-tail dsts land in wtv == 0; dst tails
    # wider than the top class fall through to the layout's full wt_pad
    twd = lay.t_width[rd]
    wtv_top = wtv_classes[-1]
    idx = np.clip(np.searchsorted(wtv_classes, twd, side="left"), 0,
                  len(wtv_classes) - 1)
    wtv_of = np.where(twd > wtv_top, lay.wt_pad,
                      np.asarray(wtv_classes)[idx])

    # per-row max src-tail class (only relevant where the dst has a tail):
    # rows are sub-bucketed by it so a single wide-tailed src does not
    # inflate wta for every row in its (width, wtv) bucket — without this,
    # a sub-core-only stream (ops/hybrid.py) measured 17 GB on rmat20 vs
    # ~3 GB with per-row classes.
    row_wta = np.zeros(rd.shape[0], dtype=np.int64)
    need_wta = wtv_of > 0
    if need_wta.any() and src_o.size:
        # rows are contiguous ascending segments of the flat task list, so
        # segment maxima come from one vectorized reduceat
        tails = lay.t_width[src_o].astype(np.int64)
        row_wta = np.maximum.reduceat(tails, np.minimum(
            rstart, tails.shape[0] - 1))
    wta_classes = (0, 8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096)
    wta_cl = np.asarray(wta_classes)[np.clip(
        np.searchsorted(wta_classes, row_wta, side="left"), 0,
        len(wta_classes) - 1)]
    wta_cl = np.where(row_wta > wta_classes[-1],
                      round_up(int(row_wta.max(initial=1)), 8), wta_cl)
    # the ladder rounds UP, so a class can exceed the layout's physical tail
    # width (wt_pad, a multiple of 8); _materialize slices at most wt_pad
    # columns, so clamp the class to it (r3 regression: reshape mismatch)
    wta_cl = np.minimum(wta_cl, lay.wt_pad)
    wta_cl = np.where(need_wta, wta_cl, 0)

    # dst top-word span class: rows are sorted ascending with the sub
    # prefix first (t_width entries), so the FIRST core out-neighbor gives
    # the lowest set word of the dst bitmap; slice both sides to the top
    # span (lossless: a & 0 = 0)
    words = lay.words
    cs = lay.core_start
    has_core = deg > lay.t_width.astype(np.int64)
    fc_pos = rg.rowptr[:-1] + lay.t_width.astype(np.int64)
    first_core = rg.colidx[np.minimum(fc_pos, rg.colidx.shape[0] - 1)]
    span = np.where(has_core,
                    words - ((first_core.astype(np.int64) - cs) >> 5), 0)
    ws_classes = tuple(sorted({min(w, words) for w in WS_CLASSES}
                              | {words}))
    ws_of = np.asarray(ws_classes)[np.clip(
        np.searchsorted(ws_classes, span[rd], side="left"), 0,
        len(ws_classes) - 1)]

    buckets = []
    planned = 0
    for wc in classes:
      for wtvc in sorted(set(wtv_of.tolist())):
        sel0 = (wclass == wc) & (wtv_of == wtvc)
        for wtac in sorted(set(wta_cl[sel0].tolist())):
            sel1 = sel0 & (wta_cl == wtac)
            for wsc in sorted(set(ws_of[sel1].tolist())):
                m = sel1 & (ws_of == wsc)
                if not m.any():
                    continue
                n_d = int(m.sum())
                # src T slots: this row-class's max src tail; irrelevant
                # when the dst side has no tail (intersection empty)
                wta = int(round_up(wtac, 8)) if (wtvc and wtac) else 0
                # pad n_dst to a sublane multiple for clean tiling
                n_pad = round_up(n_d, 8)
                if plan_only:
                    planned += 4 * n_pad * ((int(wsc) + int(wtvc))
                                            + wc * (int(wsc) + wta))
                    continue
                si = np.full((n_d, wc), SENTINEL, dtype=np.int32)
                starts_b, lens_b = rstart[m], rlen[m]
                flat_pos = (starts_b[:, None]
                            + np.arange(wc, dtype=np.int64)[None, :])
                valid = np.arange(wc)[None, :] < lens_b[:, None]
                si[valid] = src_o[flat_pos[valid]]
                dsts_b = np.pad(rd[m], (0, n_pad - n_d),
                                constant_values=0).astype(np.int32)
                si = np.pad(si, ((0, n_pad - n_d), (0, 0)),
                            constant_values=SENTINEL)
                dst_rows, src_rows = _materialize(
                    lay.table, jnp.asarray(dsts_b), jnp.asarray(si),
                    width=wc, words=words, wtv=int(wtvc), wta=wta,
                    ws=int(wsc))
                # padded dst rows may alias vertex 0; zero their bitmap+T
                # so they cannot pair with padded src slots
                if n_pad > n_d:
                    dst_rows = dst_rows.at[n_d:].set(
                        jnp.where(jnp.arange(dst_rows.shape[1]) < int(wsc),
                                  0, SENTINEL))
                rt = np.zeros(n_pad, dtype=np.int32)
                rt[:n_d] = lens_b
                buckets.append(Bucket(width=wc, wtv=int(wtvc), wta=wta,
                                      ws=int(wsc),
                                      n_dst=n_pad, dst_rows=dst_rows,
                                      src_rows=src_rows,
                                      n_tasks=int(lens_b.sum()),
                                      row_tasks=rt))
    if plan_only:
        return planned
    return StreamLayout(layout=lay, buckets=tuple(buckets),
                        n_tasks=int(dst.shape[0]))


# --------------------------------------------------------------------------
# count kernels
# --------------------------------------------------------------------------

def _bucket_counts_body(dst_rows, src_rows, *, words: int, wtv: int,
                        chunk_d: int):
    """Per-chunk int32 partial sums of |N+(u) ∩ N+(v)| over one bucket."""
    n_pad = dst_rows.shape[0]
    n_chunks = cdiv(n_pad, chunk_d)
    pad = n_chunks * chunk_d - n_pad
    if pad:
        dz = jnp.where(jnp.arange(dst_rows.shape[1]) < words, 0, SENTINEL)
        dst_rows = jnp.concatenate(
            [dst_rows, jnp.broadcast_to(dz, (pad, dst_rows.shape[1]))])
        sz = jnp.where(jnp.arange(src_rows.shape[2]) < words, 0, SENTINEL)
        src_rows = jnp.concatenate(
            [src_rows,
             jnp.broadcast_to(sz, (pad,) + src_rows.shape[1:])])
    dshape = dst_rows.reshape(n_chunks, chunk_d, -1)
    sshape = src_rows.reshape(n_chunks, chunk_d, src_rows.shape[1], -1)

    def body(xs):
        d, s = xs
        hub = jnp.sum(jax.lax.population_count(
            d[:, None, :words] & s[:, :, :words]), dtype=jnp.int32)
        if wtv == 0:
            return hub
        ta = s[:, :, words:]                       # [cd, width, wta]
        tb = d[:, words:]                          # [cd, wtv]
        m = (ta[:, :, :, None] == tb[:, None, None, :]) & \
            (ta != SENTINEL)[:, :, :, None]
        return hub + jnp.sum(m, dtype=jnp.int32)

    return jax.lax.map(body, (dshape, sshape))


def _chunk_d_for(width: int) -> int:
    return max(8, TASK_BLOCK // max(width, 8))


def _bucket_counts_fused(dst_rows, src_rows, *, words: int, wtv: int):
    """Whole-bucket fused AND+popcount (+ T compare) → per-row-group int32
    partials, NO lax.map: a sequential chunk loop serializes the pipeline,
    while XLA tiles one big broadcast-reduce at streaming bandwidth.

    Row groups of R keep the int32 partials exact: R is sized so
    R * (per-row upper bound width*(32*words + wta*wtv)) < 2^30."""
    n_pad, width, row_w = src_rows.shape
    wta = row_w - words
    # true per-row maximum: each of `width` tasks contributes <= 32*words
    # hub bits + <= min(wta, wtv) T matches (an intersection cannot exceed
    # the shorter list)
    bound = width * (32 * words + min(wta, wtv)) + 1
    r = max(8, min(1 << 16, (1 << 30) // bound))
    r = 1 << (r.bit_length() - 1)
    assert r * bound < (1 << 31), (r, bound)   # int32 partials stay exact
    g = cdiv(n_pad, r)
    pad = g * r - n_pad
    if pad:
        dz = jnp.where(jnp.arange(dst_rows.shape[1]) < words, 0, SENTINEL)
        dst_rows = jnp.concatenate(
            [dst_rows, jnp.broadcast_to(dz, (pad, dst_rows.shape[1]))])
        sz = jnp.where(jnp.arange(row_w) < words, 0, SENTINEL)
        src_rows = jnp.concatenate(
            [src_rows, jnp.broadcast_to(sz, (pad, width, row_w))])
    d = dst_rows.reshape(g, r, dst_rows.shape[1])
    s = src_rows.reshape(g, r, width, row_w)
    hub = jnp.sum(jax.lax.population_count(
        d[:, :, None, :words] & s[:, :, :, :words]),
        axis=(1, 2, 3), dtype=jnp.int32)
    if wtv == 0:
        return hub
    ta = s[:, :, :, words:]                       # [g, r, width, wta]
    tb = d[:, :, words:]                          # [g, r, wtv]
    m = (ta[:, :, :, :, None] == tb[:, :, None, None, :]) & \
        (ta != SENTINEL)[:, :, :, :, None]
    return hub + jnp.sum(m, axis=(1, 2, 3, 4), dtype=jnp.int32)


@functools.partial(jax.jit, static_argnames=("spec", "fused"))
def _stream_partials(bucket_arrays, salt, *, spec, fused: bool = True):
    """ONE dispatch over all buckets -> concatenated int32 partial sums.
    spec: ((width, wtv, wta, ws), ...) aligned with bucket_arrays — ws is
    the per-bucket bitmap word count (rows are pre-sliced to the dst
    top-word span).

    salt: int32 scalar that only permutes the output order (sum unchanged),
    so back-to-back timing iterations are distinct dispatches."""
    outs = []
    for (dst_rows, src_rows), (width, wtv, _wta, ws) in zip(bucket_arrays,
                                                            spec):
        if fused:
            outs.append(_bucket_counts_fused(dst_rows, src_rows,
                                             words=ws, wtv=wtv))
        else:
            outs.append(_bucket_counts_body(dst_rows, src_rows, words=ws,
                                            wtv=wtv,
                                            chunk_d=_chunk_d_for(width)))
    parts = jnp.concatenate(outs) if outs else jnp.zeros((1,), jnp.int32)
    return jnp.roll(parts, salt)


class StreamEngine:
    """Prepared single-dispatch triangle counter over the stream layout.

    Parity: the fused fast path for src/triangle (omp_base.cc:5-27,
    bs_warp_edge.cuh) — every DAG edge (u,v) contributes
    |N+(u) ∩ N+(v)|; the sum is the exact triangle count."""

    def __init__(self, g, core: int = 4096, classes=WIDTH_CLASSES,
                 wtv_classes=WTV_CLASSES, fused: bool = True):
        self.stream = build_stream(g, core=core, classes=classes,
                                   wtv_classes=wtv_classes)
        self.arrays = tuple((b.dst_rows, b.src_rows)
                            for b in self.stream.buckets)
        self.spec = tuple(b.spec for b in self.stream.buckets)
        self.words = self.stream.layout.words
        self.n_edges = self.stream.n_tasks
        self.fused = fused

    def partials(self, salt: int = 0):
        return _stream_partials(self.arrays, jnp.int32(salt), spec=self.spec,
                                fused=self.fused)

    def count(self) -> int:
        from ..utils.profiling import PROFILER
        PROFILER.count("edge_tasks", self.n_edges)
        PROFILER.count("set_ops_level2", self.n_edges)  # 1 intersection/task
        with PROFILER.phase("device_count"):
            parts = self.partials()
            return int(np.asarray(parts, dtype=np.int64).sum())

    def timed_count(self, iters: int = 8):
        """(count, seconds/iter) — launches `iters` salted dispatches
        back-to-back with ONE host pull in the timed window, so this
        measures sustained dispatch throughput including the per-dispatch
        floor; timed_slope() isolates device compute."""
        import time
        _ = self.count()                      # warm compile
        t0 = time.time()
        outs = [self.partials(salt=i + 1) for i in range(iters)]
        # execution is in order, so pulling the LAST output waits for all
        _ = np.asarray(outs[-1])
        dt = (time.time() - t0) / iters
        totals = [int(np.asarray(o, dtype=np.int64).sum()) for o in outs]
        if any(t != totals[0] for t in totals):
            raise RuntimeError(f"salted dispatches disagree: {totals}")
        return totals[0], dt

    def _frac(self, denom: int = 8) -> "StreamEngine":
        """View of this engine over the first 1/denom of every bucket's
        rows (separately compiled shapes; used by the slope timing — a small
        fraction keeps the full-vs-frac time delta large)."""
        h = lambda n: max(8, n // denom // 8 * 8)
        eng = object.__new__(StreamEngine)
        eng.stream = self.stream
        eng.arrays = tuple((d[: h(d.shape[0])], s[: h(s.shape[0])])
                           for d, s in self.arrays)
        eng.spec = self.spec
        eng.words = self.words
        eng.fused = self.fused
        eng.n_edges = sum(int(b.row_tasks[: h(b.n_dst)].sum())
                          for b in self.stream.buckets)
        return eng

    def timed_slope(self, samples: int = 7):
        """Marginal device throughput via the two-size slope: time the full
        and the 1/8-rows stream as single dispatches (min over samples) and
        divide the task delta by the time delta — cancels the fixed
        dispatch+readback cost. Returns a dict of: edges_per_s (marginal),
        latency_s (single full dispatch incl. readback),
        times_full/times_half (all samples, seconds)."""
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
        return {
            "edges_per_s": de / max(dt, 1e-9),
            "latency_s": min(tf),
            "times_full": tf,
            "times_half": th,
            "tasks_full": self.n_edges,
            "tasks_half": half.n_edges,
        }


def triangle_count_stream(g, core: int = 4096, **kw) -> int:
    """Exact TC via the bucketed reverse-CSR stream engine."""
    return StreamEngine(g, core=core, **kw).count()
