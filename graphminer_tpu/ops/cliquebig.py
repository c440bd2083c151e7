"""k-clique counting for k >= 6 — recursive hi/lo core split, streamed.

Parity: the OSDI Fig-11 large-clique runs (orkut/friendster k = 6,7,8 —
/root/reference/OSDI-experiments-guide.md:138-147) and the generated DFS
kernels they use (src/clique/gpu_kernels/, clique/README.md:58). The CUDA
design holds a per-warp stack of (k-3) vertex lists; this redesign keeps
the matmul bilinear of ops/cliquek.py and recurses the hi/lo split instead.

Formulation. Over the degree-ascending oriented DAG with closed core (top
`core` ids), a k-clique a < b < v1 < … < v_{k-2} (v's core-local ascending)
is anchored at its lowest edge (a, b). If b ∈ core every v lives in core
bitmaps and y2 = CB[a] & CB[b]. The LAST pair (v_{k-3}, v_{k-2}) is counted
by the hi bilinear q_hh(y) = x_hiᵀ B_hh x_hi (matmul — cliquek.py docstring);
the prefix (v1 … v_{k-4}) is enumerated explicitly:

    count = Σ_{prefix ⊂ y2 chain} q_hh(y_prefix ∩ hi)   [hi part]
          + Σ_{all-lo (k-3)-cliques d1<…<d_{k-3} ⊂ y2}
                popcount(y2 & C[d1] & … & C[d_{k-3}])    [lo part]
          + frontier(clique_plan(k)) over b ∉ core edges [tail]

Exactness of the split: ids ascend by degree, hi = the TOP hi_dim core ids,
so v_{k-3} ∈ hi ⟺ (v_{k-3}, v_{k-2}) both ∈ hi (v_{k-2} > v_{k-3}) — the
bilinear counts exactly these; otherwise v_{k-3} ∈ lo forces the WHOLE
prefix v1 < … < v_{k-3} into lo (ascending), which is the lo part. Disjoint
and complete.

Scaling. The hi part costs (#(k-2)-clique prefixes) × hi_dim² MACs — hi_dim
shrinks as k grows (default 256 at k=6: rmat18's 2.3B 4-clique prefixes
cost ~1.5e14 MACs of dense matrix products). Prefixes are enumerated on the
host in bounded chunks and STREAMED to device dispatches (the reference's
chunked frontier discipline, pangolin base.cu:153-160); nothing
output-proportional is ever held in memory at once.
"""
from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..types import SENTINEL, cdiv, round_up
from .cliquek import _core_bitmaps, _hi_adj_bf16, _lo_popcount, _pad_rows
from .hubcore import _expand_bits

CORE = 4096
HI6 = 256            # hi_dim default for k = 6 (k=7,8 default narrower)
SLAB = 4096
EDGE_CHUNK = 1 << 14          # case-A edges per host expansion chunk
EXPAND_CHUNK = 1 << 18        # frontier rows per host unpackbits step
DISPATCH_TASKS = 16 << 20     # hi tasks per device dispatch
EXPAND_CAP = 32 << 20         # native expander per-level buffer (tasks)


def _dispatch_pad(state: np.ndarray, mult: int) -> np.ndarray:
    """Pad a final-level state matrix to a power-of-two multiple of mult
    with SENTINEL rows (bounded count of compiled dispatch shapes)."""
    n = state.shape[0]
    tgt = mult
    while tgt < n:
        tgt *= 2
    return _pad_rows(state, tgt)[:tgt]


class _Sink:
    """Accumulates (rows, cols) task slices and fires fixed-size device
    dispatches (ONE compiled shape) when DISPATCH_TASKS are pending; the
    residue is flushed pow2-padded (log2 shape variants, not one per run
    length)."""

    def __init__(self, mult: int, fire):
        self.pend = []
        self.n = 0
        self.mult = mult
        self.fire = fire

    def add(self, rows, cols):
        if rows.size == 0:
            return
        self.pend.append((rows, cols))
        self.n += rows.shape[0]
        while self.n >= DISPATCH_TASKS:
            rows = np.concatenate([p[0] for p in self.pend])
            cols = np.concatenate([p[1] for p in self.pend])
            self.fire(rows[:DISPATCH_TASKS].astype(np.int32),
                      cols[:DISPATCH_TASKS].astype(np.int32))
            self.pend = [(rows[DISPATCH_TASKS:], cols[DISPATCH_TASKS:])]
            self.n -= DISPATCH_TASKS

    def flush(self):
        if not self.n:
            return
        rows = np.concatenate([p[0] for p in self.pend]).astype(np.int32)
        cols = np.concatenate([p[1] for p in self.pend]).astype(np.int32)
        tgt = self.mult
        while tgt < rows.shape[0]:
            tgt *= 2
        self.fire(_pad_rows(rows, tgt)[:tgt], _pad_rows(cols, tgt)[:tgt])
        self.pend, self.n = [], 0



@functools.partial(jax.jit, static_argnames=("hi_words", "slab", "depth"))
def _chain_hi_bilinear(y2hi_tab, core_hi, bhh, rows, cols, *, hi_words: int,
                      slab: int, depth: int):
    """Σ_t q_hh(y2hi[rows[t]] & C_hi[cols[t,0]] & … & C_hi[cols[t,depth-1]])
    → int32 [n_slabs, 2] lo/hi-16 partial sums. The generalisation of
    cliquek._tri_hi_bilinear to depth AND-levels; all gathers are full
    aligned rows from dedicated [*, hi_words] tables."""
    ne = y2hi_tab.shape[0]
    c = core_hi.shape[0]
    hi = hi_words * 32
    rr = rows.reshape(-1, slab)
    cc = cols.reshape(-1, slab, depth)

    def body(xs):
        r, cl = xs
        ok = (r >= 0) & (r < ne)
        y = y2hi_tab[jnp.where(ok, r, 0)]
        for j in range(depth):
            cj = cl[:, j]
            okj = ok & (cj >= 0) & (cj < c)
            y = y & core_hi[jnp.where(okj, cj, 0)]
            ok = okj
        y = jnp.where(ok[:, None], y, 0)
        x = _expand_bits(y, hi)
        z = jax.lax.dot_general(x, bhh, (((1,), (0,)), ((), ())),
                                preferred_element_type=jnp.float32)
        per = jnp.sum(x.astype(jnp.float32) * z, axis=1).astype(jnp.int32)
        return jnp.stack([jnp.sum(per & 0xFFFF, dtype=jnp.int32),
                          jnp.sum(per >> 16, dtype=jnp.int32)])

    return jax.lax.map(body, (rr, cc))


@functools.partial(jax.jit, static_argnames=("words", "hi_words", "slab",
                                             "cap", "cdim"))
def _tri_expand_bilinear(y2full, core_full, y2hi, core_hi, bhh, rows, c1, *,
                         words: int, hi_words: int, slab: int, cap: int,
                         cdim: int):
    """k=6 DEVICE-side quad expansion + bilinear in ONE program:
    for each tri task (edge row r, c1): y3 = y2full[r] & C[c1]; every set
    bit c2 of y3 becomes a quad; quads compact (cumsum+scatter, the
    Pangolin extend→scan→insert shape over core bitmaps) into a fixed
    [cap] buffer and run the hi bilinear q_hh(y2hi[r] & C_hi[c1] &
    C_hi[c2]). Inputs per dispatch are just the [T] tri arrays (~8 bytes
    per tri) — the quads never cross the host link (materialized quads
    would cost ~16 B/task of host-to-device traffic).
    Caller guarantees true quad count <= cap via the popcount prepass.
    Returns int32 [n_slabs, 2] lo/hi-16 partial sums."""
    ne = y2full.shape[0]
    c = core_full.shape[0]
    t = rows.shape[0]
    ok = (rows >= 0) & (rows < ne) & (c1 >= 0) & (c1 < c)
    rs = jnp.where(ok, rows, 0)
    cs = jnp.where(ok, c1, 0)
    y3 = jnp.where(ok[:, None], y2full[rs] & core_full[cs], 0)  # [T, words]
    bits = _expand_bits(y3, cdim, dtype=jnp.int32)              # [T, cdim]
    flat = bits.reshape(-1)
    pos = jnp.cumsum(flat) - 1
    tgt = jnp.where(flat > 0, pos, cap)
    tri_of = jax.lax.broadcasted_iota(jnp.int32, (t, cdim), 0).reshape(-1)
    c2_of = jax.lax.broadcasted_iota(jnp.int32, (t, cdim), 1).reshape(-1)
    qtri = jnp.full((cap,), SENTINEL, jnp.int32).at[tgt].set(
        tri_of, mode="drop")
    qc2 = jnp.full((cap,), SENTINEL, jnp.int32).at[tgt].set(
        c2_of, mode="drop")

    hi = hi_words * 32
    qt = qtri.reshape(-1, slab)
    qc = qc2.reshape(-1, slab)

    def body(xs):
        ti, c2 = xs
        okq = (ti >= 0) & (ti < t) & (c2 >= 0) & (c2 < c)
        tis = jnp.where(okq, ti, 0)
        y = y2hi[rs[tis]] & core_hi[cs[tis]] & \
            core_hi[jnp.where(okq, c2, 0)]
        y = jnp.where((okq & ok[tis])[:, None], y, 0)
        x = _expand_bits(y, hi)
        z = jax.lax.dot_general(x, bhh, (((1,), (0,)), ((), ())),
                                preferred_element_type=jnp.float32)
        per = jnp.sum(x.astype(jnp.float32) * z, axis=1).astype(jnp.int32)
        return jnp.stack([jnp.sum(per & 0xFFFF, dtype=jnp.int32),
                          jnp.sum(per >> 16, dtype=jnp.int32)])

    return jax.lax.map(body, (qt, qc))


def _enum_bits(rows_bm: np.ndarray, n_bits: int):
    """(task_idx, bit_pos) of every set bit below n_bits, per row.
    rows_bm: uint32 [n, w]; bit b of word w = local id w*32+b."""
    if rows_bm.size == 0:
        return (np.zeros(0, np.int64), np.zeros(0, np.int64))
    bits = np.unpackbits(rows_bm.view(np.uint8), axis=1, bitorder="little")
    return np.nonzero(bits[:, :n_bits])


class CliqueBigEngine:
    """Streamed k-clique counter for k >= 6 over the recursive hi/lo split.

    Exact: per-prefix hi bilinears (matmul) + all-lo popcount tasks + sub-core
    frontier tail. Host expansion is chunk-bounded; device dispatches are
    task-bounded; per-task integers < 2^24 (f32-exact), totals in host
    int64."""

    def __init__(self, g, k: int, core: int = CORE, hi: Optional[int] = None,
                 slab: int = SLAB, tail: bool = True,
                 edge_chunk: int = EDGE_CHUNK):
        """tail: count the sub-core frontier tail here (on the default
        device), or False when the caller owns it."""
        assert k >= 6, "use CliqueKEngine for k = 4, 5"
        from ..core.plan import clique_plan
        from ..engine.frontier import count_pattern
        rg = g if g.is_dag else \
            g.relabel_by_degree(descending=False).orientation()
        self.k = k
        self.slab = slab
        # deeper prefixes materialize full-word y chains per level on the
        # host; shrink the edge chunk so the worst level stays ~GB-bounded
        self.edge_chunk = max(256, edge_chunk >> (3 * (k - 6)))
        v = rg.n_vertices
        c = min(core, v)
        cs = v - c
        words = round_up(max(1, cdiv(c, 32)), 8)
        self.c = c
        self.words = words
        hi = hi if hi is not None else max(HI6 >> (2 * (k - 6)), 32)
        # the hi slice (top hi_words words of bitmap space) must reach the
        # valid bits [0, c): hi_dim >= words*32 - c (top bits are padding
        # when c is not a multiple of the 8-word row rounding)
        self.hi_words = min(max(1, hi // 32, words - c // 32), words)
        self.lo_bits = (words - self.hi_words) * 32   # lo = bits [0, lo_bits)
        self.hi_dim = self.hi_words * 32

        bm, core_np, _inb = _core_bitmaps(rg, cs, c, words)
        self.bm_np = bm
        self.core_np = core_np
        src, dst = rg.edge_list()
        case_a = dst >= cs
        self.n_edges = int(src.shape[0])
        self.ea = src[case_a].astype(np.int64)
        self.eb = dst[case_a].astype(np.int64)
        self.n_core_edges = int(self.ea.shape[0])

        self.bm_dev = jnp.asarray(bm.view(np.int32))
        self.core_dev = jnp.asarray(core_np.view(np.int32))
        self.core_hi = jnp.asarray(
            np.ascontiguousarray(core_np[:, words - self.hi_words:])
            .view(np.int32))
        self.bhh = _hi_adj_bf16(self.core_dev, words=words,
                                hi_words=self.hi_words)
        # per-case-A-edge hi slice of y2, device-resident (rows gathered by
        # global edge row at count time)
        y2hi = np.empty((max(self.n_core_edges, 1), self.hi_words),
                        dtype=np.uint32)
        y2hi[:] = 0
        for s in range(0, self.n_core_edges, EXPAND_CHUNK):
            a = self.ea[s:s + EXPAND_CHUNK]
            b = self.eb[s:s + EXPAND_CHUNK]
            y2hi[s:s + a.shape[0]] = (bm[a] & bm[b])[:, words - self.hi_words:]
        self.y2hi = jnp.asarray(y2hi.view(np.int32))

        self.tail_total = 0
        if tail and (~case_a).any():
            self.tail_total = count_pattern(
                rg, clique_plan(k), chunk=4096,
                tasks=(src[~case_a], dst[~case_a]))

        # streaming statistics (filled by count)
        self.n_hi_tasks = 0
        self.n_lo_tasks = 0

    # -- host expansion ----------------------------------------------------

    def _expand_prefixes(self, rows: np.ndarray, y: np.ndarray, depth: int):
        """Enumerate (k-2-…)-prefix chains: yields (rows, cols[n, depth])
        of hi tasks in bounded slices. rows: global edge-row ids; y: the
        matching y2 (full words). Iterative level expansion with host ANDs;
        the LAST level only enumerates (device re-ANDs on the hi slice)."""
        cols = np.zeros((rows.shape[0], 0), dtype=np.int64)
        for level in range(depth):
            ti, cl = _enum_bits(y, self.c)
            rows = rows[ti]
            cols = np.concatenate([cols[ti], cl[:, None]], axis=1)
            if level < depth - 1:
                y = y[ti] & self.core_np[cl]
        return rows, cols

    def _expand_lo_cliques(self, rows: np.ndarray, y: np.ndarray,
                           depth: int):
        """All-lo (depth)-cliques inside y2: (rows, dcols[n, depth]) with
        every d below the hi cut; host ANDs restricted to lo words."""
        lo_w = self.words - self.hi_words
        if lo_w == 0:
            return rows[:0], np.zeros((0, depth), dtype=np.int64)
        w = y[:, :lo_w]
        dcols = np.zeros((rows.shape[0], 0), dtype=np.int64)
        for level in range(depth):
            ti, cl = _enum_bits(w, self.lo_bits)
            rows = rows[ti]
            dcols = np.concatenate([dcols[ti], cl[:, None]], axis=1)
            if level < depth - 1:
                w = w[ti] & self.core_np[cl][:, :lo_w]
        return rows, dcols

    # -- device totals -----------------------------------------------------

    # device-expansion path tuning (k = 6)
    T6 = 1 << 16          # tri tasks per dispatch (fixed shape)
    CAP6 = 4 << 20        # quad capacity per dispatch
    QSLAB = 1 << 14       # quads per bilinear slab inside the kernel
    Y2FULL_FRACTION = 1 / 4   # share of device memory for the y2full table
    # below this tri count the host streaming path wins (the fixed-shape
    # dispatches cost more in compile and padding than they save); the
    # device path exists for rmat18-class runs, where shipping materialized
    # quads to the device (~16 B/task) is the bottleneck
    DEV6_MIN_TRIS = 1 << 25

    def _count6_device(self) -> Optional[int]:
        """k=6 fast path: device-side quad expansion (see
        _tri_expand_bilinear). Returns None when unavailable (no native
        lib, or the y2full table exceeds the budget) — caller falls back
        to the host streaming path."""
        from .. import native_bridge
        from ..config import device_memory_budget
        if self.k != 6 or native_bridge.get_lib() is None or \
                not hasattr(native_bridge.get_lib(), "gm_count_multi"):
            return None
        if self.n_core_edges * self.words * 4 > \
                device_memory_budget(self.Y2FULL_FRACTION):
            return None
        ea32 = self.ea.astype(np.int32)
        eb32 = self.eb.astype(np.int32)
        if self.n_core_edges == 0:
            return None
        # exact tri-task count up front: below the threshold the fixed
        # big-dispatch shapes cost more (compile + padding) than the host
        # streaming path
        est = native_bridge.count_multi([self.bm_np, self.bm_np],
                                        [ea32, eb32], self.words, self.c)
        if int(est.sum(dtype=np.int64)) < self.DEV6_MIN_TRIS:
            return None
        y2full = jax.jit(lambda bm, a, b: bm[a] & bm[b])(
            self.bm_dev, jnp.asarray(ea32), jnp.asarray(eb32))

        # host: enumerate tri tasks (erow, c1) via the native expander
        tri_parts = []
        self._native_stream(1, self.c, 3, lambda st: tri_parts.append(
            np.ascontiguousarray(st[:, 2:4])))
        tris = (np.concatenate(tri_parts) if tri_parts
                else np.zeros((0, 2), np.int32))
        n_tri = tris.shape[0]
        self.n_hi_tasks = 0
        outs = []
        if n_tri:
            terow = np.ascontiguousarray(tris[:, 0])
            tc1 = np.ascontiguousarray(tris[:, 1])
            counts = native_bridge.count_multi(
                [self.bm_np, self.bm_np, self.core_np],
                [ea32[terow], eb32[terow], tc1], self.words, self.c)
            self.n_hi_tasks = int(counts.sum(dtype=np.int64))
            csum = np.concatenate([[0], np.cumsum(counts, dtype=np.int64)])
            cdim = self.words * 32
            b = 0
            while b < n_tri:
                # largest e with quads <= CAP6 and e - b <= T6
                e = int(np.searchsorted(csum, csum[b] + self.CAP6,
                                        side="right")) - 1
                e = min(max(e, b + 1), b + self.T6, n_tri)
                rr = np.full(self.T6, SENTINEL, np.int32)
                cc = np.full(self.T6, SENTINEL, np.int32)
                rr[: e - b] = terow[b:e]
                cc[: e - b] = tc1[b:e]
                outs.append(_tri_expand_bilinear(
                    y2full, self.core_dev, self.y2hi, self.core_hi,
                    self.bhh, jnp.asarray(rr), jnp.asarray(cc),
                    words=self.words, hi_words=self.hi_words,
                    slab=self.QSLAB, cap=self.CAP6, cdim=cdim))
                b = e

        # lo cliques + tail exactly as the streaming path
        lo_outs = []

        def lo_emit(state):
            self.n_lo_tasks += state.shape[0]
            lo_outs.append(_lo_popcount(
                self.bm_dev, self.core_dev,
                jnp.asarray(_dispatch_pad(state, 4096)),
                words=self.words, chunk=4096, nrow=int(state.shape[1])))

        self.n_lo_tasks = 0
        self._native_stream(self.k - 3, self.lo_bits, 2, lo_emit)
        total = self.tail_total
        for arr in outs:
            a = np.asarray(arr, dtype=np.int64)
            total += int(a[:, 0].sum() + (a[:, 1].sum() << 16))
        for arr in lo_outs:
            total += int(np.asarray(arr, dtype=np.int64).sum())
        return total

    def count(self) -> int:
        k = self.k
        if k == 6:
            got = self._count6_device()
            if got is not None:
                return got
        self.n_hi_tasks = self.n_lo_tasks = 0
        outs = []                   # device partials, pulled ONCE at the end

        def hi_dispatch(rr, cc):
            outs.append(("hi", _chain_hi_bilinear(
                self.y2hi, self.core_hi, self.bhh, jnp.asarray(rr),
                jnp.asarray(cc), hi_words=self.hi_words, slab=self.slab,
                depth=k - 4)))

        def lo_dispatch(rr, cc):
            # flush pads rows with SENTINEL (int32 max — positive!)
            ok = (rr >= 0) & (rr < self.n_core_edges)
            safe = np.where(ok, rr, 0)
            cols = np.concatenate(
                [self.ea[safe][:, None], self.eb[safe][:, None], cc],
                axis=1).astype(np.int32)
            cols[~ok] = SENTINEL
            outs.append(("lo", _lo_popcount(
                self.bm_dev, self.core_dev, jnp.asarray(cols),
                words=self.words, chunk=4096, nrow=int(cols.shape[1]))))

        hi_sink = _Sink(self.slab, hi_dispatch)
        lo_sink = _Sink(4096, lo_dispatch)

        from .. import native_bridge
        native = (native_bridge.get_lib() is not None
                  and hasattr(native_bridge.get_lib(), "gm_expand_emit"))
        if native:
            def hi_emit(state):
                self.n_hi_tasks += state.shape[0]
                state = _dispatch_pad(state, self.slab)
                hi_dispatch(np.ascontiguousarray(state[:, 2]),
                            np.ascontiguousarray(state[:, 3:]))

            def lo_emit(state):
                self.n_lo_tasks += state.shape[0]
                # state IS the (a, b, d1..d_{k-3}) layout _lo_popcount wants
                outs.append(("lo", _lo_popcount(
                    self.bm_dev, self.core_dev,
                    jnp.asarray(_dispatch_pad(state, 4096)),
                    words=self.words, chunk=4096,
                    nrow=int(state.shape[1]))))

            self._native_stream(k - 4, self.c, 3, hi_emit)
            self._native_stream(k - 3, self.lo_bits, 2, lo_emit)
        else:
            for s0 in range(0, self.n_core_edges, self.edge_chunk):
                a = self.ea[s0:s0 + self.edge_chunk]
                b = self.eb[s0:s0 + self.edge_chunk]
                rows = (s0 + np.arange(a.shape[0])).astype(np.int64)
                y2 = self.bm_np[a] & self.bm_np[b]
                hr, hc = self._expand_prefixes(rows, y2, k - 4)
                self.n_hi_tasks += int(hr.shape[0])
                if hr.size:
                    hi_sink.add(hr, hc)
                lr, lc = self._expand_lo_cliques(rows, y2, k - 3)
                self.n_lo_tasks += int(lr.shape[0])
                if lr.size:
                    lo_sink.add(lr, lc)
        hi_sink.flush()
        lo_sink.flush()

        total = self.tail_total
        for kind, arr in outs:
            a = np.asarray(arr, dtype=np.int64)
            if kind == "hi":
                total += int(a[:, 0].sum() + (a[:, 1].sum() << 16))
            else:
                total += int(a.sum())
        return total

    def _native_stream(self, depth: int, n_bits: int, anchor: int, emit):
        """Drive the native state-carrying expander (gm_expand_emit) down
        `depth` levels and hand DISPATCH_TASKS-sized final-level state
        matrices to `emit`. State columns: [a, b, (erow,)? c0, c1, ...] —
        `anchor` = 3 keeps the edge-row id (hi bilinear path), 2 drops it
        (lo popcount path, whose task layout is exactly (a, b, d...)).
        Every level's buffer is bounded; all assembly happens inside the C
        expander (OpenMP) — the previous numpy gather/concatenate assembly
        ran single-threaded and dominated rmat18 k=6 (26 min)."""
        from .. import native_bridge
        if depth == 0:
            return
        D = DISPATCH_TASKS
        final_buf = np.empty((D, anchor + depth), np.int32)
        fill = [0]

        def flush():
            if fill[0]:
                emit(final_buf[: fill[0]])
                fill[0] = 0

        def rec(level, cols_list):
            n = cols_list[0].shape[0]
            bases = [self.bm_np, self.bm_np] + [self.core_np] * level
            rows = [cols_list[0], cols_list[1]] + list(cols_list[anchor:])
            start = 0
            if level == depth - 1:
                while start < n:
                    n_em, nxt = native_bridge.expand_emit(
                        bases, rows, cols_list, self.words, n_bits, start,
                        D - fill[0], final_buf[fill[0]:])
                    if n_em == 0 and nxt == start:
                        if fill[0] == 0:
                            raise RuntimeError("task exceeds dispatch cap")
                        flush()
                        continue
                    fill[0] += n_em
                    start = nxt
                    if fill[0] == D:
                        flush()
                return
            buf = np.empty((EXPAND_CAP, anchor + level + 1), np.int32)
            while start < n:
                n_em, nxt = native_bridge.expand_emit(
                    bases, rows, cols_list, self.words, n_bits, start,
                    EXPAND_CAP, buf)
                if n_em == 0 and nxt == start:
                    raise RuntimeError(f"EXPAND_CAP {EXPAND_CAP} too small")
                if n_em:
                    sub = np.ascontiguousarray(buf[:n_em].T)
                    rec(level + 1, [sub[j] for j in range(sub.shape[0])])
                start = nxt

        top = [np.ascontiguousarray(self.ea.astype(np.int32)),
               np.ascontiguousarray(self.eb.astype(np.int32))]
        if anchor == 3:
            top.append(np.arange(self.n_core_edges, dtype=np.int32))
        rec(0, top)
        flush()


def cliquebig_count(g, k: int, core: int = CORE,
                    hi: Optional[int] = None) -> int:
    """Exact k-clique count for k >= 6 via the streamed recursive engine."""
    return CliqueBigEngine(g, k, core=core, hi=hi).count()
