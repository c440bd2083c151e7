"""4-clique counting: per-edge wedge-bitmap Gram as a matmul + tail pass.

Parity: src/clique/gpu_kernels/clique4_warp_edge.cuh:3-31 (per-edge W =
N+(u) ∩ N+(v), then Σ_{w∈W} |W ∩ N+(w)|) and the matrix variant
src/matrix/clique/omp_diamond_mm.cpp:190-284. Device reformulation:

Over the degree-ascending oriented DAG with the closed core (top `core`
ids; see ops/hubcore.py), every DAG edge (u, v) falls in one of two worlds:

* dst v IN the core → N+(v) ⊆ core (closure) → W(u,v) ⊆ core entirely.
  #4-cliques anchored at (u,v) = #core edges inside W = x_Wᵀ B x_W, where
  x_W = bits(CB[u] & CB[v]) and B = the [C, C] core adjacency bits.
  Evaluated per slab of edges as sum((X @ B) ⊙ X) by one matmul with B
  bf16-resident (32 MB): identical MACs to the accumulated-Gram form
  (Σ_e x x ᵀ then ⊙ B) but the per-slab output is [slab] instead of a
  [C, C] int32 accumulator, whose HBM read+write per slab dominated the
  Gram variant. Exact: 0/1 bf16 operands, f32 accumulation, all
  intermediate integers ≤ cpad² = 2^24.

* dst v OUTSIDE the core → u, v both sub-core (low out-degree) → the
  generic bucketed frontier engine runs clique_plan(4) on exactly those
  tasks at their true width classes.

The split is exact and disjoint: every 4-clique u<v<w<y is counted once at
its lowest edge (u,v).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..types import SENTINEL, cdiv, round_up
from .hubcore import build_hub_layout, _expand_bits

CORE = 4096
SLAB = 2048


@functools.partial(jax.jit, static_argnames=("words", "c"))
def _core_adj_bf16(table, *, words: int, c: int):
    """B: [cpad, cpad] bf16 core adjacency bits (rows ≥ c are zero).
    32 MB at C=4096 — built once, resident across the slab loop."""
    v = table.shape[0]
    cpad = words * 32
    bbits = _expand_bits(table[v - c:, :words], cpad)     # [c, cpad] bf16
    return jnp.concatenate(
        [bbits, jnp.zeros((cpad - c, cpad), jnp.bfloat16)]) if cpad > c \
        else bbits


@functools.partial(jax.jit, static_argnames=("words", "slab"))
def _wedge_bilinear(table, bexp, src, dst, *, words: int, slab: int):
    """Σ_e x_Wᵀ B x_W slab by slab as sum((x @ B) ⊙ x) → int32 [n_slabs, 2]
    (per-slab lo/hi 16-bit partial sums; host total = hi·2¹⁶ + lo in int64).

    Same matmul MACs as the Gram formulation but the per-slab output is [slab]
    instead of a [cpad, cpad] int32 accumulator — measured 0.39M → >20M
    edges/s on rmat18 (the Gram variant was HBM-bound on the 64 MB
    accumulator read+write per slab).

    Exactness: y = x @ B entries ≤ |W| ≤ cpad < 2²⁴ (f32 accumulation
    exact); per-edge Σ_j x_j·y_j ≤ |W|² ≤ cpad² = 2²⁴ over non-negative
    terms, so every partial sum is an f32-exact integer in any order."""
    v = table.shape[0]
    cpad = words * 32
    n = src.shape[0]
    n_slabs = cdiv(n, slab)
    ss = src.reshape(n_slabs, slab)
    dd = dst.reshape(n_slabs, slab)

    def body(xs):
        s, d = xs
        ok = (s >= 0) & (s < v) & (d >= 0) & (d < v)
        ru = table[jnp.where(ok, s, 0), :words]
        rv = table[jnp.where(ok, d, 0), :words]
        w = jnp.where(ok[:, None], ru & rv, 0)
        x = _expand_bits(w, cpad)                       # [slab, cpad] bf16
        y = jax.lax.dot_general(x, bexp, (((1,), (0,)), ((), ())),
                                preferred_element_type=jnp.float32)
        per_edge = jnp.sum(x.astype(jnp.float32) * y,
                           axis=1).astype(jnp.int32)    # < 2^25, exact
        lo = jnp.sum(per_edge & 0xFFFF, dtype=jnp.int32)
        hi = jnp.sum(per_edge >> 16, dtype=jnp.int32)
        return jnp.stack([lo, hi])

    return jax.lax.map(body, (ss, dd))


def clique4_count_fast(g, core: int = CORE, slab: int = SLAB,
                       chunk: int = 4096) -> int:
    """Exact 4-clique count via the core Gram + sub-core frontier split."""
    from ..core.plan import clique_plan
    from ..engine.frontier import count_pattern

    rg = g if g.is_dag else g.relabel_by_degree(descending=False).orientation()
    lay = build_hub_layout(rg, core=core)
    cs = lay.core_start
    src, dst = rg.edge_list()

    incore = dst >= cs
    total = 0

    # core-dst edges: per-slab x_Wᵀ B x_W bilinear forms as matmuls
    if incore.any():
        s = src[incore].astype(np.int32)
        d = dst[incore].astype(np.int32)
        npad = round_up(s.shape[0], slab)
        s = np.pad(s, (0, npad - s.shape[0]), constant_values=SENTINEL)
        d = np.pad(d, (0, npad - d.shape[0]), constant_values=SENTINEL)
        bexp = _core_adj_bf16(lay.table, words=lay.words, c=lay.core_size)
        lohi = np.asarray(_wedge_bilinear(
            lay.table, bexp, jnp.asarray(s), jnp.asarray(d),
            words=lay.words, slab=slab), dtype=np.int64)
        total += int(lohi[:, 0].sum() + (lohi[:, 1].sum() << 16))

    # sub-core-dst edges: both endpoints low-degree → bucketed frontier
    if (~incore).any():
        total += count_pattern(rg, clique_plan(4), chunk=chunk,
                               tasks=(src[~incore], dst[~incore]))
    return total


class Clique4Engine:
    """Prepared 4-clique counter (for benchmarking: prep separated from the
    timed Gram dispatch; the tail frontier part is counted once — it is a
    small fraction of the work on power-law graphs)."""

    def __init__(self, g, core: int = CORE, slab: int = SLAB):
        from ..core.plan import clique_plan
        from ..engine.frontier import count_pattern
        rg = g if g.is_dag else \
            g.relabel_by_degree(descending=False).orientation()
        self.lay = build_hub_layout(rg, core=core)
        self.slab = slab
        self._bexp = _core_adj_bf16(self.lay.table, words=self.lay.words,
                                    c=self.lay.core_size)
        cs = self.lay.core_start
        src, dst = rg.edge_list()
        incore = dst >= cs
        self.n_edges = int(src.shape[0])
        s = src[incore].astype(np.int32)
        d = dst[incore].astype(np.int32)
        npad = round_up(max(s.shape[0], slab), slab)
        self.src = jnp.asarray(np.pad(s, (0, npad - s.shape[0]),
                                      constant_values=SENTINEL))
        self.dst = jnp.asarray(np.pad(d, (0, npad - d.shape[0]),
                                      constant_values=SENTINEL))
        self.n_core_edges = int(s.shape[0])
        self.tail_total = 0
        if (~incore).any():
            self.tail_total = count_pattern(
                rg, clique_plan(4), chunk=4096,
                tasks=(src[~incore], dst[~incore]))

    def _gram_total(self, src, dst) -> int:
        lohi = np.asarray(_wedge_bilinear(
            self.lay.table, self._bexp, src, dst, words=self.lay.words,
            slab=self.slab), dtype=np.int64)
        return int(lohi[:, 0].sum() + (lohi[:, 1].sum() << 16))

    def count(self) -> int:
        return self._gram_total(self.src, self.dst) + self.tail_total

    def timed_slope(self, samples: int = 3):
        """Marginal 4-clique edge throughput via the full-vs-half slope over
        the Gram pass (see stream.timed_slope for the methodology)."""
        import time
        nh = max(self.slab, self.src.shape[0] // 2 // self.slab * self.slab)
        sh, dh = self.src[:nh], self.dst[:nh]
        _ = self._gram_total(self.src, self.dst)
        _ = self._gram_total(sh, dh)
        tf, th = [], []
        for i in range(samples):
            t0 = time.time()
            _ = self._gram_total(jnp.roll(self.src, i + 1),
                                 jnp.roll(self.dst, i + 1))
            tf.append(time.time() - t0)
            t0 = time.time()
            _ = self._gram_total(jnp.roll(sh, i + 1), jnp.roll(dh, i + 1))
            th.append(time.time() - t0)
        dt = min(tf) - min(th)
        de = min(self.n_core_edges, self.src.shape[0]) - nh
        return {"edges_per_s": de / max(dt, 1e-9), "latency_s": min(tf),
                "times_full": tf, "times_half": th}
