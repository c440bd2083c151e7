"""Hybrid engine: ring phase C + materialized sub-core stream.

The rmat20-scale profile of the ring engine (ops/ring.py) splits cleanly:

* phase C (core-dst tasks, the large majority on power-law DAGs) runs at
  ~235M tasks/s device — its dst rows come from the 2 MB core table, which
  the XLA gather handles well;
* phases B/T (sub-core-dst tasks) are stuck at ~35M tasks/s on the row
  GATHER WALL (~10-30 ns/row regardless of row width — measured with a
  words ∈ {128, 32, 8} sweep; narrowing rows does not fix it, and a
  binary-search tail compare was 54x worse).

The fix is the stream engine's trick (ops/stream.py) applied ONLY where it
is affordable: sub-core tasks get prep-time MATERIALIZED task-aligned src
rows — every count-time read is a sequential HBM stream (measured
~460M tasks/s) — while the dominant core-dst tasks keep the O(V·row)
ring table. Memory: O(V·row + E_core·4B + E_subcore·row). Round-5
reality check (exact plan_only sizing): at rmat20 the sub-core slice
measures 16.1 GB — sub-dst tasks carry wide T-compare slots (wta·4B per
slot) that dwarf the bitmap part — so this tier serves rmat18/19-class
graphs; rmat20+ runs the pure ring (~1 GB, 10x slower). bench.py gates
the tier on the exact pre-build estimate instead of discovering this as
an OOM (the r4 failure mode).

Parity: the reference's tiered strategy choice per edge class
(src/common.mk:73-74 strategy dispatch; include/set_intersect.cuh cached
fetch for the hot tier) re-expressed as memory-tier choice per dst class.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from . import ring as _ring
from . import stream as _stream


@functools.partial(jax.jit,
                   static_argnames=("cspec", "sspec", "words_r"))
def _hybrid_partials(core_bm, carrays, bucket_arrays, salt, *, cspec, sspec,
                     words_r: int):
    """ONE dispatch: ring phase-C buckets + stream buckets → int32 partials.
    salt permutes output order only (benchmark dispatch distinctness)."""
    outs = []
    for (src_bm, dst_loc), wc in zip(carrays, cspec):
        outs.append(_ring._cbucket_partials(
            core_bm, src_bm, dst_loc, words=words_r, wc=wc, per_task=False))
    for (dst_rows, src_rows), (width, wtv, _wta, ws) in zip(bucket_arrays,
                                                            sspec):
        outs.append(_stream._bucket_counts_fused(
            dst_rows, src_rows, words=ws, wtv=wtv))
    parts = jnp.concatenate(outs) if outs else jnp.zeros((1,), jnp.int32)
    return jnp.roll(parts, salt)


class HybridEngine:
    """Prepared triangle counter: ring core table + sub-core stream.

    Parity: the fused fast path for src/triangle (omp_base.cc:5-27,
    bs_warp_edge.cuh) — every DAG edge (u,v) contributes |N+(u) ∩ N+(v)|."""

    def __init__(self, g, core: int = _ring.CORE):
        rg = (g if g.is_dag
              else g.relabel_by_degree(descending=False).orientation())
        self.ring = _ring.build_ring(rg, core=core, phases="C")
        self.stream = _stream.build_stream(
            rg, core=core, dst_below=self.ring.core_start)
        self.carrays = tuple((b.src_bm, b.dst_loc)
                             for b in self.ring.cbuckets)
        self.cspec = tuple(b.wc for b in self.ring.cbuckets)
        self.sarrays = tuple((b.dst_rows, b.src_rows)
                             for b in self.stream.buckets)
        self.sspec = tuple(b.spec for b in self.stream.buckets)
        assert (self.ring.n_core_tasks + self.stream.n_tasks
                == self.ring.n_tasks), "core/sub-core split must cover E"
        self.n_edges = self.ring.n_tasks

    def nbytes(self) -> int:
        return self.ring.nbytes() + self.stream.nbytes()

    def partials(self, salt: int = 0):
        return _hybrid_partials(
            self.ring.core_bm, self.carrays, self.sarrays, jnp.int32(salt),
            cspec=self.cspec, sspec=self.sspec, words_r=self.ring.words)

    def count(self) -> int:
        from ..utils.profiling import PROFILER
        PROFILER.count("edge_tasks", self.n_edges)
        PROFILER.count("set_ops_level2", self.n_edges)
        with PROFILER.phase("device_count"):
            return int(np.asarray(self.partials(), dtype=np.int64).sum())

    def timed_count(self, iters: int = 8):
        """(count, seconds/iter): salted back-to-back dispatches, one host
        pull in the timed window (see stream.StreamEngine.timed_count)."""
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

    def _frac(self, denom: int = 8) -> "HybridEngine":
        """First-1/denom-rows view of every bucket (slope timing)."""
        h = lambda n: max(8, n // denom // 8 * 8)
        eng = object.__new__(HybridEngine)
        eng.ring = self.ring
        eng.stream = self.stream
        eng.carrays = tuple((bm[: h(bm.shape[0])], dl[: h(dl.shape[0])])
                            for bm, dl in self.carrays)
        eng.cspec = self.cspec
        eng.sarrays = tuple((d[: h(d.shape[0])], s[: h(s.shape[0])])
                            for d, s in self.sarrays)
        eng.sspec = self.sspec
        eng.n_edges = (
            sum(int(b.row_tasks[: h(b.row_tasks.shape[0])].sum())
                for b in self.ring.cbuckets)
            + sum(int(b.row_tasks[: h(b.n_dst)].sum())
                  for b in self.stream.buckets))
        return eng

    def timed_slope(self, samples: int = 5):
        """Marginal device throughput via the full-vs-1/8 two-size slope
        (cancels the fixed per-dispatch cost; see stream.timed_slope)."""
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


def triangle_count_hybrid_tier(g, core: int = _ring.CORE) -> int:
    """Exact TC via the hybrid (ring-C + sub-core stream) engine."""
    return HybridEngine(g, core=core).count()
