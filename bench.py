"""Headline benchmark — prints ONE JSON line for the driver.

Primary metric: triangle-counting device throughput (oriented edges/s =
set-intersections/s: each edge task is exactly one |N+(u) ∩ N+(v)|) on an
RMAT-18 power-law graph on one device, using the bucketed reverse-CSR stream
engine (ops/stream.py). vs_baseline is measured against 1.0e9 edges/s — the
order-of-magnitude V100 edge rate of the reference's tc_gpu_base (OSDI'22
Fig. 7 scale).

Timing methodology: device throughput is measured by the two-size SLOPE —
time the full stream and a 1/8-rows stream as single dispatches
(trimmed-mean over samples; min/median reported as the band) and divide the
task delta by the time delta, which cancels the fixed per-dispatch cost.
Sustained dispatch throughput and single-dispatch latency are reported
alongside, with per-sample spreads. No number this file prints is claimed
for any device yet: its timing is to be replaced by trace-based per-cell
records.

Robustness (round-4 hardening): EVERY section, including the headline, runs
under graceful degradation — a prep or dispatch failure in one engine
records an error string and falls through (stream → hybrid → ring for the
headline) instead of zeroing the whole round. Correctness at any scale:
known scales check the pinned GOLDEN counts; unknown scales cross-check the
headline engine against an independent second backend (ring) on the same
graph — there is no configuration that reports throughput unchecked.

Secondary metrics: the memory-lean ring engine (ops/ring.py) on RMAT-20 —
the LiveJournal-class path the materialized stream cannot fit — plus the
4/5-clique matmul engines, the diamond tri-support fast path and an FSM run.

Prep persistence: the relabeled/oriented DAG is cached on disk
(io/cache.py) keyed by (scale, edge_factor, seed), so repeat runs skip
graph generation + relabel/orient.
"""
import json
import os
import sys
import time

BENCH_BASELINE_EDGES_PER_S = 1.0e9

# The rmat18 stream's device time is a few ms, near the host clock's jitter,
# so the slope is reported as a BAND: the headline value is the
# TRIMMED-MEAN slope (drop the slowest third per side), with the min- and
# median-based estimators alongside.
# (rmat19 was evaluated as a bigger-signal headline and rejected: with
# the fixed 4096-core its stream layout degrades to ~870 B/task — the
# span classes stop biting; see ops/stream.py docstring.)
SCALE = int(os.environ.get("BENCH_SCALE", "18"))
WSCALE = int(os.environ.get("BENCH_WORK_SCALE", "18"))
EDGE_FACTOR = int(os.environ.get("BENCH_EDGE_FACTOR", "16"))
SAMPLES = int(os.environ.get("BENCH_SAMPLES", "15"))
RING_SCALE = int(os.environ.get("BENCH_RING_SCALE", "20"))
# 6-clique section scale: 14 bounds the run's length; rmat16/18 goldens are
# pinned in GOLDEN_C6 for BENCH_CLIQUE6_SCALE=16/18 runs.
C6_SCALE = int(os.environ.get("BENCH_CLIQUE6_SCALE", str(min(WSCALE, 14))))
# pinned goldens keyed (scale, edge_factor), seed=7; each cross-checked
# between >= 2 independent backends
GOLDEN = {(14, 16): 2860691, (16, 16): 15623664, (18, 16): 82947332,
          (19, 16): 187885040,   # stream and ring engines agree
          (20, 16): 423537282}   # ring engine
GOLDEN_CK = {(18, 16, 4): 2280263816,  # cross-checked vs wedge-Gram engine
             # r5: the rebuilt bucketed-stream k=5 engine reproduces the
             # r4 per-triangle-gather engine's count (different task
             # pipelines, same bilinear), stable across 4+ runs
             (18, 16, 5): 55374832965}
# 6-cliques keyed (scale, ef). Round 5: rmat13/14/16 CONFIRMED by the
# genuinely independent native DAG-DFS backend (gm_kclique — sorted-merge
# intersections, zero shared code with the bilinear engines); rmat13 also
# frontier-verified; rmat18 = two independent runs of the streamed
# engine (the DFS backend needs ~2 h there on this 2-CPU host).
GOLDEN_C6 = {(13, 16): 631682339, (14, 16): 3345978434,
             (16, 16): 59924973905,
             (18, 16): 1123232293537}
# rectangle/house fast-engine goldens keyed (pattern, scale, ef).
# rectangle rmat14 verified against the dense-numpy pair identity
# (scripts/verify_dense_r5.py) and rmat18 split-checked core=4096 vs 1024
# (disjoint case partitions) on two runs; house rmat14 = dense A³
# identity, rmat18 split-checked core=4096 vs 2048.
GOLDEN_SGL = {("rectangle", 12, 16): 52988519,
              ("rectangle", 13, 16): 172972822,
              ("rectangle", 14, 16): 571816674,
              ("rectangle", 18, 16): 51349430411,
              ("house", 14, 16): 294814195705,
              ("house", 18, 16): 71686049455877}


class _SectionTimeout(Exception):
    pass


class _SectionDone(Exception):
    """Early, non-error exit from a section's optional sub-part."""


def _alarm(seconds: int):
    """Best-effort wall-clock guard for OPTIONAL bench sections: SIGALRM
    raises inside the section's try block so one slow section (e.g. FSM on
    a cold compile) cannot eat the driver's whole bench window. Interrupts
    host Python between device calls only — good enough for the chunked
    section loops."""
    import signal

    def handler(signum, frame):
        raise _SectionTimeout(f"section exceeded {seconds}s")

    signal.signal(signal.SIGALRM, handler)
    signal.alarm(seconds)


def _alarm_off():
    import signal
    signal.alarm(0)


SECTION_TIMEOUT = int(os.environ.get("BENCH_SECTION_TIMEOUT", "900"))
# share of device memory the rmat20 hybrid tier may take
HYBRID_FRACTION = 1 / 2


def _dag(scale: int):
    from graphminer_tpu.io import cache
    from graphminer_tpu.io.synth import rmat

    def build():
        g = rmat(scale, EDGE_FACTOR, seed=7)
        return g.relabel_by_degree(descending=False).orientation()

    return cache.cached_graph(f"rmat{scale}_ef{EDGE_FACTOR}_s7_dag", build)


def _gc():
    import gc
    gc.collect()


def _build_headline(g, extra):
    """Stream → hybrid → ring, first one whose prep + warm count succeeds.
    Returns (tag, engine) or (None, None) with errors recorded in extra."""
    from graphminer_tpu.ops.hybrid import HybridEngine
    from graphminer_tpu.ops.ring import RingEngine
    from graphminer_tpu.ops.stream import StreamEngine
    tiers = (("stream", lambda: StreamEngine(g)),
             ("hybrid", lambda: HybridEngine(g)),
             ("ring", lambda: RingEngine(g)))
    for tag, mk in tiers:
        try:
            t0 = time.time()
            eng = mk()
            extra[f"prep_{tag}_s"] = round(time.time() - t0, 1)
            t0 = time.time()
            total = eng.count()
            extra[f"compile_{tag}_s"] = round(time.time() - t0, 1)
            return tag, eng, total
        except Exception as e:
            sys.stderr.write(f"headline {tag} failed: "
                             f"{type(e).__name__}: {e}\n")
            extra[f"{tag}_error"] = f"{type(e).__name__}: {e}"[:200]
            _gc()
    return None, None, None


def _check_headline(g, tag, total, extra):
    """Golden check at known scales; independent-backend cross-check
    otherwise. Returns True iff the count is verified correct."""
    want = GOLDEN.get((SCALE, EDGE_FACTOR))
    if want is not None:
        if total != want:
            extra["headline_error"] = (f"{tag} count {total} != "
                                       f"golden {want}")
            sys.stderr.write(f"WRONG COUNT {total} != {want}\n")
            return False
        extra["headline_check"] = f"golden:{want}"
        return True
    # unknown scale: cross-check against an independent backend — the ring
    # engine, with a non-default core when the headline itself is the ring
    # (different core split => different bucketing/kernel mix)
    try:
        from graphminer_tpu.ops.ring import CORE, RingEngine
        core = (CORE // 4) if tag == "ring" else CORE
        other = f"ring(core={core})"
        xeng = RingEngine(g, core=core)
        xtotal = xeng.count()
        xeng = None
        _gc()
    except Exception as e:
        extra["headline_error"] = f"cross-check failed: {e}"[:200]
        return False
    if xtotal != total:
        extra["headline_error"] = (f"{tag}={total} disagrees with "
                                   f"{other}={xtotal}")
        sys.stderr.write(f"CROSS-CHECK MISMATCH {total} != {xtotal}\n")
        return False
    extra["headline_check"] = f"cross:{other}:{xtotal}"
    return True


def main():
    out = {}
    extra = {}
    edges_per_s = 0.0

    # ---- headline: TC on rmat{SCALE}, stream → hybrid → ring fallback ------
    try:
        t0 = time.time()
        g = _dag(SCALE)
        out["prep_graph_s"] = round(time.time() - t0, 1)
        tag, eng, total = _build_headline(g, extra)
        if eng is not None:
            E = eng.n_edges
            sys.stderr.write(f"rmat{SCALE}: V={g.n_vertices} E(dag)={E} "
                             f"engine={tag}\n")
            if _check_headline(g, tag, total, extra):
                slope = eng.timed_slope(samples=SAMPLES)
                total2, dt_sustained = eng.timed_count(iters=4)
                if total2 != total:
                    raise AssertionError(
                        f"count mismatch {total2} != {total}")
                tf = slope["times_full"]
                th = slope["times_half"]
                med = lambda x: sorted(x)[len(x) // 2]
                de = slope["tasks_full"] - slope["tasks_half"]
                slope_min = slope["edges_per_s"]
                slope_med = de / max(med(tf) - med(th), 1e-9)
                # the device work (a few ms at rmat18) sits near the
                # host clock's one-sided jitter, so single-order
                # statistics scatter. The headline is the
                # TRIMMED-MEAN slope — drop the slowest third of samples
                # on each side (delay noise only), average the rest — and
                # the min/median estimators are reported as the band.
                trim = lambda x: sorted(x)[: max(1, 2 * len(x) // 3)]
                tmean = lambda x: sum(trim(x)) / len(trim(x))
                slope_trim = de / max(tmean(tf) - tmean(th), 1e-9)
                cands = [s for s in (slope_trim, slope_med, slope_min)
                         if s > 0]
                edges_per_s = cands[0] if cands else 0.0
                extra["tc_edges_per_s_slope_min"] = slope_min
                extra["tc_edges_per_s_slope_median"] = slope_med
                extra["tc_edges_per_s_slope_trimmed"] = slope_trim
                sys.stderr.write(
                    f"triangles={total} slope={edges_per_s/1e6:.1f}M "
                    f"edges/s latency={min(tf)*1e3:.1f}ms (spread "
                    f"{min(tf)*1e3:.1f}-{max(tf)*1e3:.1f}) "
                    f"sustained={E/dt_sustained/1e6:.1f}M/s\n")
                extra.update({
                    "headline_engine": tag,
                    # 1 intersection per edge task: the north-star metric
                    "set_intersections_per_s": edges_per_s,
                    "tc_edges_per_s_sustained": E / dt_sustained,
                    "tc_dispatch_latency_ms": min(tf) * 1e3,
                    "tc_latency_spread_ms": [round(x * 1e3, 1) for x in tf],
                    "triangles": total,
                })
        eng = None
        _gc()
    except Exception as e:
        sys.stderr.write(f"headline failed: {type(e).__name__}: {e}\n")
        extra["headline_error"] = f"{type(e).__name__}: {e}"[:200]
        eng = None
        _gc()

    # ---- ring engine at rmat20: the LiveJournal-class memory path ---------
    try:
        _alarm(SECTION_TIMEOUT)
        from graphminer_tpu.ops.ring import RingEngine
        _gc()
        # sanity-check the ring engine against the headline scale's golden
        # (graph already cached) before trusting the big unchecked run
        want_s = GOLDEN.get((SCALE, EDGE_FACTOR))
        if want_s is not None and SCALE != RING_SCALE:
            ring_chk = RingEngine(_dag(SCALE))
            r_chk = ring_chk.count()
            if r_chk != want_s:
                raise AssertionError(
                    f"ring rmat{SCALE} {r_chk} != {want_s}")
            ring_chk = None
            _gc()
        gr = _dag(RING_SCALE)
        t0 = time.time()
        ring = RingEngine(gr)
        extra["ring_prep_s"] = round(time.time() - t0, 1)
        extra["ring_bytes_gb"] = round(ring.layout.nbytes() / 1e9, 3)
        t0 = time.time()
        rtot = ring.count()
        want_r = GOLDEN.get((RING_SCALE, EDGE_FACTOR))
        if want_r is not None and rtot != want_r:
            raise AssertionError(f"ring rmat{RING_SCALE} {rtot} != {want_r}")
        extra["ring_compile_s"] = round(time.time() - t0, 1)
        rs = ring.timed_slope(samples=3)
        extra[f"ring_tc_edges_per_s_rmat{RING_SCALE}"] = rs["edges_per_s"]
        extra[f"ring_triangles_rmat{RING_SCALE}"] = rtot
        sys.stderr.write(
            f"ring rmat{RING_SCALE}: {ring.n_edges} tasks "
            f"{extra['ring_bytes_gb']}GB "
            f"{rs['edges_per_s']/1e6:.1f}M edges/s tri={rtot}\n")
        # hybrid tier at the same scale: ring-C core table + fused
        # sub-core stream (the speed point of the memory ladder).
        # HBM pre-budget (round 5): an r4 validation run OOM'd here and the
        # ResourceExhausted state poisoned every later section; instead of
        # the env gate that replaced it, compute the EXACT materialized
        # stream bytes host-side (plan_only) and only build when the whole
        # hybrid engine fits a conservative budget.
        ring_bytes = ring.layout.nbytes()
        ring = None
        _gc()
        from graphminer_tpu.ops.hybrid import HybridEngine
        from graphminer_tpu.ops.ring import CORE as _RCORE
        from graphminer_tpu.ops.stream import build_stream as _bs
        sub_bytes = _bs(gr, core=_RCORE, dst_below=gr.n_vertices - _RCORE,
                        plan_only=True)
        est = ring_bytes + sub_bytes
        extra["hybrid_bytes_est_gb"] = round(est / 1e9, 3)
        from graphminer_tpu.config import device_memory_budget
        if est > device_memory_budget(HYBRID_FRACTION):
            extra["hybrid_skipped"] = f"est {est/1e9:.2f}GB over budget"
            raise _SectionDone()
        t0 = time.time()
        hyb = HybridEngine(gr)
        extra["hybrid_prep_s"] = round(time.time() - t0, 1)
        extra["hybrid_bytes_gb"] = round(hyb.nbytes() / 1e9, 3)
        htot = hyb.count()
        if htot != rtot:
            raise AssertionError(f"hybrid {htot} != ring {rtot}")
        hs = hyb.timed_slope(samples=3)
        extra[f"hybrid_tc_edges_per_s_rmat{RING_SCALE}"] = hs["edges_per_s"]
        sys.stderr.write(
            f"hybrid rmat{RING_SCALE}: {extra['hybrid_bytes_gb']}GB "
            f"{hs['edges_per_s']/1e6:.1f}M edges/s (== ring count)\n")
        hyb = None
    except _SectionDone:
        pass
    except Exception as e:  # ring metric is additive; never sink the bench
        sys.stderr.write(f"ring bench failed: {type(e).__name__}: {e}\n")
        extra["ring_error"] = f"{type(e).__name__}: {e}"[:200]
    finally:
        _alarm_off()
        ring = ring_chk = gr = hyb = None
        _gc()

    # ---- 4/5-clique: hi/lo-split matmul engine (BASELINE config 2 metric) --
    try:
        _alarm(SECTION_TIMEOUT)
        from graphminer_tpu.ops.cliquek import CliqueKEngine
        _gc()
        for k in (4, 5):
            t0 = time.time()
            ck = CliqueKEngine(_dag(WSCALE), k)
            extra[f"clique{k}_prep_s"] = round(time.time() - t0, 1)
            t0 = time.time()
            ck_total = ck.count()
            extra[f"clique{k}_compile_s"] = round(time.time() - t0, 1)
            want_ck = GOLDEN_CK.get((WSCALE, EDGE_FACTOR, k))
            if want_ck is not None and ck_total != want_ck:
                raise AssertionError(
                    f"{k}-clique {ck_total} != golden {want_ck}")
            cks = ck.timed_slope(samples=3)
            extra[f"clique{k}_edges_per_s_rmat{WSCALE}"] = cks["edges_per_s"]
            extra[f"clique{k}_count_rmat{WSCALE}"] = ck_total
            sys.stderr.write(
                f"{k}-clique rmat{WSCALE}: {ck_total} "
                f"{cks['edges_per_s']/1e6:.1f}M edges/s "
                f"latency={cks['latency_s']*1e3:.0f}ms\n")
            ck = None
            _gc()
    except Exception as e:
        sys.stderr.write(f"cliquek bench failed: {type(e).__name__}: {e}\n")
        extra["cliquek_error"] = f"{type(e).__name__}: {e}"[:200]
    finally:
        _alarm_off()
        ck = None
        _gc()

    # ---- 6-clique: streamed recursive hi/lo engine (OSDI Fig-11 path) ------
    try:
        _alarm(SECTION_TIMEOUT)
        from graphminer_tpu.ops.cliquebig import CliqueBigEngine
        _gc()
        t0 = time.time()
        c6 = CliqueBigEngine(_dag(C6_SCALE), 6)
        extra["clique6_prep_s"] = round(time.time() - t0, 1)
        t0 = time.time()
        c6_total = c6.count()
        dt = time.time() - t0
        want_c6 = GOLDEN_C6.get((C6_SCALE, EDGE_FACTOR))
        if want_c6 is not None and c6_total != want_c6:
            raise AssertionError(f"6-clique {c6_total} != golden {want_c6}")
        extra[f"clique6_count_rmat{C6_SCALE}"] = c6_total
        extra["clique6_total_s"] = round(dt, 1)
        extra["clique6_prefix_tasks_per_s"] = c6.n_hi_tasks / max(dt, 1e-9)
        sys.stderr.write(
            f"6-clique rmat{C6_SCALE}: {c6_total} in {dt:.1f}s "
            f"({c6.n_hi_tasks/1e6:.0f}M prefix tasks, "
            f"{c6.n_hi_tasks/max(dt,1e-9)/1e6:.1f}M tasks/s)\n")
        c6 = None
        _gc()
    except Exception as e:
        sys.stderr.write(f"clique6 bench failed: {type(e).__name__}: {e}\n")
        extra["clique6_error"] = f"{type(e).__name__}: {e}"[:200]
    finally:
        _alarm_off()
        c6 = None
        _gc()

    # ---- diamond via per-edge tri support (BASELINE config 3 analogue) -----
    try:
        _alarm(SECTION_TIMEOUT)
        from graphminer_tpu.io.synth import rmat
        from graphminer_tpu.ops.tri_support import diamond_count_fast
        _gc()
        gu = rmat(WSCALE, EDGE_FACTOR, seed=7)    # undirected input
        t0 = time.time()
        dia = diamond_count_fast(gu)
        dt = time.time() - t0                     # one-shot incl. compiles
        extra[f"diamond_count_rmat{WSCALE}"] = dia
        extra["diamond_total_s"] = round(dt, 1)
        sys.stderr.write(f"diamond rmat{WSCALE}: {dia} in {dt:.1f}s "
                         f"(one-shot incl. compile)\n")
    except Exception as e:
        sys.stderr.write(f"diamond bench failed: {type(e).__name__}: {e}\n")
        extra["diamond_error"] = f"{type(e).__name__}: {e}"[:200]
    finally:
        _alarm_off()
        gu = None
        _gc()

    # ---- rectangle + house fast engines (round 5: the non-clique SGL
    # scale surface — src/sgl/README.md:58 rectangle_bj / house kernels).
    # Counts are golden-checked at known scales (GOLDEN_SGL, cross-checked
    # vs the frontier engine at rmat12/14) and split-checked (core=4096 vs
    # 256 — disjoint case A/B/C partitions) at unpinned scales.
    try:
        _alarm(SECTION_TIMEOUT)
        from graphminer_tpu.io.synth import rmat as _rmat
        from graphminer_tpu.ops.house import house_count_fast
        from graphminer_tpu.ops.rectangle import rectangle_count_fast
        _gc()
        gu = _rmat(WSCALE, EDGE_FACTOR, seed=7)
        for name, fn in (("rectangle", rectangle_count_fast),
                         ("house", house_count_fast)):
            t0 = time.time()
            n = fn(gu)
            dt = time.time() - t0
            want = GOLDEN_SGL.get((name, WSCALE, EDGE_FACTOR))
            if want is not None:
                if n != want:
                    raise AssertionError(f"{name} {n} != golden {want}")
            else:
                n2 = fn(gu, core=256)
                if n2 != n:
                    raise AssertionError(f"{name} split {n2} != {n}")
            extra[f"{name}_count_rmat{WSCALE}"] = n
            extra[f"{name}_total_s"] = round(dt, 1)
            sys.stderr.write(f"{name} rmat{WSCALE}: {n} in {dt:.1f}s "
                             f"(one-shot incl. compile)\n")
            _gc()
    except Exception as e:
        sys.stderr.write(f"sgl-fast bench failed: {type(e).__name__}: "
                         f"{e}\n")
        extra["sgl_fast_error"] = f"{type(e).__name__}: {e}"[:200]
    finally:
        _alarm_off()
        gu = None
        _gc()

    # ---- FSM (BASELINE config 5 analogue): labeled rmat at the OSDI minsup
    # shape (OSDI-experiments-guide.md:109-124 runs mico/patents/youtube at
    # minsup {300..5000}, max_edges=2); rmat14 k=2 minsup=300 finds 50
    # frequent patterns (a CPU run of the same code).
    try:
        _alarm(SECTION_TIMEOUT)
        import numpy as _np
        from graphminer_tpu.io.synth import rmat as _rmatf
        from graphminer_tpu.workloads.fsm import fsm_count
        for scale, grid in ((14, (300,)), (16, (1000, 300))):
            gl = _rmatf(scale, 8, seed=7)
            gl.vlabels = _np.random.default_rng(7).integers(
                1, 5, gl.n_vertices).astype(_np.uint8)
            for ms in grid:
                t0 = time.time()
                nf = fsm_count(gl, 2, ms)
                dtf = round(time.time() - t0, 1)
                if (scale, ms) == (14, 300) and nf != 50:
                    raise AssertionError(f"fsm rmat14 ms=300 {nf} != 50")
                extra[f"fsm_rmat{scale}_k2_ms{ms}_s"] = dtf
                extra[f"fsm_rmat{scale}_k2_ms{ms}_frequent"] = nf
                sys.stderr.write(f"fsm rmat{scale} k=2 ms={ms}: {nf} "
                                 f"in {dtf}s\n")
    except Exception as e:
        sys.stderr.write(f"fsm bench failed: {type(e).__name__}: {e}\n")
        extra["fsm_error"] = f"{type(e).__name__}: {e}"[:200]
    finally:
        _alarm_off()

    out.update({
        "metric": f"tc_edges_per_s_rmat{SCALE}",
        "value": edges_per_s,
        "unit": "edges/s",
        "vs_baseline": edges_per_s / BENCH_BASELINE_EDGES_PER_S,
        "extra_metrics": extra,
    })
    print(json.dumps(out))


if __name__ == "__main__":
    main()
