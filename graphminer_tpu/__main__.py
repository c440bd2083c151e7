"""Command-line interface — the counterpart of the reference's per-workload
binaries (tc_omp_base, clique_gpu_base, sgl_multigpu, …) as subcommands:

    python -m graphminer_tpu tc <graph_prefix>
    python -m graphminer_tpu clique <graph_prefix> 5
    python -m graphminer_tpu sgl <graph_prefix> diamond
    python -m graphminer_tpu motif <graph_prefix> 4
    python -m graphminer_tpu sc <graph_prefix> hourglass
    python -m graphminer_tpu fsm <graph_prefix> 3 100
    python -m graphminer_tpu gks <graph_prefix> 3 1,2,3
    python -m graphminer_tpu info <graph_prefix>

Add --cpu to force the host CPU backend; --sharded to run over all devices.
"""
from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None):
    p = argparse.ArgumentParser(prog="graphminer_tpu")
    p.add_argument("workload", choices=["tc", "clique", "sgl", "motif", "sc",
                                        "fsm", "gks", "query", "info"])
    p.add_argument("graph", help="graph prefix (…/graph)")
    p.add_argument("args", nargs="*", help="workload args")
    from .config import Config
    cfg = Config.from_env()          # GRAPHMINER_* env vars seed the defaults
    p.add_argument("--cpu", action="store_true", help="force CPU backend")
    p.add_argument("--sharded", action="store_true",
                   help="shard over all visible devices")
    p.add_argument("--chunk", type=int, default=cfg.chunk)
    p.add_argument("--backend", default=cfg.backend,
                   help="setops backend: auto | bc | bs")
    p.add_argument("--engine", default=cfg.engine,
                   help="frontier engine: compact | map")
    p.add_argument("--fast", action="store_true",
                   help="fast engines: tc=stream, clique 4/5=hi/lo matmul "
                        "bilinear, clique>=6=streamed recursive hi/lo, "
                        "sgl diamond=tri-support, motif 3/4=formula over "
                        "fast engines")
    p.add_argument("--partition", type=int, default=0, metavar="N",
                   help="count over N induced halo partitions (out-of-core)")
    p.add_argument("--profile", action="store_true",
                   help="print the phase/counter profiler report")
    p.add_argument("--json", action="store_true", help="machine output")
    ns = p.parse_args(argv)
    cfg.chunk, cfg.backend, cfg.engine = ns.chunk, ns.backend, ns.engine

    import jax
    if ns.cpu:
        jax.config.update("jax_platforms", "cpu")
    from . import load_graph

    needs_labels = ns.workload in ("fsm", "gks", "query")
    # FSM patterns carry EDGE labels too (dfscode.h parity): without
    # use_elabel the CLI would compute the collapsed no-elabel count and
    # disagree with the frozen citeseer anchor (4 @ k<=3 minsup=100)
    t0 = time.time()
    g = load_graph(ns.graph, use_vlabel=needs_labels,
                   use_elabel=ns.workload == "fsm")
    t_load = time.time() - t0

    t0 = time.time()
    out = {}
    if ns.workload == "info":
        out = {"V": g.n_vertices, "E": g.n_edges, "max_degree": g.max_degree,
               "has_vlabels": g.vlabels is not None}
    elif ns.workload == "tc":
        from .workloads.triangle import triangle_count
        if ns.partition:
            from .core.plan import TRIANGLE
            from .parallel.distributed import count_pattern_partitioned
            out["total"] = count_pattern_partitioned(g, TRIANGLE,
                                                     ns.partition,
                                                     chunk=ns.chunk)
        elif ns.sharded:
            from .core.plan import clique_plan
            from .parallel.mesh import count_pattern_sharded
            out["total"] = count_pattern_sharded(g, clique_plan(3),
                                                 chunk=ns.chunk)
        elif ns.fast:
            from .ops.stream import triangle_count_stream
            out["total"] = triangle_count_stream(g)
        else:
            out["total"] = triangle_count(g, chunk=ns.chunk,
                                          backend=ns.backend,
                                          bucketed=cfg.bucketed)
    elif ns.workload == "clique":
        from .workloads.clique import clique_count
        k = int(ns.args[0]) if ns.args else 4
        if ns.partition:
            from .core.plan import clique_plan
            from .parallel.distributed import count_pattern_partitioned
            out["total"] = count_pattern_partitioned(g, clique_plan(k),
                                                     ns.partition,
                                                     chunk=ns.chunk)
        elif ns.sharded:
            from .core.plan import clique_plan
            from .parallel.mesh import count_pattern_sharded
            out["total"] = count_pattern_sharded(g, clique_plan(k),
                                                 chunk=ns.chunk)
        else:
            out["total"] = clique_count(g, k, chunk=ns.chunk,
                                        backend=ns.backend, fast=ns.fast)
        out["k"] = k
    elif ns.workload == "sgl":
        from .workloads.sgl import sgl_count
        # pattern = a name (diamond, house, …) or @<pattern_file> in the
        # reference's adjacency-text / CSR-binary formats (pattern.cc:80)
        pattern = ns.args[0] if ns.args else "diamond"
        out["total"] = sgl_count(g, pattern, chunk=ns.chunk,
                                 backend=ns.backend, fast=ns.fast)
        out["pattern"] = pattern
    elif ns.workload == "motif":
        from .workloads.motif import motif_count
        k = int(ns.args[0]) if ns.args else 4
        out["counts"] = motif_count(g, k, chunk=ns.chunk, fast=ns.fast)
        out["k"] = k
    elif ns.workload == "sc":
        from .workloads.count import sc_count
        pattern = ns.args[0] if ns.args else "hourglass"
        out["total"] = sc_count(g, pattern, chunk=ns.chunk)
        out["pattern"] = pattern
    elif ns.workload == "fsm":
        from .workloads.fsm import fsm_count
        k = int(ns.args[0]) if ns.args else 2
        minsup = int(ns.args[1]) if len(ns.args) > 1 else 300
        out["total"] = fsm_count(g, k, minsup)
        out.update(k=k, minsup=minsup)
    elif ns.workload == "query":
        # labeled subgraph query (reference query_omp_base: src/query/main.cc
        # `query <data_graph> <query_graph>`): @<pattern_file> in the
        # reference's adj-text/CSR formats, or an inline spec
        # "<vl0>,<vl1>,...:<u>-<v>,<u>-<v>,..." (labels : edges)
        from .core.pattern_graph import PatternGraph
        from .workloads.query import make_query, query_count
        spec = ns.args[0] if ns.args else None
        if spec is None:
            raise SystemExit("query needs @<pattern_file> or vl,..:u-v,..")
        if spec.startswith("@"):
            q = PatternGraph.from_file(spec[1:])
        else:
            labs, _, edges = spec.partition(":")
            q = make_query([tuple(int(x) for x in e.split("-"))
                            for e in edges.split(",") if e],
                           [int(x) for x in labs.split(",")])
        out["total"] = query_count(g, q, chunk=ns.chunk)
        out["query"] = spec
    elif ns.workload == "gks":
        from .workloads.keyword import gks_count
        k = int(ns.args[0]) if ns.args else 3
        kws = [int(x) for x in (ns.args[1] if len(ns.args) > 1
                                else "1,2,3").split(",")]
        out["total"] = gks_count(g, k, kws)
        out.update(k=k, keywords=kws)
    out["load_s"] = round(t_load, 3)
    out["run_s"] = round(time.time() - t0, 3)
    if ns.profile:
        from .utils.profiling import PROFILER
        rep = PROFILER.report()
        dt = rep["phases_s"].get("device_count", 0.0)
        ops = rep["counters"].get("set_ops_level2", 0)
        if dt and ops:
            rep["set_intersections_per_s"] = ops / dt
        out["profile"] = rep

    if ns.json:
        print(json.dumps(out))
    else:
        for k, v in out.items():
            print(f"{k}: {v}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
