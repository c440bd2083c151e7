#!/usr/bin/env python3
"""GPU smoke run of graphminer's main path, through the CLI, at pinned goldens.

    python chip_smoke.py           # phases 0-5 on one GPU
    python chip_smoke.py --four    # sharded and 4-process TC on four GPUs

Every input graph is a seeded RMAT graph (io/synth.rmat, edge factor 16,
seed 7, Graph500 parameters) saved in the reference binary format under
smoke_graphs/ and loaded back by the CLI (graphminer_tpu.__main__.main),
which runs in this process. Each workload runs twice, so its line splits the
wall time into graph load, first call (compile included) and second call.
Every count is checked against a golden pinned in bench.py; a wrong count,
or any failure, exits non-zero.

Phases (one GPU): 0 device, 1 TC (stream at rmat18; the bucketed frontier at
rmat16 with both set-op backends), 2 TC at rmat20 (stream vs ring engine,
each prepared once and counted twice),
3 k-clique (4, 5 at rmat18; 6 at rmat14), 4 subgraph listing (rectangle and
diamond at rmat18; house at rmat14), 5 FSM (labeled rmat14, k=2, minsup 300).

With --four the script runs only the multi-GPU checks: `tc --sharded` over a
1x4 mesh against a one-GPU mesh, and count_pattern_multiprocess as four
jax.distributed processes on localhost, one GPU each.

Without a GPU the script prints no result and exits non-zero. The last line
of a successful run is {"ok": true, "device": {...}} with the device as JAX
reports it.
"""
from __future__ import annotations

import argparse
import contextlib
import faulthandler
import io
import json
import os
import subprocess
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
GRAPH_DIR = os.path.join(HERE, "smoke_graphs")
EDGE_FACTOR = 16
SEED = 7

# Pinned goldens (bench.py GOLDEN*, each cross-checked by two backends).
TC = {16: 15_623_664, 18: 82_947_332, 20: 423_537_282}
CLIQUE = {(4, 18): 2_280_263_816, (5, 18): 55_374_832_965,
          (6, 14): 3_345_978_434}
SGL = {("rectangle", 18): 51_349_430_411, ("diamond", 18): 45_873_513_836,
       ("house", 14): 294_814_195_705}
# Labeled rmat14 (edge factor 8, labels default_rng(7).integers(1, 5)),
# k=2, minsup=300: frequent patterns, from a CPU run of the same code.
FSM_RMAT14_K2_MS300 = 50
# Seconds after which a hung run is ended (each run takes a fraction).
DEADLINE_S, FOUR_DEADLINE_S = 1100, 300


class SmokeError(RuntimeError):
    pass


def card_info() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` for the first GPU."""
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if r.returncode != 0:
        raise SmokeError(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def graph_prefix(scale: int, edge_factor: int = EDGE_FACTOR,
                 labeled: bool = False) -> str:
    """Generate (once) and save a seeded RMAT graph; return its prefix."""
    from graphminer_tpu.io.loader import save_graph
    from graphminer_tpu.io.synth import rmat
    name = f"rmat{scale}_ef{edge_factor}_s{SEED}" + ("_vl" if labeled else "")
    prefix = os.path.join(GRAPH_DIR, name, "graph")
    if os.path.exists(prefix + ".meta.txt"):
        return prefix
    g = rmat(scale, edge_factor, seed=SEED)
    if labeled:
        import numpy as np
        g.vlabels = np.random.default_rng(SEED).integers(
            1, 5, g.n_vertices).astype(np.uint8)
    tmp = os.path.join(GRAPH_DIR, name + f".tmp{os.getpid()}")
    save_graph(g, os.path.join(tmp, "graph"))
    os.replace(tmp, os.path.dirname(prefix))
    return prefix


def cli(args) -> dict:
    """One in-process CLI call; returns its JSON output."""
    from graphminer_tpu.__main__ import main
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(list(args) + ["--json"])
    if rc != 0:
        raise SmokeError(f"CLI {args} exited {rc}")
    return json.loads(buf.getvalue().strip().splitlines()[-1])


class Reporter:
    def __init__(self, card: str):
        self.card = card
        self.failed = []

    def line(self, phase: str, **fields) -> None:
        print(json.dumps({"phase": phase, **fields, "card": self.card}),
              flush=True)

    def check(self, phase: str, scale: int, engine: str, count, want,
              **times) -> None:
        ok = count == want
        self.line(phase, scale=scale, engine=engine, count=count,
                  expected=want, ok=ok, **times)
        if not ok:
            self.failed.append(f"{phase}/{engine}: {count} != {want}")


def peak_bytes() -> int:
    import jax
    return int(jax.devices()[0].memory_stats().get("peak_bytes_in_use", 0))


def run_twice(rep: Reporter, phase: str, scale: int, engine: str, want,
              args, key="total") -> None:
    """A workload through the CLI, twice: load, first and second call."""
    a = cli(args)
    b = cli(args)
    if a[key] != b[key]:
        rep.failed.append(f"{phase}/{engine}: calls disagree "
                          f"{a[key]} != {b[key]}")
    rep.check(phase, scale, engine, a[key], want, load_s=a["load_s"],
              first_s=a["run_s"], second_s=b["run_s"],
              peak_device_bytes=peak_bytes())


def phase0(rep: Reporter) -> None:
    import jax
    from graphminer_tpu import native_bridge
    lib_path = os.path.join(native_bridge.NATIVE_DIR, native_bridge.LIB_NAME)
    existed = os.path.exists(lib_path)
    t0 = time.perf_counter()
    lib = native_bridge.get_lib()
    d = jax.devices()[0]
    cache_dir = jax.config.jax_compilation_cache_dir
    rep.line("0-device", device_kind=d.device_kind, count=len(jax.devices()),
             jax=jax.__version__,
             compile_cache_dir=cache_dir,
             compile_cache_env=os.environ.get("JAX_COMPILATION_CACHE_DIR"),
             compile_cache_files=len(os.listdir(cache_dir))
             if cache_dir and os.path.isdir(cache_dir) else 0,
             bytes_limit=int(d.memory_stats()["bytes_limit"]),
             native_library_existed=existed,
             native_built_from_source=not existed and lib is not None,
             native_loaded=lib is not None,
             native_build_s=round(time.perf_counter() - t0, 3),
             native_error=native_bridge.unavailable_reason())
    if lib is None:
        rep.failed.append("0-device: native library did not build or load")
        raise SmokeError(native_bridge.unavailable_reason())


def phase1(rep: Reporter) -> None:
    p18, p16 = graph_prefix(18), graph_prefix(16)
    run_twice(rep, "1-tc", 18, "stream", TC[18], ["tc", p18, "--fast"])
    for backend in ("bc", "bs"):
        run_twice(rep, "1-tc", 16, f"frontier-{backend}", TC[16],
                  ["tc", p16, "--backend", backend])


def phase2(rep: Reporter) -> None:
    """rmat20: the stream and ring engines, each prepared once and counted
    twice (a second CLI call would only repeat the host prep)."""
    from graphminer_tpu import load_graph
    from graphminer_tpu.ops.ring import RingEngine
    from graphminer_tpu.ops.stream import StreamEngine
    t0 = time.perf_counter()
    g = load_graph(graph_prefix(20))
    load_s = round(time.perf_counter() - t0, 3)
    for name, make, nbytes in (
            ("stream", StreamEngine, lambda e: e.stream.nbytes()),
            ("ring", RingEngine, lambda e: e.layout.nbytes())):
        t0 = time.perf_counter()
        eng = make(g)
        t1 = time.perf_counter()
        first = eng.count()
        t2 = time.perf_counter()
        second = eng.count()
        t3 = time.perf_counter()
        if first != second:
            rep.failed.append(f"2-tc/{name}: calls disagree "
                              f"{first} != {second}")
        rep.check("2-tc", 20, name, first, TC[20], load_s=load_s,
                  prep_s=round(t1 - t0, 3), first_s=round(t2 - t1, 3),
                  second_s=round(t3 - t2, 3),
                  layout_bytes=int(nbytes(eng)),
                  peak_device_bytes=peak_bytes())
        del eng


def phase3(rep: Reporter) -> None:
    for (k, scale), want in CLIQUE.items():
        run_twice(rep, "3-clique", scale, f"clique{k}-fast", want,
                  ["clique", graph_prefix(scale), str(k), "--fast"])


def phase4(rep: Reporter) -> None:
    for (pattern, scale), want in SGL.items():
        run_twice(rep, "4-sgl", scale, f"{pattern}-fast", want,
                  ["sgl", graph_prefix(scale), pattern, "--fast"])


def phase5(rep: Reporter) -> None:
    prefix = graph_prefix(14, edge_factor=8, labeled=True)
    run_twice(rep, "5-fsm", 14, "fsm-k2-ms300", FSM_RMAT14_K2_MS300,
              ["fsm", prefix, "2", "300"])


# -- four GPUs --------------------------------------------------------------

def worker(prefix: str, coordinator: str, nproc: int, pid: int) -> int:
    """One rank of the multi-process TC: its halo partition on its GPU.
    Prints one line per stage as it ends, with seconds since start."""
    t0 = time.time()

    def stage(name, **fields):
        print(json.dumps({"rank": pid, "stage": name,
                          "t": round(time.time() - t0, 3),
                          "wall": round(time.time(), 3), **fields}),
              flush=True)

    from graphminer_tpu import load_graph
    from graphminer_tpu.core.plan import TRIANGLE
    from graphminer_tpu.parallel.distributed import (
        count_pattern_multiprocess, init_distributed)
    init_distributed(coordinator=coordinator, num_processes=nproc,
                     process_id=pid)
    import jax
    stage("init", local_devices=[str(d) for d in jax.local_devices()],
          global_devices=jax.device_count())
    g = load_graph(prefix)
    stage("loaded")
    total = count_pattern_multiprocess(g, TRIANGLE, progress=stage)
    stage("done", total=total)
    return 0


def multiprocess_tc(rep: Reporter, prefix: str, scale: int,
                    nproc: int = 4, timeout_s: float = 100) -> None:
    """`nproc` ranks on this host, one GPU each."""
    from graphminer_tpu.parallel.distributed import launch_local
    t0 = time.perf_counter()
    results = launch_local(
        [sys.executable, os.path.abspath(__file__), "--worker", prefix],
        nproc, timeout_s,
        rank_env=lambda i: {"CUDA_VISIBLE_DEVICES": str(i)})
    wall = round(time.perf_counter() - t0, 3)
    stages = [json.loads(l) for r in results for l in r.stdout.splitlines()
              if l.startswith('{"rank"')]
    for st in stages:
        rep.line("four-multiprocess-stage", **st)
    failed = [r for r in results if r.returncode != 0]
    if failed:
        for r in failed:
            print(f"rank {r.rank} exited {r.returncode}:\n{r.stderr[-3000:]}",
                  file=sys.stderr)
        rep.failed.append(f"four-multiprocess: ranks "
                          f"{[r.rank for r in failed]} failed after {wall} s")
        return
    totals = {st["total"] for st in stages if st["stage"] == "done"}
    count = totals.pop() if len(totals) == 1 else sorted(totals)
    rep.check("four-multiprocess", scale, f"{nproc}-process-halo", count,
              TC[scale], wall_s=wall)


def sharded_tc(rep: Reporter, prefix: str, scale: int) -> None:
    import jax
    from graphminer_tpu import load_graph
    from graphminer_tpu.core.plan import clique_plan
    from graphminer_tpu.parallel.mesh import count_pattern_sharded, make_mesh
    rep.line("four-sharded-start", devices=[str(d) for d in jax.devices()])
    a = cli(["tc", prefix, "--sharded"])
    per_dev = [int((d.memory_stats() or {}).get("peak_bytes_in_use", 0))
               for d in jax.devices()]
    rep.check("four-sharded", scale, f"mesh-1x{len(jax.devices())}",
              a["total"], TC[scale], load_s=a["load_s"], first_s=a["run_s"],
              peak_device_bytes=per_dev)
    if min(per_dev) < max(per_dev) / 4:
        rep.failed.append(f"four-sharded: one device held most of the "
                          f"work, peak bytes {per_dev}")
    g = load_graph(prefix)
    t0 = time.perf_counter()
    one = count_pattern_sharded(g, clique_plan(3),
                                mesh=make_mesh(jax.devices()[:1]))
    rep.check("four-sharded", scale, "mesh-1x1", one, a["total"],
              first_s=round(time.perf_counter() - t0, 3))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU checks")
    ap.add_argument("--worker", nargs=4, help=argparse.SUPPRESS,
                    metavar=("PREFIX", "COORD", "NPROC", "PID"))
    ns = ap.parse_args(argv)
    if ns.worker:
        prefix, c, n, i = ns.worker
        try:
            return worker(prefix, c, int(n), int(i))
        except BaseException:
            # exit now: a normal exit would wait for the other ranks at
            # jax.distributed's shutdown barrier
            traceback.print_exc()
            sys.stderr.flush()
            os._exit(1)
    # a check that hangs ends the run, with every thread's traceback
    faulthandler.dump_traceback_later(FOUR_DEADLINE_S if ns.four
                                      else DEADLINE_S, exit=True)
    if ns.four:
        # the four rank processes each take one GPU's memory; this process
        # allocates only what its own checks use
        os.environ["XLA_PYTHON_CLIENT_PREALLOCATE"] = "false"
        # all four GPUs are on this host: collectives set up over loopback,
        # and say why when they fail
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
        os.environ.setdefault("NCCL_DEBUG", "WARN")

    import jax
    import graphminer_tpu  # noqa: F401  (x64 and the compile cache)
    if jax.default_backend() != "gpu":
        print(f"chip_smoke: no GPU (JAX backend {jax.default_backend()!r})",
              file=sys.stderr)
        return 2
    dev = jax.devices()[0]
    rep = Reporter(card_info())
    print(rep.card, flush=True)
    t0 = time.perf_counter()
    if ns.four:
        if len(jax.devices()) < 4:
            print("chip_smoke --four needs four GPUs", file=sys.stderr)
            return 2
        prefix = graph_prefix(18)
        multiprocess_tc(rep, prefix, 18)
        sharded_tc(rep, prefix, 18)
    else:
        for phase in (phase0, phase1, phase2, phase3, phase4, phase5):
            phase(rep)
    rep.line("done", wall_s=round(time.perf_counter() - t0, 3),
             failed=rep.failed)
    if rep.failed:
        print("chip_smoke FAILED: " + "; ".join(rep.failed), file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
