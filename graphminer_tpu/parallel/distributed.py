"""Multi-host distribution: jax.distributed init + partitioned counting.

Parity targets:
  * MPI multi-node counting — rank computes an edge range of the full graph,
    MPI_Allreduce sums (src/triangle/dist_cpu.cpp:33-57, dist_gpu.cpp:9-34).
    jax.distributed.initialize; the per-process counts are summed through
    its coordination service, as MPI_Allreduce sums host counts there.
  * Partitioned counting for graphs too big to replicate — each worker gets
    a vertex-induced halo partition (graph_partition.cc:82-160) and counts
    only tasks anchored at OWNED vertices; the partial counts sum exactly.

Two product entry points:
  count_pattern_partitioned(g, plan, n_parts)   — single process, partitions
      executed sequentially (the out-of-core path: one partition's device
      graph in HBM at a time).
  count_pattern_multiprocess(g, plan)           — after init_distributed(),
      each process counts its own partition and the counts are summed over
      the processes (the dist_gpu equivalent).

launch_local(cmd, nproc, timeout_s) starts the ranks of such a run on one
host (the `mpirun -np N` of a single node).
"""
from __future__ import annotations

import itertools
import os
import socket
import subprocess
import tempfile
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from ..core.plan import Plan
from ..engine.frontier import count_pattern
from .partition import induced_partition_1d


def plan_halo_hops(plan: Plan) -> int:
    """Halo radius a plan needs under owned-anchor partitioned counting.

    1 when every matched vertex is constrained to N(v0) (source adj0, or
    intersects v0's row, or derives from a level-2-anchored stored set) —
    then every vertex of every counted embedding lies in the 1-hop halo of
    v0 and restricted outer-shell rows are complete. Otherwise 2 (the plans
    in core.plan walk at most one edge away from {v0, v1})."""
    anchored = {0, 1}            # vertex levels guaranteed inside N[v0] ∪ {v1}
    anchored_sets = set()
    for i, lp in enumerate(plan.levels):
        idx = i + 2
        kind, j = lp.source
        ok = (kind == 'adj' and j == 0) or \
             (kind == 'set' and j in anchored_sets) or (0 in lp.intersect)
        if ok:
            anchored.add(idx)
            if lp.store:
                anchored_sets.add(idx)
    return 1 if all(i in anchored for i in range(2, plan.k)) else 2


def _count_partition(part, plan: Plan, **kw) -> int:
    """Count plan embeddings whose anchor v0 is OWNED by this partition —
    via count_pattern's candidate-mask mechanism (anchor restricted to owned
    locals; every global task has exactly one owner)."""
    g = part.graph
    assert plan.multiplicity == 1, \
        "partitioned counting needs symmetry-broken (multiplicity-1) plans"
    cand = np.ones((plan.k, g.n_vertices), dtype=np.int8)
    cand[0, ~part.owned_mask] = 0   # anchor must be owned
    return count_pattern(g, plan, cand=cand, **kw)


def count_pattern_partitioned(g, plan: Plan, n_parts: int,
                              hops: Optional[int] = None, **kw) -> int:
    """Exact pattern count over n_parts induced halo partitions, executed
    sequentially in one process — the out-of-core product path
    (graph_partition.cc:82-160 promoted from tests to product).

    Orientation/relabeling happen on the GLOBAL graph first (the partition
    contract); each partition counts tasks anchored at its owned vertices."""
    if plan.use_dag and not g.is_dag:
        g = g.orientation()
    hops = hops or plan_halo_hops(plan)
    parts = induced_partition_1d(g, n_parts, hops=hops)
    total = 0
    for p in parts:
        total += _count_partition(p, plan, **kw)
    return total // plan.multiplicity


# --------------------------------------------------------------------------
# multi-process (jax.distributed)
# --------------------------------------------------------------------------

def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> None:
    """jax.distributed.initialize from args or GRAPHMINER_DIST_* env vars
    (the MPI_Init equivalent; no-op when already initialized)."""
    import jax
    coordinator = coordinator or os.environ.get("GRAPHMINER_COORDINATOR")
    if num_processes is None:
        num_processes = int(os.environ.get("GRAPHMINER_NUM_PROCESSES", "0"))
    if process_id is None:
        process_id = int(os.environ.get("GRAPHMINER_PROCESS_ID", "-1"))
    if not coordinator or num_processes <= 1 or process_id < 0:
        return
    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=num_processes,
                               process_id=process_id)


_sum_calls = itertools.count()
_SUM_WAIT_MS = 600_000


def sum_over_processes(value: int) -> int:
    """Exact sum of one host integer over all processes, through the
    jax.distributed coordination service (the MPI_Allreduce of a rank's
    count in dist_cpu.cpp:56). Every process must call it the same number
    of times. A host integer needs no device collective, so the sum does
    not depend on how the devices of different processes are connected."""
    import jax
    from jax._src import distributed
    n = jax.process_count()
    if n == 1:
        return int(value)
    client = distributed.global_state.client
    key = f"graphminer/sum/{next(_sum_calls)}"
    client.key_value_set(f"{key}/{jax.process_index()}", str(int(value)))
    return sum(int(client.blocking_key_value_get(f"{key}/{i}", _SUM_WAIT_MS))
               for i in range(n))


def count_pattern_multiprocess(g, plan: Plan, hops: Optional[int] = None,
                               progress: Optional[Callable[[str], None]]
                               = None, **kw) -> int:
    """Per-process partition count + global sum over the processes (the
    tc_dist_gpu shape: rank-local count, Allreduce).

    Requires init_distributed() first. Every process must call this with the
    same (global) graph and plan; returns the exact global count on every
    process. progress, when given, is called with the name of each stage as
    it ends: "partition", "local_count", "sum"."""
    import jax

    n_proc = jax.process_count()
    pid = jax.process_index()
    if plan.use_dag and not g.is_dag:
        g = g.orientation()
    hops = hops or plan_halo_hops(plan)
    parts = induced_partition_1d(g, n_proc, hops=hops)
    if progress:
        progress("partition")
    local = _count_partition(parts[pid], plan, **kw) \
        if pid < len(parts) else 0
    if progress:
        progress("local_count")
    total = sum_over_processes(local)
    if progress:
        progress("sum")
    return total // plan.multiplicity


# --------------------------------------------------------------------------
# local launcher
# --------------------------------------------------------------------------

def free_local_port() -> int:
    """A TCP port on 127.0.0.1 that is free now (for the coordinator)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@dataclass
class RankResult:
    rank: int
    returncode: int      # negative: killed by that signal
    stdout: str
    stderr: str


def launch_local(cmd: Sequence[str], nproc: int, timeout_s: float,
                 env: Optional[Dict[str, str]] = None,
                 rank_env: Optional[Callable[[int], Dict[str, str]]] = None,
                 cwd: Optional[str] = None) -> List[RankResult]:
    """Run `cmd + [coordinator, nproc, rank]` as nproc processes on this
    host, coordinator 127.0.0.1:<free port>. env is the base environment
    (default: this process's); rank_env(rank) adds per-rank variables, such
    as the one device a rank may see. A rank that exits non-zero stops the
    others, which would otherwise wait for it in the sum; at timeout_s
    every rank still running is killed. Returns each rank's exit code and
    output."""
    coord = f"127.0.0.1:{free_local_port()}"
    base = dict(os.environ if env is None else env)
    outs = [(tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+"))
            for _ in range(nproc)]
    procs = [subprocess.Popen(
        list(cmd) + [coord, str(nproc), str(i)],
        stdout=outs[i][0], stderr=outs[i][1], text=True, cwd=cwd,
        env={**base, **(rank_env(i) if rank_env else {})})
        for i in range(nproc)]
    deadline = time.monotonic() + timeout_s
    try:
        while any(p.poll() is None for p in procs):
            if any(p.returncode for p in procs) \
                    or time.monotonic() > deadline:
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    results = []
    for i, (p, (fo, fe)) in enumerate(zip(procs, outs)):
        fo.seek(0)
        fe.seek(0)
        results.append(RankResult(i, p.returncode, fo.read(), fe.read()))
        fo.close()
        fe.close()
    return results
