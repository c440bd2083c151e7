"""Partitioned + multi-process counting (parallel/distributed.py).

The 2-process test is the reference's `mpirun -np 2` smoke (SURVEY §4.6) as
jax.distributed over CPU: two spawned processes, each counting its own
induced halo partition, allgather-summed to the single-process count.
"""
import os
import sys
import textwrap

import pytest

from graphminer_tpu.core.plan import TRIANGLE, DIAMOND, RECTANGLE, clique_plan
from graphminer_tpu.parallel.distributed import (count_pattern_partitioned,
                                                 launch_local, plan_halo_hops,
                                                 sum_over_processes)
from graphminer_tpu.io.synth import rmat


def test_plan_halo_hops():
    from graphminer_tpu.core.plan import HOUSE, PENTAGON
    assert plan_halo_hops(TRIANGLE) == 1
    assert plan_halo_hops(clique_plan(5)) == 1
    assert plan_halo_hops(DIAMOND) == 1
    assert plan_halo_hops(RECTANGLE) == 2
    assert plan_halo_hops(HOUSE) == 2
    assert plan_halo_hops(PENTAGON) == 2


@pytest.fixture(scope="module")
def citeseer(citeseer_path):
    from graphminer_tpu import load_graph
    return load_graph(citeseer_path)


def test_partitioned_triangles(citeseer):
    for n in (2, 3):
        assert count_pattern_partitioned(citeseer, TRIANGLE, n) == 1166


def test_partitioned_diamond(citeseer):
    assert count_pattern_partitioned(citeseer, DIAMOND, 2) == 3730


def test_partitioned_rectangle_needs_2hop(citeseer):
    # rectangle walks away from v0 → hops=2 (auto-selected)
    assert count_pattern_partitioned(citeseer, RECTANGLE, 2) == 6059


def test_partitioned_rmat_4clique():
    g = rmat(11, 8, seed=13)
    from graphminer_tpu.workloads.clique import clique_count
    want = clique_count(g, 4)
    assert count_pattern_partitioned(g, clique_plan(4), 3) == want


_WORKER = textwrap.dedent("""
    import sys
    import jax
    jax.config.update("jax_platforms", "cpu")
    from graphminer_tpu.core.plan import TRIANGLE
    from graphminer_tpu.io.synth import rmat
    from graphminer_tpu.parallel.distributed import (init_distributed,
                                                     count_pattern_multiprocess)
    from graphminer_tpu.parallel.partition import induced_partition_1d
    from graphminer_tpu.workloads.triangle import triangle_count
    coord, nproc, pid = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    init_distributed(coordinator=coord, num_processes=nproc, process_id=pid)
    g = rmat(10, 8, seed=7)
    gd = g.orientation()
    part = induced_partition_1d(gd, nproc, hops=1)[pid]
    print(f"STATS pid={pid} owned={part.n_owned} "
          f"local_edges={part.graph.n_edges}", flush=True)
    total = count_pattern_multiprocess(g, TRIANGLE)
    want = triangle_count(g)
    print(f"TOTAL={total} WANT={want}", flush=True)
    assert total == want, (total, want)
""")


_CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_procs(tmp_path, nproc, timeout=220):
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # no virtual-device forcing in workers
    env["PYTHONPATH"] = _CHECKOUT + os.pathsep + env.get("PYTHONPATH", "")
    results = launch_local([sys.executable, str(script)], nproc, timeout,
                           env=env, cwd=_CHECKOUT)
    outs = []
    for r in results:
        out = r.stdout + r.stderr
        assert r.returncode == 0, f"proc {r.rank} failed:\n{out[-2000:]}"
        assert "TOTAL=" in out, out[-2000:]
        assert f"STATS pid={r.rank} " in out, out[-2000:]
        outs.append(out)
    return outs


def test_sum_over_processes_single():
    # one process: the sum is the value itself, with no coordination service
    assert sum_over_processes(5_000_000_000) == 5_000_000_000


def test_launch_local_stops_ranks(tmp_path):
    """A rank that fails stops the others; the deadline stops a rank that
    hangs. Exit codes and output come back per rank."""
    script = tmp_path / "rank.py"
    script.write_text(textwrap.dedent("""
        import sys, time
        coord, nproc, rank = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
        print(f"rank {rank} of {nproc} at {coord}", flush=True)
        if rank == 1:
            sys.exit(3)
        time.sleep(60)
    """))
    res = launch_local([sys.executable, str(script)], 3, timeout_s=30)
    assert [r.rank for r in res] == [0, 1, 2]
    assert res[1].returncode == 3
    assert res[0].returncode < 0 and res[2].returncode < 0
    assert all(r.stdout.startswith(f"rank {r.rank} of 3 at 127.0.0.1:")
               for r in res)
    res = launch_local([sys.executable, "-c",
                        "import time; time.sleep(60)"], 1, timeout_s=1)
    assert res[0].returncode < 0


@pytest.mark.timeout(240)
def test_two_process_allreduce(tmp_path):
    """jax.distributed 2-process CPU run matching the single-process
    count — the `mpirun -np 2 tc_dist_cpu` equivalence."""
    _run_procs(tmp_path, 2)


@pytest.mark.timeout(420)
def test_four_process_allreduce(tmp_path):
    """4-process spawn (the north-star's 4-way multi-host shape): each
    rank prints its partition stats (owned vertices, halo-local edges) and
    the allgather-summed global count must equal the single-process
    count."""
    outs = _run_procs(tmp_path, 4, timeout=400)
    stats = [l for out in outs for l in out.splitlines()
             if l.startswith("STATS")]
    assert len(stats) == 4


def test_memory_budget_reads_own_device(monkeypatch):
    """Under jax.distributed, jax.devices()[0] may belong to another process,
    whose memory_stats() raises; the budget reads this process's device."""
    import jax
    from graphminer_tpu.config import device_memory_budget

    class Dev:
        platform = "gpu"

        def __init__(self, limit):
            self.limit = limit

        def memory_stats(self):
            if self.limit is None:
                raise RuntimeError("not addressable")
            return {"bytes_limit": self.limit}

    monkeypatch.setattr(jax, "devices", lambda *a: [Dev(None), Dev(8 << 30)])
    monkeypatch.setattr(jax, "local_devices", lambda *a: [Dev(8 << 30)])
    assert device_memory_budget(0.5) == 4 << 30
