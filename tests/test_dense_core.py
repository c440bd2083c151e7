"""dense_core.py + triangle_count_hybrid: the matmul core/tail hybrid path
(matrix/omp_mm.cpp:104-215 analogue) — differential vs the other backends."""
from graphminer_tpu.io.synth import rmat
from graphminer_tpu.workloads.triangle import (triangle_count,
                                               triangle_count_hybrid)


def test_hybrid_citeseer_golden(citeseer_path):
    from graphminer_tpu import load_graph
    g = load_graph(citeseer_path)
    assert triangle_count_hybrid(g, core_size=512) == 1166


def test_hybrid_vs_bucketed_rmat():
    g = rmat(12, 8, seed=31)
    want = triangle_count(g)
    assert triangle_count_hybrid(g, core_size=1024) == want
