"""Hybrid engine (ops/hybrid.py): ring phase C + materialized sub-core
stream — exactness vs goldens and the other backends, memory tiering."""
import numpy as np
import pytest

from graphminer_tpu.io.synth import rmat
from graphminer_tpu.ops.hybrid import HybridEngine, triangle_count_hybrid_tier


@pytest.fixture(scope="module")
def citeseer(citeseer_path):
    from graphminer_tpu import load_graph
    return load_graph(citeseer_path)


def test_hybrid_citeseer_golden(citeseer):
    # src/triangle/README.md:53
    assert triangle_count_hybrid_tier(citeseer) == 1166


def test_hybrid_vs_ring_rmat14():
    g = rmat(14, 8, seed=11)
    from graphminer_tpu.ops.ring import triangle_count_ring
    want = triangle_count_ring(g)
    eng = HybridEngine(g)
    assert eng.count() == want
    # the split covers every DAG edge exactly once
    assert eng.ring.n_core_tasks + eng.stream.n_tasks == eng.n_edges


def test_hybrid_small_core_forces_stream_tier():
    # tiny core pushes most tasks into the materialized sub-core stream
    g = rmat(12, 8, seed=3)
    from graphminer_tpu.ops.hubcore import triangle_count_fast
    want = triangle_count_fast(g)
    eng = HybridEngine(g, core=256)
    assert eng.stream.n_tasks > 0
    assert eng.count() == want


def test_hybrid_memory_between_ring_and_stream():
    g = rmat(14, 16, seed=5)
    from graphminer_tpu.ops.ring import build_ring
    from graphminer_tpu.ops.stream import build_stream
    eng = HybridEngine(g)
    full_stream = build_stream(g)
    # materializing only the sub-core slice must cost less than the full
    # stream (the whole point of the tiering)...
    assert eng.stream.nbytes() < full_stream.nbytes()
    # ...and the hybrid total sits strictly between the phase-C-only ring
    # and phase-C ring + full stream (the tiering bounds)
    ring_c = build_ring(g, phases="C")
    assert ring_c.nbytes() < eng.nbytes() < (ring_c.nbytes()
                                             + full_stream.nbytes())


def test_hybrid_salted_partials_same_total():
    g = rmat(12, 8, seed=7)
    eng = HybridEngine(g)
    t0 = int(np.asarray(eng.partials(0), dtype=np.int64).sum())
    t1 = int(np.asarray(eng.partials(3), dtype=np.int64).sum())
    assert t0 == t1


def test_hybrid_frac_view_counts():
    g = rmat(13, 8, seed=9)
    eng = HybridEngine(g)
    half = eng._frac(8)
    assert 0 < half.n_edges < eng.n_edges
    # the frac view must still be a valid program (count runs, >= 0)
    assert int(np.asarray(half.partials(), dtype=np.int64).sum()) >= 0
