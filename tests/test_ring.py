"""Ring engine (ops/ring.py): exactness vs golden counts + the other
backends, and the O(V·row + E·4B) memory claim."""
import numpy as np
import pytest

from graphminer_tpu.io.synth import rmat
from graphminer_tpu.ops.ring import RingEngine, build_ring, triangle_count_ring


@pytest.fixture(scope="module")
def citeseer(citeseer_path):
    from graphminer_tpu import load_graph
    return load_graph(citeseer_path)


def test_ring_citeseer_golden(citeseer):
    # src/triangle/README.md:53
    assert triangle_count_ring(citeseer) == 1166


def test_ring_vs_stream_rmat14():
    g = rmat(14, 8, seed=11)
    from graphminer_tpu.ops.stream import triangle_count_stream
    want = triangle_count_stream(g)
    eng = RingEngine(g)
    assert eng.count() == want
    # every core-dst task lands in exactly one C bucket; the phase-T bitmap
    # buckets hold the tail tasks whose src core-bitmap is non-zero (the
    # rest contribute 0 there); tail-compare buckets only hold the
    # both-tails subset
    lay = eng.layout
    assert sum(b.n_tasks for b in lay.cbuckets) == lay.n_core_tasks
    n_tail = lay.n_tasks - lay.n_core_tasks
    assert lay.n_b_tasks == sum(b.n_tasks for b in lay.bbuckets)
    assert lay.n_b_tasks <= n_tail
    assert sum(b.n_tasks for b in lay.tbuckets) <= n_tail


def test_ring_small_core_split():
    # tiny core forces a real phase-T population and class extension
    g = rmat(12, 8, seed=3)
    from graphminer_tpu.ops.hubcore import triangle_count_fast
    want = triangle_count_fast(g)
    assert triangle_count_ring(g, core=256) == want


def test_ring_memory_is_lean():
    g = rmat(14, 16, seed=5)
    lay = build_ring(g)
    e = lay.n_tasks
    v = g.n_vertices
    # O(V·row + E·4B): generous bound, far below E·row_w
    assert lay.nbytes() < 4 * (v * lay.words * 8 + e * 24)


def test_ring_salted_partials_same_total():
    g = rmat(12, 8, seed=7)
    eng = RingEngine(g)
    t0 = int(np.asarray(eng.partials(0), dtype=np.int64).sum())
    t1 = int(np.asarray(eng.partials(3), dtype=np.int64).sum())
    assert t0 == t1 == eng.count()
