"""Bucketed reverse-CSR stream engine (ops/stream.py) — differential tests.

The stream engine is the round-2 headline TC fast path; it must agree
bit-exactly with the generic setops backend and the golden counts
(src/triangle/README.md:53) across core sizes and width-class configs.
Small class tuples keep CPU compile time down; the device defaults share the
same code paths.
"""
import numpy as np
import pytest

from graphminer_tpu.ops.stream import StreamEngine, triangle_count_stream
from graphminer_tpu.workloads.triangle import triangle_count
import oracle

CLASSES = (4, 32, 256)
WTV = (0, 16)


def test_citeseer_golden(citeseer):
    t = triangle_count_stream(citeseer, core=128, classes=CLASSES,
                              wtv_classes=WTV)
    assert t == 1166


def test_random_vs_oracle(rand_graphs):
    for g in rand_graphs[:2]:
        want = oracle.triangles(g)
        t = triangle_count_stream(g, core=16, classes=CLASSES,
                                  wtv_classes=WTV)
        assert t == want


def test_core_sizes(rand_graphs):
    g = rand_graphs[3]
    want = oracle.triangles(g)
    for core in (1, 8, 1024):  # degenerate, partial, whole-graph cores
        t = triangle_count_stream(g, core=core, classes=CLASSES,
                                  wtv_classes=WTV)
        assert t == want, core


def test_salt_permutes_not_changes(rand_graphs):
    g = rand_graphs[0]
    eng = StreamEngine(g, core=16, classes=CLASSES, wtv_classes=WTV)
    p0 = np.asarray(eng.partials(salt=0), dtype=np.int64)
    p1 = np.asarray(eng.partials(salt=3), dtype=np.int64)
    assert p0.sum() == p1.sum()
    assert (np.sort(p0) == np.sort(p1)).all()


def test_wta_ladder_off_class_regression():
    """r3 regression: a row's max src-tail width strictly between wta
    ladder classes (here 40 ∈ (32, 64)) made the ladder pick a class wider
    than the layout's physical wt_pad, crashing _materialize's reshape.
    Hand-built DAG: vertex 0 has 40 sub-core out-neighbors (wt_max = 40 →
    wt_pad = 40); the (src=0, dst=41) task lands in a wtv>0 bucket whose
    row_wta = 40 rounds to ladder class 64 > wt_pad without the clamp."""
    import dataclasses
    from graphminer_tpu.core.graph import HostGraph
    src = [0] * 40 + [41, 41]
    dst = list(range(1, 39)) + [41, 42] + [42, 43]
    g = HostGraph.from_edges(np.asarray(src), np.asarray(dst), 64)
    g = dataclasses.replace(g, is_dag=True)
    from graphminer_tpu.ops.stream import build_stream
    lay = build_stream(g, core=4).layout
    assert lay.wt_pad == 40  # off-ladder — the regression trigger
    eng = StreamEngine(g, core=4)
    # directed triangles: only 0→41, 0→42, 41→42 closes
    assert eng.count() == 1


def test_fused_vs_mapped(rand_graphs, citeseer):
    """The fused whole-bucket reduction (no lax.map) must agree bit-exactly
    with the chunked map path on every bucket mix."""
    for g in (rand_graphs[1], rand_graphs[3]):
        a = StreamEngine(g, core=16, classes=CLASSES, wtv_classes=WTV,
                         fused=True).count()
        b = StreamEngine(g, core=16, classes=CLASSES, wtv_classes=WTV,
                         fused=False).count()
        assert a == b
    eng = StreamEngine(citeseer, core=128, classes=CLASSES, wtv_classes=WTV)
    assert eng.count() == 1166
    eng.fused = False
    assert eng.count() == 1166


def test_task_accounting(citeseer):
    eng = StreamEngine(citeseer, core=128, classes=CLASSES, wtv_classes=WTV)
    assert sum(b.n_tasks for b in eng.stream.buckets) == eng.n_edges
    # oriented edge count matches the DAG edge list
    rg = citeseer.relabel_by_degree(descending=False).orientation()
    assert eng.n_edges == rg.n_edges
