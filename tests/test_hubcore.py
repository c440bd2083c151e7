"""Hub-bitmap + closed-core matmul engine (ops/hubcore.py) conformance.

Golden counts: src/triangle/README.md:53 (citeseer = 1,166); synthetic
graphs are cross-checked against the independent bucketed-intersect path
(workloads/triangle.py) — the reference's own validation style of agreeing
independent backends (SURVEY §4.5).
"""
import numpy as np
import pytest

from graphminer_tpu import load_graph
from graphminer_tpu.io.synth import rmat, erdos_renyi
from graphminer_tpu.ops import hubcore
from graphminer_tpu.workloads.triangle import triangle_count

def test_citeseer_golden(citeseer_path):
    g = load_graph(citeseer_path)
    assert hubcore.triangle_count_fast(g) == 1166


@pytest.mark.parametrize("core", [64, 512, 100000])
def test_citeseer_core_sizes(citeseer_path, core):
    g = load_graph(citeseer_path)
    assert hubcore.triangle_count_fast(g, core=core) == 1166


@pytest.mark.parametrize("seed", [0, 3])
def test_rmat_cross_backend(seed):
    g = rmat(12, 8, seed=seed)
    ref = triangle_count(g)
    assert hubcore.triangle_count_fast(g) == ref


def test_er_cross_backend():
    g = erdos_renyi(2000, 0.01, seed=1)
    ref = triangle_count(g)
    assert hubcore.triangle_count_fast(g, core=256) == ref


def test_engine_split_agrees():
    g = rmat(12, 8, seed=5)
    eng = hubcore.TriangleEngine(g, core=1024)
    assert eng.count() == eng.count_tail() + eng.count_core()


def test_layout_invariants():
    g = rmat(10, 8, seed=2).relabel_by_degree(descending=False).orientation()
    lay = hubcore.build_hub_layout(g, core=256)
    v = g.n_vertices
    cs = lay.core_start
    # core vertices have empty tails (closure under out-neighbors)
    assert np.all(lay.t_width[cs:] == 0)
    # popcount of each row's bitmap + t_width == out-degree
    tbl = np.asarray(lay.table)
    bits = np.unpackbits(tbl[:, :lay.words].view(np.uint8), axis=1)
    deg = np.diff(g.rowptr)
    assert np.array_equal(bits.sum(axis=1) + lay.t_width, deg)


def test_small_chunk_padding():
    # groups smaller than a chunk must still count exactly
    g = erdos_renyi(300, 0.05, seed=7)
    ref = triangle_count(g)
    assert hubcore.triangle_count_fast(g, core=64, chunk=128) == ref
