"""CliqueKEngine (ops/cliquek.py): hi/lo matmul k-clique vs frontier oracles
and the citeseer golden (src/clique/README.md:53-55)."""
import numpy as np
import pytest

from graphminer_tpu.io.synth import rmat
from graphminer_tpu.ops.cliquek import CliqueKEngine, cliquek_count_fast


@pytest.fixture(scope="module")
def citeseer(citeseer_path):
    from graphminer_tpu import load_graph
    return load_graph(citeseer_path)


def _frontier(g, k):
    from graphminer_tpu.core.plan import clique_plan
    from graphminer_tpu.engine.frontier import count_pattern
    rg = g.relabel_by_degree(descending=False).orientation()
    return count_pattern(rg, clique_plan(k))


def test_clique4_citeseer_golden(citeseer):
    # src/clique/README.md:53 — citeseer 4-cliques = 255
    assert cliquek_count_fast(citeseer, 4) == 255


def test_clique5_citeseer_vs_frontier(citeseer):
    want = _frontier(citeseer, 5)
    assert cliquek_count_fast(citeseer, 5) == want


def test_clique4_rmat_small_core():
    # tiny core + tiny hi forces a real lo population and a real tail
    g = rmat(12, 8, seed=23)
    want = _frontier(g, 4)
    assert cliquek_count_fast(g, 4, core=256, hi=64) == want


def test_clique5_rmat_small_core():
    g = rmat(11, 8, seed=29)
    want = _frontier(g, 5)
    assert cliquek_count_fast(g, 5, core=256, hi=64) == want


def test_clique4_matches_clique4_engine():
    from graphminer_tpu.ops.clique4 import clique4_count_fast
    g = rmat(12, 16, seed=31)
    assert cliquek_count_fast(g, 4) == clique4_count_fast(g)


def test_engine_split_accounting():
    g = rmat(12, 8, seed=23)
    eng = CliqueKEngine(g, 5, core=256, hi=64)
    assert eng.n_tri >= 0 and eng.n_core_edges <= eng.n_edges
    assert eng.count() == _frontier(g, 5)
