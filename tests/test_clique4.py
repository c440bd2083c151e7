"""4-clique fast engine (ops/clique4.py): Gram ⊙ core-adjacency + tail."""
import numpy as np
import pytest

from graphminer_tpu.io.synth import rmat
from graphminer_tpu.ops.clique4 import clique4_count_fast, Clique4Engine


@pytest.fixture(scope="module")
def citeseer(citeseer_path):
    from graphminer_tpu import load_graph
    return load_graph(citeseer_path)


def test_clique4_citeseer_golden(citeseer):
    # src/motif/README.md:57 (4-clique column): 255
    assert clique4_count_fast(citeseer) == 255


def test_clique4_vs_frontier_small_core():
    """core=128 forces a real tail population through the frontier split."""
    g = rmat(11, 8, seed=17)
    from graphminer_tpu.workloads.clique import clique_count
    want = clique_count(g, 4)
    assert clique4_count_fast(g, core=128) == want
    assert clique4_count_fast(g) == want


def test_clique4_engine_prepared():
    g = rmat(12, 8, seed=23)
    from graphminer_tpu.workloads.clique import clique_count
    want = clique_count(g, 4)
    eng = Clique4Engine(g, core=256)
    assert eng.count() == want
