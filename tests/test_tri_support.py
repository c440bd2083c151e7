"""tri_support / diamond fast path (ops/tri_support.py)."""
import numpy as np
import pytest

from graphminer_tpu.io.synth import rmat
from graphminer_tpu.ops.tri_support import tri_support, diamond_count_fast


@pytest.fixture(scope="module")
def citeseer(citeseer_path):
    from graphminer_tpu import load_graph
    return load_graph(citeseer_path)


def test_diamond_citeseer_golden(citeseer):
    # src/sgl/README.md:53
    assert diamond_count_fast(citeseer) == 3730


def test_tri_support_oracle_small_core():
    """core=64 forces all four task types (cc/sc/ss + bit probes)."""
    g = rmat(10, 8, seed=4)
    ts = tri_support(g, core=64)
    # oracle: per-task |N(u) ∩ N(v)| on the relabeled graph
    rg = g.relabel_by_degree(descending=False)
    adj = [set(rg.neighbors(x).tolist()) for x in range(rg.n_vertices)]
    want = np.array([len(adj[u] & adj[w])
                     for u, w in zip(ts.src, ts.dst)], dtype=np.int64)
    assert np.array_equal(ts.tri, want)


def test_diamond_fast_vs_frontier():
    g = rmat(11, 8, seed=9).sort_neighbors()
    from graphminer_tpu.workloads.sgl import sgl_count
    want = sgl_count(g, "diamond")
    assert diamond_count_fast(g, core=128) == want
    assert diamond_count_fast(g) == want


def test_tri_sum_is_three_triangles():
    g = rmat(11, 8, seed=2)
    ts = tri_support(g)
    from graphminer_tpu.ops.hubcore import triangle_count_fast
    assert int(ts.tri.sum()) == 3 * triangle_count_fast(g)
