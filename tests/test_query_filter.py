"""Query candidate filtering (GQL/NLF/k-core; reference src/query/filter.cc)
and the label machinery it builds on (graph.cc:566-729 parity)."""
import numpy as np

from graphminer_tpu import load_graph
from graphminer_tpu.io.synth import labeled_er, erdos_renyi
from graphminer_tpu.workloads.query import (query_count, make_query,
                                            gql_candidates)
import oracle


def test_nlf():
    g = labeled_er(30, 0.2, n_vlabels=3, seed=2)
    nlf = g.build_nlf()
    for v in (0, 7, 29):
        nbr_labels = g.vlabels[g.neighbors(v)]
        for l in range(nlf.shape[1]):
            assert nlf[v, l] == int((nbr_labels == l).sum())


def test_reverse_label_index():
    g = labeled_er(30, 0.2, n_vlabels=3, seed=2)
    rindex = g.reverse_label_index()
    for l, verts in rindex.items():
        assert np.all(g.vlabels[verts] == l)
    assert sum(len(v) for v in rindex.values()) == g.n_vertices


def test_k_core_triangle_plus_tail():
    # path 3-4 hanging off a triangle 0-1-2: core numbers (2,2,2,1,1)
    from graphminer_tpu.core.graph import HostGraph
    src = [0, 1, 0, 2, 1, 2, 2, 3, 3, 4]
    dst = [1, 0, 2, 0, 2, 1, 3, 2, 4, 3]
    g = HostGraph.from_edges(np.array(src), np.array(dst), 5)
    assert g.k_core().tolist() == [2, 2, 2, 1, 1]


def test_filter_is_sound():
    """The filter must never exclude a vertex that participates in a match:
    counts with and without the filter must agree (filter.cc's contract)."""
    g = labeled_er(24, 0.3, n_vlabels=2, seed=7)
    queries = [
        make_query([(0, 1), (1, 2)], [0, 1, 0]),
        make_query([(0, 1), (1, 2), (0, 2)], [1, 1, 0]),
        make_query([(0, 1), (1, 2), (2, 3), (0, 3)], [0, 1, 0, 1]),
    ]
    for q in queries:
        with_f = query_count(g, q, chunk=256, use_filter=True)
        without = query_count(g, q, chunk=256, use_filter=False)
        want = oracle.count_noninduced(g, list(q.edges), q.n_vertices,
                                       vlabels=list(q.vlabels))
        assert with_f == without == want


def test_filter_prunes():
    g = labeled_er(40, 0.25, n_vlabels=3, seed=11)
    q = make_query([(0, 1), (1, 2), (0, 2)], [0, 1, 2])
    cand = gql_candidates(g, q)
    label_only = np.stack([g.vlabels == q.vlabels[i] for i in range(3)])
    assert cand.sum() <= label_only.sum()
    assert np.all(label_only | ~cand)  # cand ⊆ label-matching vertices


def test_citeseer_labeled_query(citeseer_path):
    g = load_graph(citeseer_path, use_vlabel=True)
    assert g.vlabels is not None
    # same-label wedge query, differential vs unfiltered run
    q = make_query([(0, 1), (1, 2)], [2, 2, 2])
    assert query_count(g, q, use_filter=True) == \
        query_count(g, q, use_filter=False)


def test_candidate_indexed_execution():
    """Many labels → candidate sets smaller than adjacency tiles → the plan
    rewrites levels to candidate-set-indexed ('cand' source); counts must be
    unchanged vs unfiltered and vs oracle."""
    from graphminer_tpu.workloads.query import candidate_index_plan, \
        gql_candidates
    from graphminer_tpu.core.plan import plan_from_pattern
    g = labeled_er(60, 0.5, n_vlabels=12, seed=3)
    q = make_query([(0, 1), (1, 2), (2, 3)], [1, 2, 3, 4])
    # the rewrite must actually trigger on this graph
    cand_q = gql_candidates(g, q)
    plan = plan_from_pattern(q, labeled=True, prefer=cand_q.sum(1))
    cand = cand_q[np.asarray(plan.order)]
    plan2, cand_sets = candidate_index_plan(
        plan, {i: np.nonzero(cand[i])[0] for i in range(2, plan.k)},
        max(8, g.max_degree))
    assert cand_sets, "expected at least one candidate-indexed level"
    assert any(lp.source[0] == 'cand' for lp in plan2.levels)
    want = oracle.count_noninduced(g, list(q.edges), q.n_vertices,
                                   vlabels=list(q.vlabels))
    assert query_count(g, q, use_filter=True) == want
    assert query_count(g, q, use_filter=False) == want


def test_candidate_indexed_cycle_query():
    g = labeled_er(56, 0.5, n_vlabels=8, seed=5)
    q = make_query([(0, 1), (1, 2), (2, 3), (0, 3)], [1, 2, 1, 3])
    want = oracle.count_noninduced(g, list(q.edges), q.n_vertices,
                                   vlabels=list(q.vlabels))
    assert query_count(g, q, use_filter=True) == want
