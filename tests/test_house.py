"""House fast engine (ops/house.py): per-edge tri x sq decomposition vs
brute-force oracle, the frontier engine, and the reference golden
(src/sgl/README.md:53 citeseer = 55,359). Also pins the T3 (3-walk edge
support) machinery against dense numpy A³."""
import numpy as np
import pytest

from graphminer_tpu.io.synth import erdos_renyi, rmat
from graphminer_tpu.ops.house import edge_t3, house_count_fast
import oracle


def _frontier(g):
    from graphminer_tpu.workloads.sgl import sgl_count
    return sgl_count(g, "house")


def _t3_dense(g):
    rg = g.relabel_by_degree(descending=False)
    v = rg.n_vertices
    a = np.zeros((v, v), dtype=np.int64)
    srcs = np.repeat(np.arange(v), np.diff(rg.rowptr))
    a[srcs, rg.colidx] = 1
    return rg, a @ a @ a


@pytest.mark.parametrize("n,p,seed,core", [
    (40, 0.3, 0, 8), (64, 0.2, 1, 16), (80, 0.25, 2, 32), (64, 0.2, 3, 64),
])
def test_t3_vs_dense(n, p, seed, core):
    """T3 per edge == A³ at edge entries, across core splits that force
    real WS dots and sub-sub native/numpy shares."""
    g = erdos_renyi(n, p, seed)
    rg, src, dst, t3 = edge_t3(g, core=core)
    rgd, a3 = _t3_dense(g)
    assert np.array_equal(t3, a3[src, dst])


def test_t3_edge_sum_exact_past_2_24():
    """The per-edge WS dots sum past 2^24 (where f32 stops holding odd
    integers) and must stay exact: all core bits set on both endpoints,
    ws entries near the int16 top, an odd total above 2^24."""
    import jax.numpy as jnp
    from graphminer_tpu.ops.house import _t3_edges
    from graphminer_tpu.types import SENTINEL
    words, chunk = 16, 8
    cpad = words * 32
    table = jnp.full((2, words), -1, jnp.int32)      # every core bit set
    ws = np.full((2, cpad), 32767, np.int16)
    ws[1, 7] = 32766
    acc = jnp.zeros((cpad, cpad), jnp.bfloat16)       # bilinear share 0
    src = np.full(chunk, SENTINEL, np.int32)
    dst = np.full(chunk, SENTINEL, np.int32)
    src[0], dst[0] = 0, 1
    got = np.asarray(_t3_edges(table, jnp.asarray(ws), acc,
                               jnp.asarray(src), jnp.asarray(dst),
                               words=words, chunk=chunk))
    want = int(ws.astype(np.int64).sum())
    assert want > (1 << 24) and want % 2 == 1
    assert int(got[0]) == want
    assert not got[1:].any()


def test_t3ss_native_vs_numpy():
    """The native gm_t3ss pass must match the dense numpy share."""
    from graphminer_tpu import native_bridge
    from graphminer_tpu.ops.house import _t3ss_numpy, _dag_edges
    if native_bridge.get_lib() is None or \
            not hasattr(native_bridge.get_lib(), "gm_t3ss"):
        pytest.skip("native lib unavailable")
    g = rmat(10, 8, seed=5)
    rg = g.relabel_by_degree(descending=False)
    cs = rg.n_vertices - 64
    nat = native_bridge.t3ss(rg.rowptr, rg.colidx, cs)
    deg = np.diff(rg.rowptr)
    srcs = np.repeat(np.arange(rg.n_vertices), deg)
    keep = rg.colidx > srcs
    assert np.array_equal(nat[keep], _t3ss_numpy(rg, cs))


@pytest.mark.parametrize("n,p,seed", [(40, 0.3, 0), (64, 0.2, 1),
                                      (80, 0.15, 2)])
def test_vs_oracle_small(n, p, seed):
    g = erdos_renyi(n, p, seed)
    want = _frontier(g)
    for core in (16, n):
        assert house_count_fast(g, core=core) == want, core


def test_rmat_vs_frontier():
    g = rmat(11, 8, seed=23)
    want = _frontier(g)
    assert want > 0
    assert house_count_fast(g) == want
    assert house_count_fast(g, core=128) == want


def test_citeseer_golden(citeseer):
    # src/sgl/README.md:53 — citeseer houses = 55,359
    assert house_count_fast(citeseer) == 55359


def test_workload_routing(citeseer):
    from graphminer_tpu.workloads.sgl import sgl_count
    assert sgl_count(citeseer, "house", backend="fast") == 55359


@pytest.mark.slow
def test_rmat13_dense_anchor():
    """Scale anchor via the dense identity (per-edge tri/T3 from A²/A³ —
    scripts/verify_dense_r5.py methodology, which independently verified
    the frozen rmat14 golden 294,814,195,705 in round 5). BLAS dtypes:
    f32 codegrees (< 2^24 exact) and f64 3-walks (< 2^53 exact)."""
    g = rmat(13, 16, seed=7)
    rg = g.relabel_by_degree(descending=False)
    v = rg.n_vertices
    a = np.zeros((v, v), dtype=np.float32)
    srcs = np.repeat(np.arange(v), np.diff(rg.rowptr))
    a[srcs, rg.colidx] = 1.0
    w = (a @ a).astype(np.int64)
    a3 = (w.astype(np.float64) @ a.astype(np.float64)).astype(np.int64)
    keep = rg.colidx > srcs
    eu, ev = srcs[keep], rg.colidx[keep]
    tri = w[eu, ev]
    deg = np.diff(rg.rowptr).astype(np.int64)
    sq = a3[eu, ev] - deg[eu] - deg[ev] + 1
    want = int((tri * (sq - 2 * (tri - 1))).sum())
    assert house_count_fast(g) == want
