"""House counting — per-edge triangle x square-side decomposition.

Parity: src/count/cpu_kernels/house.h:1-28 (per chord edge e:
tri_e * cycle_e - overlap) and the SgL house kernels it matches
(src/sgl/cpu_kernels/house.h, house_edge_warp_nested.cuh; citeseer golden
55,359, src/sgl/README.md:53). Summing the reference's per-edge overlap
over all edges collapses to a pure tri_e expression, giving

    house = Σ_e tri_e · (sq_e − 2·(tri_e − 1)),
    sq_e  = T3_e − deg(u) − deg(v) + 1,

where tri_e = |N(u) ∩ N(v)| (triangle support — ops/tri_support.py) and
T3_e = Σ_{x∈N(u), y∈N(v)} A[x, y] = (A³)_uv, the 3-walk support.

Device decomposition of T3 by the classes of the mid-edge (x, y) over the
degree-ascending relabel with core = top `core` ids:

 * x, y both core:  fb(u)ᵀ · Acc · fb(v)     — per-edge matmul bilinear
 * x core, y sub:   ⟨fb(u), WS[v]⟩            — WS[v][c] = #{y ∈ N(v)∩sub:
 * x sub, y core:   ⟨fb(v), WS[u]⟩              c ∈ N(y)} (precomputed
                                                [V, core] int16 table)
 * x, y both sub:   native OpenMP pass (gm_t3ss) — bounded by the
                    sub-core degree cap, O(Σ_{x sub} deg·ssdeg) build +
                    L2-resident lookups (the wedge-explosion hub terms
                    all live in the core classes above, as matmuls).

The per-edge combine runs in int64 numpy on the host (T3 < 2^31 asserted
via the codegree bound). The bilinear is an f32-exact integer (its bound,
≤ 2^24, is asserted on the host); the WS dots are summed in int32.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..types import SENTINEL, cdiv, round_up
from .hubcore import _expand_bits
from .ring import _class_of, _cover
from .rectangle import _ft_sub_lists
from .tri_support import _pack_full_core_bitmaps, tri_support

CORE = 4096
FT_CLASSES = (8, 32, 128, 512, 2048)
EDGE_CHUNK = 4096


@functools.partial(jax.jit, static_argnames=("words", "wa", "chunk"))
def _ws_bucket(table, ft, *, words: int, wa: int, chunk: int):
    """[n, wa] sub-neighbor lists → [n, cpad] int16 bit-sum rows."""
    cpad = words * 32

    def body(f):
        ok = f != SENTINEL
        rows = jnp.where(ok[:, :, None], table[jnp.where(ok, f, 0)], 0)
        bits = _expand_bits(rows.reshape(-1, words), cpad, dtype=jnp.int8)
        return jnp.sum(bits.reshape(f.shape[0], wa, cpad), axis=1,
                       dtype=jnp.int32).astype(jnp.int16)

    return jax.lax.map(body, ft.reshape(-1, chunk, wa)).reshape(-1, cpad)


@functools.partial(jax.jit, static_argnames=("words", "chunk"))
def _t3_edges(table, ws_tab, acc_exp, src, dst, *, words: int, chunk: int):
    """Per-edge core-mid T3 share: bilinear + WS dots → int32 [n].

    The bilinear fb(u)ᵀ·Acc·fb(v) has 0/1 bf16 operands and f32
    accumulation: each inner entry is <= core and the per-edge total is
    <= cn(u)·cn(v) (core-neighbour counts), so it is an f32-exact integer
    while that product is <= 2^24, which the caller asserts. The WS dots
    (up to 2·core·max_ftw ~ 2^28) are masked int16 entries summed in
    int32, exact in any summation order."""
    cpad = words * 32
    v = table.shape[0]
    ss = src.reshape(-1, chunk)
    dd = dst.reshape(-1, chunk)

    def body(xs):
        s, d = xs
        ok = (s >= 0) & (s < v) & (d >= 0) & (d < v)
        su = jnp.where(ok, s, 0)
        dv = jnp.where(ok, d, 0)
        xu = _expand_bits(jnp.where(ok[:, None], table[su], 0), cpad)
        xv = _expand_bits(jnp.where(ok[:, None], table[dv], 0), cpad)
        t = jax.lax.dot_general(xu, acc_exp, (((1,), (0,)), ((), ())),
                                preferred_element_type=jnp.float32)
        bil = jnp.sum(t * xv.astype(jnp.float32), axis=1)
        wsv = jnp.where(xu > 0, ws_tab[dv].astype(jnp.int32), 0)
        wsu = jnp.where(xv > 0, ws_tab[su].astype(jnp.int32), 0)
        dots = jnp.sum(wsv + wsu, axis=1, dtype=jnp.int32)
        return bil.astype(jnp.int32) + dots

    return jax.lax.map(body, (ss, dd)).reshape(-1)


def _t3ss_numpy(rg, cs: int) -> np.ndarray:
    """Dense numpy fallback for the sub-sub-mid share (small graphs /
    no native lib): T3ss = A[:, sub] @ A_ss @ A[sub, :] at edge entries."""
    v = rg.n_vertices
    a = np.zeros((v, v), dtype=np.int64)
    deg = np.diff(rg.rowptr)
    srcs = np.repeat(np.arange(v), deg)
    a[srcs, rg.colidx] = 1
    m = a[:, :cs] @ a[:cs, :cs] @ a[:cs, :]
    src, dst = _dag_edges(rg)
    return m[src, dst].astype(np.int32)


def _dag_edges(rg):
    """Undirected edges as (src < dst) pairs in CSR order (ids ascend by
    degree, so orientation == id order — graph.cc:246-247 semantics)."""
    deg = np.diff(rg.rowptr)
    src = np.repeat(np.arange(rg.n_vertices, dtype=np.int64), deg)
    keep = rg.colidx > src
    return src[keep], rg.colidx[keep].astype(np.int64)


def edge_t3(g, core: int = CORE, chunk: int = EDGE_CHUNK):
    """(src, dst, T3) per undirected edge of g over the degree-ascending
    relabel — T3_e = # ordered pairs (x ∈ N(u), y ∈ N(v)) with x ~ y."""
    assert not g.is_dag
    rg = g.relabel_by_degree(descending=False)
    v = rg.n_vertices
    deg = np.diff(rg.rowptr).astype(np.int64)
    assert deg.max(initial=0) < (1 << 15), "ftw must fit int16 WS entries"
    c = min(core, v)
    cs = v - c
    words = round_up(max(1, cdiv(c, 32)), 8)
    cpad = words * 32

    fb = _pack_full_core_bitmaps(rg, cs, words)
    table = jnp.asarray(fb)
    acc = _expand_bits(table[cs:], cpad)
    pad = cpad - (v - cs)
    if pad > 0:
        acc = jnp.concatenate([acc, jnp.zeros((pad, cpad), jnp.bfloat16)])

    # WS table: per-vertex sub-neighbor bit sums, bucketed by ftw class
    core_nb = np.zeros(v, dtype=np.int64)
    colsrc = np.repeat(np.arange(v, dtype=np.int64), deg)
    np.add.at(core_nb, colsrc[rg.colidx.astype(np.int64) >= cs], 1)
    ftw = deg - core_nb
    ws_tab = jnp.zeros((v, cpad), jnp.int16)
    if cs and ftw.max(initial=0) > 0:
        classes = _cover(FT_CLASSES, int(ftw.max()))
        wcl = np.where(ftw == 0, 0, _class_of(np.maximum(ftw, 1), classes))
        for k in sorted(set(wcl.tolist())):
            if k == 0:
                continue
            ids = np.nonzero(wcl == k)[0]
            ch = max(8, min(chunk, (1 << 16) // int(k) // 8 * 8))
            npad = round_up(max(ids.shape[0], ch), ch)
            ft = np.full((npad, int(k)), SENTINEL, dtype=np.int32)
            ft[: ids.shape[0]] = _ft_sub_lists(rg, ids, int(k), cs)
            rows = _ws_bucket(table, jnp.asarray(ft), words=words,
                              wa=int(k), chunk=ch)
            ws_tab = ws_tab.at[jnp.asarray(ids)].set(
                rows[: ids.shape[0]])

    src, dst = _dag_edges(rg)
    # f32 exactness of the per-edge bilinear (see _t3_edges)
    assert int((core_nb[src] * core_nb[dst]).max(initial=0)) <= (1 << 24), \
        "core too large for the f32-exact bilinear"
    n = src.shape[0]
    npad = round_up(max(n, chunk), chunk)
    sp = np.full(npad, SENTINEL, dtype=np.int32)
    dp = np.full(npad, SENTINEL, dtype=np.int32)
    sp[:n] = src
    dp[:n] = dst
    t3 = np.asarray(_t3_edges(table, ws_tab, acc, jnp.asarray(sp),
                              jnp.asarray(dp), words=words,
                              chunk=chunk))[:n].astype(np.int64)

    if cs:
        from .. import native_bridge
        nat = native_bridge.t3ss(rg.rowptr, rg.colidx, cs)
        if nat is not None:
            keep = rg.colidx > colsrc
            t3 = t3 + nat[keep].astype(np.int64)
        else:
            t3 = t3 + _t3ss_numpy(rg, cs).astype(np.int64)
    return rg, src, dst, t3


def house_count_fast(g, core: int = CORE) -> int:
    """Exact house count via Σ_e tri_e · (sq_e − 2·(tri_e − 1))."""
    rg, src, dst, t3 = edge_t3(g, core=core)
    deg = np.diff(rg.rowptr).astype(np.int64)
    sq = t3 - deg[src] - deg[dst] + 1
    ts = tri_support(g, core=core)
    # both edge lists are the DAG edges of the same deterministic relabel,
    # in CSR order — assert alignment before combining
    assert ts.src.shape == src.shape
    assert np.array_equal(ts.src, src) and np.array_equal(ts.dst, dst)
    tri = ts.tri.astype(np.int64)
    assert (sq >= 0).all() and (tri >= 0).all()
    return int((tri * (sq - 2 * (tri - 1))).sum())
