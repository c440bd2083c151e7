"""Per-edge triangle support tri(e) = |N(u) ∩ N(v)| over FULL adjacency —
the building block of the diamond fast path (Σ_e C(tri_e, 2)), tailed
patterns, and FSM edge support.

Parity targets: src/sgl/cpu_kernels/diamond.h:1-14 (y0y1 = N(v0)∩N(v1), count
ordered pairs within) and the matrix subsystem's diamond MM variant
(src/matrix/clique/omp_diamond_mm.cpp:190-284). Device redesign with
O(V·row + E·list) memory:

Vertices are relabeled ascending by degree; core = top `core` ids. Each
vertex stores FBc[x] = bitmap of N(x) ∩ core (words int32) and
FT[x] = sorted list N(x) \\ core. For a DAG task (u, v), u < v:

    tri(u,v) = popcount(FBc[u] & FBc[v])          # common CORE neighbors
             + (common SUB-CORE neighbors):
               u,v ∈ core       → G[u-cs, v-cs]   # precomputed Gram
               u sub, v ∈ core  → Σ_{w ∈ FT[u]} bit_{v-cs}(FBc[w])
               u,v sub-core     → |FT[u] ∩ FT[v]| # short-list compare

G = Σ_{w sub-core} x_w x_wᵀ over core-indicator bit vectors — ONE matmul Gram
contraction (the generalization of the hubcore spoke GEMM): G[a, b] counts
sub-core vertices adjacent to both core vertices a and b. Entries are exact
(0/1 bf16 operands; per-slab f32 accumulation < 2^24; int32 total).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..types import SENTINEL, cdiv, round_up
from .hubcore import _expand_bits
from .ring import _class_of, _cover, _gather_lists

CORE = 4096
FT_CLASSES = (8, 32, 128, 512, 2048)
GRAM_SLAB = 4096


def _pack_full_core_bitmaps(g, cs: int, words: int) -> np.ndarray:
    """FBc[x] for every vertex: bits of N(x) ∩ [cs, V) (full adjacency)."""
    v = g.n_vertices
    deg = np.diff(g.rowptr).astype(np.int64)
    src = np.repeat(np.arange(v, dtype=np.int64), deg)
    col = g.colidx.astype(np.int64)
    m = col >= cs
    bm = np.zeros((v, words), dtype=np.uint32)
    cc = (col[m] - cs).astype(np.int64)
    np.bitwise_or.at(bm, (src[m], cc >> 5),
                     np.uint32(1) << (cc & 31).astype(np.uint32))
    return bm.view(np.int32)


@functools.partial(jax.jit, static_argnames=("words", "slab"))
def _gram_device(rows, *, words: int, slab: int):
    """G = Σ X_slabᵀ X_slab over bit-expanded rows → int32 [cpad, cpad]."""
    cpad = words * 32
    n = rows.shape[0]
    n_slabs = cdiv(n, slab)
    npad = n_slabs * slab
    rows = jnp.pad(rows, ((0, npad - n), (0, 0))) if npad > n else rows

    def body(i, g):
        x = _expand_bits(
            jax.lax.dynamic_slice(rows, (i * slab, 0), (slab, words)), cpad)
        return g + jax.lax.dot_general(
            x, x, (((0,), (0,)), ((), ())),
            preferred_element_type=jnp.float32).astype(jnp.int32)

    return jax.lax.fori_loop(0, n_slabs, body,
                             jnp.zeros((cpad, cpad), jnp.int32))


@functools.partial(jax.jit, static_argnames=("words", "chunk"))
def _bitmap_tri(table, src, dst, *, words: int, chunk: int):
    """popcount(FBc[u] & FBc[v]) per task (fused row gathers)."""
    v = table.shape[0]

    def body(xs):
        s, d = xs
        ok_s = (s >= 0) & (s < v)
        ok_d = (d >= 0) & (d < v)
        a = jnp.where(ok_s[:, None], table[jnp.where(ok_s, s, 0)], 0)
        b = jnp.where(ok_d[:, None], table[jnp.where(ok_d, d, 0)], 0)
        return jnp.sum(jax.lax.population_count(a & b), axis=1,
                       dtype=jnp.int32)

    from ..utils.exec import pad_to_chunks
    ss, dd = pad_to_chunks((src, dst), chunk)
    out = jax.lax.map(body, (ss, dd))
    return out.reshape(-1)


def _chunk2d(x, chunk: int, fill):
    """Pad axis 0 to a chunk multiple and reshape to [n_chunks, chunk, ...]."""
    n = x.shape[0]
    n_chunks = max(1, cdiv(n, chunk))
    pad = n_chunks * chunk - n
    if pad:
        cfg = [(0, pad)] + [(0, 0)] * (x.ndim - 1)
        x = jnp.pad(x, cfg, constant_values=fill)
    return x.reshape((n_chunks, chunk) + x.shape[1:])


@functools.partial(jax.jit, static_argnames=("wa", "words", "chunk"))
def _subcore_bit_probe(table_flat, ft, vloc, *, wa: int, words: int,
                       chunk: int):
    """Σ_{w ∈ ft_row} bit_{vloc}(FBc[w]) per task.

    ft: [n, wa] sub-core neighbor lists of u (SENTINEL padded);
    vloc: [n] core-local id of v. One int32 word is element-gathered per
    (task, slot) from the flat bitmap table."""
    nwords = table_flat.shape[0]

    def body(xs):
        f, vl = xs
        word_i = vl[:, None] >> 5
        ok = f != SENTINEL
        flat_idx = jnp.where(ok, f * words + word_i, 0)
        w = table_flat[jnp.clip(flat_idx, 0, nwords - 1)]
        bit = (w >> (vl[:, None] & 31)) & 1
        return jnp.sum(jnp.where(ok, bit, 0), axis=1, dtype=jnp.int32)

    ff = _chunk2d(ft, chunk, SENTINEL)
    vv = _chunk2d(vloc, chunk, 0)
    out = jax.lax.map(body, (ff, vv))
    return out.reshape(-1)


@functools.partial(jax.jit, static_argnames=("wa", "wb", "chunk"))
def _list_intersect(a_rows, b_rows, *, wa: int, wb: int, chunk: int):
    """|a ∩ b| per task over SENTINEL-padded sorted lists."""
    aa = _chunk2d(a_rows, chunk, SENTINEL)
    bb = _chunk2d(b_rows, chunk, SENTINEL)

    def body(xs):
        a, b = xs
        m = (a[:, :, None] == b[:, None, :]) & (a != SENTINEL)[:, :, None]
        return jnp.sum(m, axis=(1, 2), dtype=jnp.int32)

    return jax.lax.map(body, (aa, bb)).reshape(-1)


@dataclasses.dataclass
class TriSupport:
    """Per-DAG-edge triangle support over the degree-relabeled graph."""
    src: np.ndarray     # [E] task src (relabeled ids)
    dst: np.ndarray     # [E] task dst
    tri: np.ndarray     # [E] int64 |N(u) ∩ N(v)|
    n_vertices: int


def tri_support(g, core: int = CORE, ft_classes=FT_CLASSES,
                chunk: int = 65536) -> TriSupport:
    """Compute tri(e) for every DAG edge of the undirected graph g."""
    assert not g.is_dag, "tri_support needs the undirected graph"
    rg = g.relabel_by_degree(descending=False)
    v = rg.n_vertices
    c = min(core, v)
    cs = v - c
    words = round_up(max(1, cdiv(c, 32)), 8)

    fbc = _pack_full_core_bitmaps(rg, cs, words)
    table = jnp.asarray(fbc)
    dag = rg.orientation()
    src, dst = dag.edge_list()
    src = src.astype(np.int64)
    dst = dst.astype(np.int64)
    tri = np.zeros(src.shape[0], dtype=np.int64)

    # common CORE neighbors — all task types, fused bitmap popcount
    nb = np.asarray(_bitmap_tri(table, jnp.asarray(src.astype(np.int32)),
                                jnp.asarray(dst.astype(np.int32)),
                                words=words, chunk=chunk))
    tri += nb[: src.shape[0]].astype(np.int64)

    if cs == 0:
        return TriSupport(src=src, dst=dst, tri=tri, n_vertices=v)

    deg = np.diff(rg.rowptr).astype(np.int64)
    # sub-core-neighbor count per vertex = deg - |N(x) ∩ core|
    core_nb = np.zeros(v, dtype=np.int64)
    colsrc = np.repeat(np.arange(v, dtype=np.int64), deg)
    incore = rg.colidx.astype(np.int64) >= cs
    np.add.at(core_nb, colsrc[incore], 1)
    ftw = deg - core_nb

    cc = (src >= cs)
    sc = (~cc) & (dst >= cs)
    ss = (~cc) & (dst < cs)

    # both core → Gram lookup (rows = sub-core w with >= 2 core neighbors;
    # fewer can only hit the diagonal, which no task reads)
    if cc.any():
        keep = np.nonzero((core_nb >= 2) & (np.arange(v) < cs))[0]
        if keep.size:
            gmat = np.asarray(_gram_device(table[jnp.asarray(keep)],
                                           words=words, slab=GRAM_SLAB))
            tri[cc] += gmat[src[cc] - cs, dst[cc] - cs].astype(np.int64)

    # sub-core tails as bucketed lists (FT = the row PREFIX: ids < cs)
    if sc.any() or ss.any():
        classes = _cover(ft_classes, int(ftw[src[sc | ss]].max(initial=1)))
        tf = jnp.asarray(fbc.reshape(-1))
        # u sub, v core: bit probes of v in FBc[w], w ∈ FT[u]
        if sc.any():
            us, vs = src[sc], dst[sc]
            wcl = _class_of(ftw[us], classes)
            for k in sorted(set(wcl.tolist())):
                m = wcl == k
                n_d = int(m.sum())
                ft = _ft_lists(rg, us[m], int(k), cs)
                out = np.asarray(_subcore_bit_probe(
                    tf, jnp.asarray(ft), jnp.asarray(
                        (vs[m] - cs).astype(np.int32)),
                    wa=int(k), words=words, chunk=chunk))
                idx = np.nonzero(sc)[0][m]
                tri[idx] += out[:n_d].astype(np.int64)
        # u,v sub-core: short-list intersection
        if ss.any():
            us, vs = src[ss], dst[ss]
            wa = _class_of(ftw[us], classes)
            wb = _class_of(ftw[vs], classes)
            key = wa.astype(np.int64) * 65536 + wb
            order = np.argsort(key, kind="stable")
            uso, vso, keyo = us[order], vs[order], key[order]
            change = np.nonzero(np.diff(keyo))[0] + 1
            bst = np.concatenate([[0], change])
            ben = np.concatenate([change, [keyo.shape[0]]])
            base = np.nonzero(ss)[0][order]
            for b, e in zip(bst, ben):
                ka, kb = int(keyo[b] // 65536), int(keyo[b] % 65536)
                fa = _ft_lists(rg, uso[b:e], ka, cs)
                fb = _ft_lists(rg, vso[b:e], kb, cs)
                out = np.asarray(_list_intersect(
                    jnp.asarray(fa), jnp.asarray(fb), wa=ka, wb=kb,
                    chunk=min(chunk, max(8, (1 << 22) // (ka * kb)))))
                tri[base[b:e]] += out[: e - b].astype(np.int64)

    return TriSupport(src=src, dst=dst, tri=tri, n_vertices=v)


def _ft_lists(rg, vids: np.ndarray, width: int, cs: int) -> np.ndarray:
    """[n, width] sub-core neighbor lists (the row PREFIX — rows are sorted
    ascending and core ids are the largest, so truncation at width >= ftw
    can only drop core ids, which are masked anyway)."""
    out = _gather_lists(rg.rowptr, rg.colidx, vids.astype(np.int64), width,
                        max(1, vids.shape[0]))
    return np.where((out != SENTINEL) & (out < cs), out, SENTINEL)


def diamond_count_fast(g, core: int = CORE) -> int:
    """Diamonds = Σ_e C(tri_e, 2) over undirected edges — exact.

    Each diamond is counted once at its unique shared edge (the reference's
    per-edge ordered-pair count, diamond.h:7-11, is the same sum)."""
    ts = tri_support(g, core=core)
    n = ts.tri
    return int((n * (n - 1) // 2).sum())
