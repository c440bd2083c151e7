"""Rectangle (4-cycle) counting — max-anchored truncated-codegree engine.

Parity: src/sgl/cpu_kernels/rectangle.h:1-12 (v0 = the cycle's max vertex,
v2 < v1 its two neighbors, v3 ∈ N(v1) ∩ N(v2) bounded below v0 — each
4-cycle counted exactly once) and the published scale surface
src/sgl/README.md:58 (livej 4-cycles = 51,520,572,777) served by the
rectangle_bj / rectangle_nested_balanced GPU kernels.

Device reformulation — no wedge enumeration. A 4-cycle u-x-v-y has two
diagonal pairs {u, v} and {x, y}; anchor each cycle at the diagonal pair
containing its MAXIMUM vertex v (ids ascend by degree after relabel):

    C4 = Σ_{pairs (u, v), v max} C(|N(u) ∩ N(v) ∩ [0, v)|, 2)

Every cycle is counted exactly once: both cross vertices x, y lie below v,
and at the other diagonal {x, y} the pair {u, v} fails the bound (v is not
below max(x, y)). With the top `core` ids closed under "max of the cycle",
the truncated codegree splits into matmul-shaped pieces:

 * u, v both core:  w = Gs[u, v] + Wb[v, u] where
     Gs = Σ_{x sub} fb(x) fb(x)ᵀ             (sub common nbrs — matmul Gram)
     Wb = (Acc ⊙ 1[x < v])ᵀ Acc              (core commons below v — matmul)
 * u sub, v core:   w[v] = wsub_u[v] + wcb_u[v] where
     wsub_u = Σ_{x ∈ N(u) ∩ sub} fb(x)       (bucketed gather + bit sums)
     wcb_u  = expand(fb(u)) @ (Acc ⊙ 1[x < v])  (batched matmul)
 * v sub (⇒ all four vertices sub): recurse on the sub-induced graph.

fb(x) = bitmap of N(x) ∩ core over FULL adjacency; Acc = core-core
adjacency. Cost is O(V · core²) MACs + O(E_sub · core) bit-sums per level —
no term is wedge-proportional (rmat18 has 4.7e9 wedges; this engine does
~1e13 MACs, all in dense matrix products).

Exactness: all per-entry values are int32 (codegree < 2^16 asserted, so
w(w-1)/2 < 2^31); block sums are split lo/hi-16 int32 partials (block
<= 2^15 entries) and accumulated int64 on the host.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..types import SENTINEL, cdiv, round_up
from .hubcore import _expand_bits
from .ring import _class_of, _cover, _gather_lists
from .tri_support import _pack_full_core_bitmaps

CORE = 4096
GRAM_SLAB = 4096
FT_CLASSES = (8, 32, 128, 512, 2048)
CHUNK_U = 4096          # sub-core rows per case-B dispatch step
BLOCK = 1 << 14         # entries per lo/hi-16 partial sum


def _pairs_lohi(w, block: int):
    """Σ C(w, 2) over all entries → int32 [n_blocks, 2] (lo16, hi16)
    partial sums. w: int32 >= 0, flattened; caller pads to a block
    multiple with zeros."""
    p = (w * (w - 1)) >> 1                      # exact: w < 2^16
    p = p.reshape(-1, block)
    return jnp.stack([jnp.sum(p & 0xFFFF, axis=1, dtype=jnp.int32),
                      jnp.sum(p >> 16, axis=1, dtype=jnp.int32)], axis=1)


def _sum_lohi(parts) -> int:
    a = np.asarray(parts, dtype=np.int64)
    return int(a[:, 0].sum() + (a[:, 1].sum() << 16))


@functools.partial(jax.jit, static_argnames=("words", "slab"))
def _gram_rows(rows, *, words: int, slab: int):
    """G = Σ_r x_r x_rᵀ over bit-expanded rows → int32 [cpad, cpad]."""
    cpad = words * 32
    n = rows.shape[0]
    n_slabs = max(1, cdiv(n, slab))
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


@functools.partial(jax.jit, static_argnames=("words", "c", "block"))
def _case_a(gs, acc_rows, *, words: int, c: int, block: int):
    """Σ_{u<v<c} C(Gs[u,v] + Wb[v,u], 2) → lo/hi-16 block partials.

    acc_rows: [cpad-row-count, words] core adjacency bitmaps (row x = core
    vertex x, bits = its core neighbors). Wb[v,u] = # core x < v adjacent
    to both u and v = Mᵀ @ Acc with M = Acc ⊙ 1[x < v] (static strict
    upper-triangular mask on the (x, v) FACTOR — not per-output)."""
    cpad = words * 32
    x = _expand_bits(acc_rows, cpad)            # [nrow, cpad]
    pad = cpad - x.shape[0]
    if pad > 0:
        x = jnp.concatenate([x, jnp.zeros((pad, cpad), jnp.bfloat16)])
    iota_x = jax.lax.broadcasted_iota(jnp.int32, (cpad, cpad), 0)
    iota_v = jax.lax.broadcasted_iota(jnp.int32, (cpad, cpad), 1)
    m = jnp.where(iota_x < iota_v, x, 0)        # M[x, v] = Acc[x,v]·[x<v]
    wb = jax.lax.dot_general(m, x, (((0,), (0,)), ((), ())),
                             preferred_element_type=jnp.float32
                             ).astype(jnp.int32)          # [v, u]
    w = gs + wb.T                               # [u, v] truncated codegree
    keep = (iota_x < iota_v) & (iota_v < c)     # u < v, both real core ids
    w = jnp.where(keep, w, 0)
    return _pairs_lohi(w.reshape(-1), block)


@functools.partial(jax.jit,
                   static_argnames=("words", "wa", "chunk", "c", "block"))
def _case_b(table, m_masked, u_ids, ft, *, words: int, wa: int, chunk: int,
            c: int, block: int):
    """Sub-core u vs all core v: Σ_u Σ_v C(wsub_u[v] + wcb_u[v], 2).

    table: [V, words] fb bitmaps; m_masked: [cpad, cpad] bf16
    (Acc ⊙ 1[x<v], reused across buckets); u_ids: [n] int32 (SENTINEL
    padded); ft: [n, wa] sub-neighbor lists of u (SENTINEL padded; wa == 0
    → no wsub part). Chunked with lax.map; emits lo/hi-16 partials."""
    cpad = words * 32
    v = table.shape[0]
    n = u_ids.shape[0]
    n_chunks = cdiv(n, chunk)
    npad = n_chunks * chunk
    if npad > n:
        u_ids = jnp.pad(u_ids, (0, npad - n), constant_values=SENTINEL)
        if wa:
            ft = jnp.pad(ft, ((0, npad - n), (0, 0)),
                         constant_values=SENTINEL)
    uu = u_ids.reshape(n_chunks, chunk)
    fts = (ft.reshape(n_chunks, chunk, wa) if wa
           else jnp.zeros((n_chunks, chunk, 0), jnp.int32))

    def body(xs):
        u, f = xs
        ok_u = (u >= 0) & (u < v)
        xrow = table[jnp.where(ok_u, u, 0)]           # [chunk, words]
        xe = _expand_bits(jnp.where(ok_u[:, None], xrow, 0), cpad)
        wcb = jax.lax.dot_general(
            xe, m_masked, (((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32).astype(jnp.int32)
        if wa:
            ok_f = f != SENTINEL
            rows = table[jnp.where(ok_f, f, 0)]       # [chunk, wa, words]
            rows = jnp.where(ok_f[:, :, None], rows, 0)
            # int8 expansion (4x smaller temp than s32; the accumulator is
            # int32 via the reduce dtype) — rmat18 OOM'd on an s32 temp
            bits = _expand_bits(rows.reshape(-1, words), cpad,
                                dtype=jnp.int8)
            wsub = jnp.sum(bits.reshape(chunk, wa, cpad), axis=1,
                           dtype=jnp.int32)
            w = wcb + wsub
        else:
            w = wcb
        iota_v = jax.lax.broadcasted_iota(jnp.int32, (chunk, cpad), 1)
        w = jnp.where(ok_u[:, None] & (iota_v < c), w, 0)
        return _pairs_lohi(w.reshape(-1), block)

    out = jax.lax.map(body, (uu, fts))
    return out.reshape(-1, 2)


def _ft_sub_lists(rg, vids: np.ndarray, width: int, cs: int) -> np.ndarray:
    """[n, width] neighbor-list prefixes restricted to ids < cs (rows are
    sorted ascending; core ids are the suffix, so the prefix of width >=
    sub-degree holds every sub neighbor — larger ids masked)."""
    out = _gather_lists(rg.rowptr, rg.colidx, vids.astype(np.int64), width,
                        max(1, vids.shape[0]))
    return np.where((out != SENTINEL) & (out < cs), out, SENTINEL)


def _c4_dense(g) -> int:
    """Tiny-graph closer: C4 = (1/2) Σ_{u<v} C(codeg(u, v), 2) — each cycle
    counted at both diagonals (dense numpy)."""
    v = g.n_vertices
    a = np.zeros((v, v), dtype=np.int64)
    deg = np.diff(g.rowptr)
    src = np.repeat(np.arange(v), deg)
    a[src, g.colidx] = 1
    w = a @ a
    iu = np.triu_indices(v, 1)
    ww = w[iu]
    return int((ww * (ww - 1) // 2).sum() // 2)


def _c4_wedge_anchor(g) -> int:
    """Bounded-degree closer: the max-anchored wedge pass (gm_c4 native
    OpenMP; chunked-numpy fallback). Exactly the engine's anchoring —
    each cycle once at the diagonal holding its max vertex — executed
    directly when Σ wedges is affordable (the recursion has peeled the
    hubs, so degree is capped by the parent's core threshold)."""
    from .. import native_bridge
    nat = native_bridge.c4_anchor(g.rowptr, g.colidx)
    if nat is not None:
        return nat
    # numpy fallback: enumerate wedges v-u-w with u, w < v; group by
    # (v, w) key and sum C(multiplicity, 2)
    total = 0
    v = g.n_vertices
    rowptr, colidx = g.rowptr, g.colidx
    keys = []
    for vv in range(v):
        nb = colidx[rowptr[vv]:rowptr[vv + 1]]
        nb = nb[nb < vv]
        for u in nb:
            w = colidx[rowptr[u]:rowptr[u + 1]]
            w = w[w < vv]
            if w.size:
                keys.append(int(vv) * v + w.astype(np.int64))
    if keys:
        _, cnts = np.unique(np.concatenate(keys), return_counts=True)
        total += int((cnts * (cnts - 1) // 2).sum())
    return total


#: wedge budget below which the native anchor pass closes the recursion
WEDGE_NATIVE_CUT = 1 << 29


def rectangle_count_fast(g, core: int = CORE, chunk: int = CHUNK_U,
                         _depth: int = 0) -> int:
    """Exact 4-cycle count via the max-anchored hybrid engine.

    Level 0 runs the matmul decomposition (the hub mass); recursion levels
    have degree capped by the parent's core threshold, so once the wedge
    count is bounded the native anchor pass closes exactly (the recursion
    would otherwise peel only `core` ids per level)."""
    assert not g.is_dag, "rectangle needs the full undirected graph"
    if g.n_vertices <= 256:
        return _c4_dense(g)
    if _depth >= 1:
        deg = np.diff(g.rowptr).astype(np.int64)
        if (_depth >= 6
                or int((deg * (deg - 1) // 2).sum()) <= WEDGE_NATIVE_CUT):
            return _c4_wedge_anchor(g)
    rg = g.relabel_by_degree(descending=False)
    v = rg.n_vertices
    deg = np.diff(rg.rowptr).astype(np.int64)
    assert deg.max(initial=0) < (1 << 16), "codegree bound for int32 pairs"
    c = min(core, v)
    cs = v - c
    words = round_up(max(1, cdiv(c, 32)), 8)
    cpad = words * 32

    fb = _pack_full_core_bitmaps(rg, cs, words)        # [V, words] int32
    table = jnp.asarray(fb)
    acc_rows = table[cs:]                              # core rows

    # case A: u, v both core (Gs from sub rows with >= 2 core nbrs —
    # fewer touch only the diagonal, which the u<v mask drops)
    core_nb = np.zeros(v, dtype=np.int64)
    colsrc = np.repeat(np.arange(v, dtype=np.int64), deg)
    incore = rg.colidx.astype(np.int64) >= cs
    np.add.at(core_nb, colsrc[incore], 1)
    keep = np.nonzero((core_nb >= 2) & (np.arange(v) < cs))[0]
    gs = (_gram_rows(table[jnp.asarray(keep)], words=words, slab=GRAM_SLAB)
          if keep.size else jnp.zeros((cpad, cpad), jnp.int32))
    total = _sum_lohi(_case_a(gs, acc_rows, words=words, c=c, block=BLOCK))

    if cs:
        # shared masked core-adjacency factor M = Acc ⊙ 1[x < v]
        @functools.partial(jax.jit, static_argnames=("words",))
        def _mask_acc(rows, *, words):
            x = _expand_bits(rows, words * 32)
            pad = words * 32 - x.shape[0]
            if pad > 0:
                x = jnp.concatenate(
                    [x, jnp.zeros((pad, words * 32), jnp.bfloat16)])
            i = jax.lax.broadcasted_iota(jnp.int32, x.shape, 0)
            j = jax.lax.broadcasted_iota(jnp.int32, x.shape, 1)
            return jnp.where(i < j, x, 0)

        m_masked = _mask_acc(acc_rows, words=words)

        # case B: u sub, v core — bucketed by sub-neighbor width
        sub_ids = np.arange(cs, dtype=np.int64)
        ftw = deg[:cs] - core_nb[:cs]              # sub-neighbor counts
        classes = _cover(FT_CLASSES, int(ftw.max(initial=1)))
        wcl = np.where(ftw == 0, 0, _class_of(np.maximum(ftw, 1), classes))
        parts = []
        for k in sorted(set(wcl.tolist())):
            us = sub_ids[wcl == k]
            npad = round_up(max(us.shape[0], 8), 8)
            uu = np.full(npad, SENTINEL, dtype=np.int32)
            uu[: us.shape[0]] = us
            if k:
                ft = np.full((npad, int(k)), SENTINEL, dtype=np.int32)
                ft[: us.shape[0]] = _ft_sub_lists(rg, us, int(k), cs)
            else:
                ft = np.zeros((npad, 0), dtype=np.int32)
            # bound the expanded wsub temp: ch * wa slots, each cpad int8
            # (ch * wa * cpad bytes <= ~270 MB at cpad 4096)
            ch = max(8, min(chunk, (1 << 16) // max(int(k), 1) // 8 * 8))
            parts.append(_case_b(table, m_masked, jnp.asarray(uu),
                                 jnp.asarray(ft), words=words, wa=int(k),
                                 chunk=ch, c=c, block=BLOCK))
        for p in parts:
            total += _sum_lohi(p)

        # case C: cycles whose max vertex is sub ⇒ all four vertices sub —
        # recurse on the sub-induced graph (ids [0, cs) are a CSR prefix)
        from ..core.graph import HostGraph
        m = (colsrc < cs) & (rg.colidx < cs)
        new_deg = np.zeros(cs, dtype=np.int64)
        np.add.at(new_deg, colsrc[m], 1)
        rowptr = np.concatenate([[0], np.cumsum(new_deg)])
        sub_g = HostGraph(rowptr=rowptr.astype(rg.rowptr.dtype),
                          colidx=rg.colidx[m].copy())
        if sub_g.colidx.size:
            total += rectangle_count_fast(sub_g, core=core, chunk=chunk,
                                          _depth=_depth + 1)
    return total
