"""Frequent subgraph mining (FSM) on vertex-labeled graphs.

Parity: src/fsm/ in the reference — gSpan-style pattern growth with MNI
(minimal image) domain support (omp_base.cc:19-147, domain_support.h:6-74,
canonical.h is_min). Device redesign, per the reference's own GPU structure
(host-driven level loop, device embedding math — gpu_base.cu:321-513):

* the pattern-space search runs on the host as BFS growth with canonical
  dedup (core/pattern_graph.py replaces DFS-code minimality — exact for the
  small patterns FSM explores);
* embedding lists are DEVICE-RESIDENT padded int32 buffers [nv, cap] with a
  host-side live count — the analogue of the reference's bounded emb blocks
  (gpu_base.cu:454-460, emb_block = 640*128). The TRANSPOSED (struct-of-
  arrays) layout is deliberate: cap is the minor dimension, so a tiled
  device layout never pads a trailing nv=2..6 axis to a full tile (the row
  layout multiplied memory by the tile width — an rmat16 run ran out of
  memory at 26 GB for a [51.6M, 1] scatter operand). Extension
  runs as a fori_loop over fixed-size column blocks: gather → mask →
  compact → scatter-append into the child buffer, entirely on device; the
  host never concatenates embeddings (the round-1/2 host-RAM frontier is
  gone);
* MNI support = min over pattern vertices of #distinct image vertices,
  computed with a device sort+distinct over the whole resident buffer.

Counted result = number of frequent patterns with 1..k edges (the
reference's `total`).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core.device_graph import DeviceGraph
from ..core.pattern_graph import PatternGraph
from ..ops import setops
from ..types import SENTINEL

BLOCK = 8192          # frontier rows per extension step
MIN_CAP = 1024        # smallest embedding buffer (power-of-4 ladder)


@dataclasses.dataclass
class DevEmb:
    """Device-resident embedding list: SENTINEL-padded [nv, cap] + count
    (transposed/SoA — see module docstring)."""
    buf: jax.Array
    n: int
    sup: Optional[int] = None       # fused MNI support (None -> compute)

    @property
    def cap(self) -> int:
        return self.buf.shape[1]

    @property
    def nv(self) -> int:
        return self.buf.shape[0]


def _cap_for(n: int) -> int:
    c = MIN_CAP
    while c < n:
        c *= 4
    return c


def device_emb(embs: np.ndarray, cap: Optional[int] = None) -> DevEmb:
    """embs: host [n, nv] rows (natural order) → device [nv, cap] SoA."""
    n = embs.shape[0]
    cap = cap or _cap_for(n)
    out = np.full((embs.shape[1], cap), SENTINEL, dtype=np.int32)
    out[:, :n] = embs.T
    return DevEmb(buf=jnp.asarray(out), n=n)


# --------------------------------------------------------------------------
# device kernels
# --------------------------------------------------------------------------

def _blk_for(width: int, cap_p: int) -> int:
    """Power-of-2 column block size capping the per-step candidate volume
    (blk·width ≤ 2^21) so wide-degree graphs never materialize huge
    intermediates; powers of two always divide the power-of-4 caps."""
    b = min(BLOCK, cap_p, max(8, (1 << 21) // max(width, 1)))
    return 1 << (b.bit_length() - 1)


@functools.partial(jax.jit,
                   static_argnames=("width", "nv", "cap_p", "cap_c",
                                    "use_elab"))
def _forward_extend_dev(dg: DeviceGraph, vlab, buf_p, n_p, at, label,
                        elabel, *, width: int, nv: int, cap_p: int,
                        cap_c: int, use_elab: bool = False):
    """All-block forward extension: attach a `label` neighbor at position
    `at` of every live embedding, via an edge labeled `elabel` when
    use_elab (gSpan forward DFS-code step incl. elabel —
    src/fsm/dfscode.h, omp_base.cc:151-240). Returns (child buffer
    [nv+1, cap_c], child count — may exceed cap_c, signalling overflow;
    extra columns are dropped, caller retries with a bigger cap)."""
    blk_sz = _blk_for(width, cap_p)
    n_blocks = max(1, cap_p // blk_sz)
    init = jnp.full((nv + 1, cap_c), SENTINEL, jnp.int32)

    def step(i, carry):
        buf_c, off = carry
        blk = jax.lax.dynamic_slice(buf_p, (0, i * blk_sz), (nv, blk_sz))
        ridx = i * blk_sz + jax.lax.iota(jnp.int32, blk_sz)
        live = ridx < n_p
        anchors = jnp.where(live, jnp.take(blk, at, axis=0), SENTINEL)
        rows = dg.gather_rows(anchors, width)                 # [blk_sz, W]
        ok = rows != SENTINEL
        lab = vlab[jnp.clip(rows, 0, vlab.shape[0] - 1)]
        ok &= lab == label
        if use_elab:
            ok &= dg.gather_elabel_rows(anchors, width) == elabel
        # vertex-distinct embeddings (subgraph isomorphism)
        ok &= ~jnp.any(rows[None, :, :] == blk[:, :, None], axis=0)
        cand = jnp.where(ok & live[:, None], rows, SENTINEL)
        flat = cand.reshape(-1)                               # [blk_sz * W]
        mask = flat != SENTINEL
        pos = jnp.cumsum(mask) - 1
        m = jnp.sum(mask, dtype=jnp.int32)
        parents = jax.lax.broadcasted_iota(
            jnp.int32, (blk_sz, width), 0).reshape(-1)
        child = jnp.concatenate([blk[:, parents], flat[None, :]], axis=0)
        tgt = jnp.where(mask, off + pos, cap_c)               # drop overflow
        buf_c = buf_c.at[:, tgt].set(child, mode="drop")
        return buf_c, off + m

    buf_c, n_c = jax.lax.fori_loop(0, n_blocks, step, (init, jnp.int32(0)))
    # fused MNI support (valid only when n_c <= cap_c — the caller's
    # overflow retry recomputes): saves one dispatch and host pull per
    # candidate pattern
    return buf_c, n_c, _mni_support_device(buf_c)


@functools.partial(jax.jit,
                   static_argnames=("width", "nv", "cap", "use_elab"))
def _backward_filter_dev(dg: DeviceGraph, buf, n, p, q, elabel, *,
                         width: int, nv: int, cap: int,
                         use_elab: bool = False):
    """Keep embeddings where graph edge (emb[p], emb[q]) exists (with
    label `elabel` when use_elab); compacts
    into a fresh same-capacity buffer. Returns (buffer, count). Blocked
    over columns like the forward pass so the [blk, width] adjacency
    gather stays bounded on wide-degree graphs."""
    blk_sz = _blk_for(width, cap)
    n_blocks = max(1, cap // blk_sz)
    init = jnp.full((nv, cap), SENTINEL, jnp.int32)

    def step(i, carry):
        out, off = carry
        blk = jax.lax.dynamic_slice(buf, (0, i * blk_sz), (nv, blk_sz))
        ridx = i * blk_sz + jax.lax.iota(jnp.int32, blk_sz)
        live = ridx < n
        vp = jnp.take(blk, p, axis=0)
        vq = jnp.take(blk, q, axis=0)
        anchors = jnp.where(live, vp, SENTINEL)
        rows = dg.gather_rows(anchors, width)
        if use_elab:
            el = dg.gather_elabel_rows(anchors, width)
            hit = (rows == vq[:, None]) & (el == elabel)
            ok = jnp.any(hit, axis=1) & live
        else:
            ok = setops.connected(vq, rows) & live
        pos = jnp.cumsum(ok) - 1
        m = jnp.sum(ok, dtype=jnp.int32)
        tgt = jnp.where(ok, off + pos, cap)
        out = out.at[:, tgt].set(blk, mode="drop")
        return out, off + m

    out, n_c = jax.lax.fori_loop(0, n_blocks, step, (init, jnp.int32(0)))
    return out, n_c, _mni_support_device(out)


@jax.jit
def _mni_support_device(buf: jax.Array):
    """Min over pattern vertices of #distinct image vertices (ignoring
    SENTINEL padding) — the MNI domain support (domain_support.h:6-74)
    without materialized per-pattern Bitsets: sort+distinct per row of the
    [nv, cap] SoA buffer on device."""
    s = jnp.sort(buf, axis=1)
    valid = s != SENTINEL
    first = valid & jnp.concatenate(
        [jnp.ones((s.shape[0], 1), bool), s[:, 1:] != s[:, :-1]], axis=1)
    return jnp.min(jnp.sum(first, axis=1))


# --------------------------------------------------------------------------
# host-side search (pattern bookkeeping only — no embedding bytes)
# --------------------------------------------------------------------------

#: anchor-degree width classes for WIDE graphs (see _call_width): the
#: extension gather costs cap x width slots, and on power-law graphs the
#: global max degree is 10-100x the typical anchor's degree — classing
#: recovers that factor. Engages only when max_degree > WIDTH_CLASS_MIN
#: (small graphs keep the single-shape path: each extra class is another
#: compile and each dmax probe is another host pull).
WIDTH_CLASS_MIN = 1024
FSM_WIDTH_CLASSES = (128, 1024)


@jax.jit
def _anchor_maxdeg(degs, buf, at):
    """Max degree over the live anchors of column-resident embeddings
    (dead columns are SENTINEL throughout — init + compaction invariant)."""
    anchors = jnp.take(buf, at, axis=0)
    ok = anchors != SENTINEL
    d = degs[jnp.clip(anchors, 0, degs.shape[0] - 1)]
    return jnp.max(jnp.where(ok, d, 0))


class _FSM:
    def __init__(self, g, minsup: int, max_width: Optional[int] = None):
        assert g.vlabels is not None, "FSM needs vertex labels"
        self.g = g
        self.minsup = minsup
        self.dg = DeviceGraph.from_host(g)
        self.vlab = jnp.asarray(g.vlabels.astype(np.int32))
        self.width = max_width or max(8, g.max_degree)
        self.degs = jnp.asarray(np.diff(g.rowptr).astype(np.int32))
        freq = np.bincount(g.vlabels.astype(np.int64))
        self.freq_labels = set(int(l) for l in np.nonzero(freq >= minsup)[0])
        # edge labels (gSpan DFS codes carry elabels — src/fsm/dfscode.h);
        # unlabeled-edge graphs run with the single pseudo-label 0
        self.use_elab = g.elabels is not None
        # (la, el, lb) la <= lb triples of FREQUENT single-edge patterns,
        # filled by run(); anti-monotone MNI support makes restricting
        # every extension edge to these triples exact (omp_base.cc's
        # frequent-edge pruning)
        self.freq_triples: set = set()

    def _call_width(self, buf, at) -> int:
        """Width class covering this call's anchors (wide graphs only)."""
        if self.width <= WIDTH_CLASS_MIN:
            return self.width
        dmax = int(_anchor_maxdeg(self.degs, buf, jnp.int32(at)))
        for c in FSM_WIDTH_CLASSES:
            if dmax <= c:
                return c
        return self.width

    def _ext_candidates(self, la: int):
        """(elabel, other_vlabel) pairs allowed at a vertex labeled la."""
        out = set()
        for a, el, b in self.freq_triples:
            if a == la:
                out.add((el, b))
            if b == la:
                out.add((el, a))
        return sorted(out)

    def _backward_elabels(self, la: int, lb: int):
        a, b = min(la, lb), max(la, lb)
        return sorted(el for (x, el, y) in self.freq_triples
                      if (x, y) == (a, b))

    def support(self, de: DevEmb) -> int:
        if de.n == 0:
            return 0
        if de.sup is not None:
            return de.sup
        return int(_mni_support_device(de.buf))

    def initial_patterns(self) -> Dict[str, tuple]:
        """Frequent single-edge patterns (vlabel pairs la <= lb, split by
        edge label when the graph carries elabels) + device embeddings;
        mirrors omp_base.cc:35-100 incl. the frequent-vertex filter."""
        g = self.g
        deg = np.diff(g.rowptr)
        src = np.repeat(np.arange(g.n_vertices, dtype=np.int32), deg)
        dst = g.colidx.astype(np.int32)
        vl = g.vlabels.astype(np.int32)
        la, lb = vl[src], vl[dst]
        el = (g.elabels.astype(np.int32) if self.use_elab
              else np.zeros(src.shape[0], dtype=np.int32))
        keep = la <= lb  # both directions kept when la == lb
        out = {}
        trips = {(int(x), int(e), int(y))
                 for x, e, y in zip(la[keep], el[keep], lb[keep])}
        for a, e, b in trips:
            m = keep & (la == a) & (lb == b) & (el == e)
            embs = np.stack([src[m], dst[m]], axis=1).astype(np.int32)
            pat = PatternGraph((a, b), ((0, 1),),
                               (e,) if self.use_elab else ())
            out[pat.canonical_key()] = (pat, device_emb(embs))
        return out

    def forward_extend(self, de: DevEmb, at: int, label: int,
                       elabel: int = 0) -> DevEmb:
        cap_c = _cap_for(max(de.n, 1))
        w = self._call_width(de.buf, at)
        while True:
            buf, n, sup = _forward_extend_dev(
                self.dg, self.vlab, de.buf, jnp.int32(de.n),
                jnp.int32(at), jnp.int32(label), jnp.int32(elabel),
                width=w, nv=de.nv, cap_p=de.cap, cap_c=cap_c,
                use_elab=self.use_elab)
            n = int(n)
            if n <= cap_c:
                return DevEmb(buf=buf, n=n, sup=int(sup))
            from ..utils.profiling import PROFILER
            PROFILER.count("fsm_overflow_retries", 1)
            cap_c = _cap_for(n)       # overflow: retry with room

    def backward_filter(self, de: DevEmb, p: int, q: int,
                        elabel: int = 0) -> DevEmb:
        buf, n, sup = _backward_filter_dev(
            self.dg, de.buf, jnp.int32(de.n), jnp.int32(p), jnp.int32(q),
            jnp.int32(elabel), width=self._call_width(de.buf, p),
            nv=de.nv, cap=de.cap, use_elab=self.use_elab)
        return DevEmb(buf=buf, n=int(n), sup=int(sup))

    def run(self, k_edges: int) -> int:
        frontier = {}
        n_frequent = 0
        for key, (pat, de) in self.initial_patterns().items():
            if (pat.vlabels[0] in self.freq_labels
                    and pat.vlabels[1] in self.freq_labels
                    and self.support(de) >= self.minsup):
                frontier[key] = (pat, de)
                la, lb = pat.vlabels
                el = pat.elabels[0] if pat.elabels else 0
                self.freq_triples.add((min(la, lb), el, max(la, lb)))
        n_frequent += len(frontier)
        seen = set(frontier.keys())

        for level in range(2, k_edges + 1):
            nxt = {}
            for key, (pat, de) in frontier.items():
                nv = pat.n_vertices
                # forward: attach a new labeled vertex at any pattern
                # vertex, by any frequent (elabel, vlabel) edge there
                for at in range(nv):
                    for el, label in self._ext_candidates(pat.vlabels[at]):
                        child = pat.add_forward(
                            at, label, el if self.use_elab else None)
                        ck = child.canonical_key()
                        if ck in seen or ck in nxt:
                            continue
                        ne = self.forward_extend(de, at, label, el)
                        if ne.n and self.support(ne) >= self.minsup:
                            nxt[ck] = (child, ne)
                # backward: close a cycle between non-adjacent vertices
                for p in range(nv):
                    for q in range(p + 1, nv):
                        if pat.has_edge(p, q):
                            continue
                        els = self._backward_elabels(pat.vlabels[p],
                                                     pat.vlabels[q])
                        for el in els:
                            child = pat.add_backward(
                                p, q, el if self.use_elab else None)
                            ck = child.canonical_key()
                            if ck in seen or ck in nxt:
                                continue
                            ne = self.backward_filter(de, p, q, el)
                            if ne.n and self.support(ne) >= self.minsup:
                                nxt[ck] = (child, ne)
            seen |= set(nxt.keys())
            n_frequent += len(nxt)
            frontier = nxt
            if not frontier:
                break
        return n_frequent


def fsm_count(g, k_edges: int, minsup: int) -> int:
    """Number of frequent patterns with 1..k_edges edges (MNI support)."""
    return _FSM(g, minsup).run(k_edges)
