"""Device-resident CSR graph (the GraphGPU analogue, reference
include/graph_gpu.h:6-324 — redesigned for XLA).

Two device layouts, chosen by memory budget:

* padded 2D adjacency table [V, Wpad] (SENTINEL-padded, sorted rows) — the
  default. Adjacency access is then a *row gather*, which XLA lowers to
  contiguous copies instead of element gathers from flat CSR.
  Memory = V·Wpad·4 bytes.
* flat CSR (rowptr/colidx) fallback for graphs whose padded table exceeds the
  budget — element-gather path, slower; superseded by degree-bucketed tables
  (parallel/partition.py) for the largest graphs.

Rows are sorted ascending with SENTINEL tails, the invariant every set-algebra
kernel relies on.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..types import SENTINEL, LANE, round_up

# Share of device memory the padded table may take. Above it, keep flat CSR.
TABLE_FRACTION = 3 / 8


@functools.partial(jax.jit, static_argnames=("wpad", "epad", "fill"))
def _build_table(rowptr, colidx, deg, *, wpad: int, epad: int,
                 fill: int = SENTINEL):
    v = deg.shape[0]
    offs = jax.lax.broadcasted_iota(jnp.int32, (v, wpad), 1)
    idx = rowptr[:-1, None] + offs
    valid = offs < deg[:, None]
    rows = colidx[jnp.where(valid, idx, epad - 1)]
    return jnp.where(valid, rows, fill)


def _pad_width(max_degree: int) -> int:
    if max_degree <= 8:
        return 8
    if max_degree <= 64:
        return round_up(max_degree, 8)
    return round_up(max_degree, LANE)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class DeviceGraph:
    rowptr: jax.Array           # int32 [V+1]
    colidx: jax.Array           # int32 [Epad] (SENTINEL padded)
    deg: jax.Array              # int32 [V]
    adj_table: Optional[jax.Array]  # int32 [V, Wpad] or None
    vlabels: Optional[jax.Array]    # int32 [V] or None
    elabels: Optional[jax.Array] = None    # int32 [Epad] flat, -1 padded
    elab_table: Optional[jax.Array] = None  # int32 [V, Wpad] aligned w/ adj
    n_vertices: int = dataclasses.field(metadata=dict(static=True),
                                        default=0)
    n_edges: int = dataclasses.field(metadata=dict(static=True), default=0)
    max_degree: int = dataclasses.field(metadata=dict(static=True),
                                        default=0)

    @staticmethod
    def from_host(g, device=None,
                  use_table: Optional[bool] = None) -> "DeviceGraph":
        """use_table None: build the padded table when it fits
        TABLE_FRACTION of the device's memory (config.device_memory_budget)."""
        assert g.n_edges < 2**31, "device graph must have E < 2^31; partition first"
        rowptr = g.rowptr.astype(np.int32)
        epad = max(round_up(g.n_edges, LANE), LANE)
        colidx = np.full(epad, SENTINEL, dtype=np.int32)
        colidx[: g.n_edges] = g.colidx
        deg = np.diff(g.rowptr).astype(np.int32)

        maxdeg = g.max_degree
        wpad = _pad_width(max(1, maxdeg))
        if use_table is None:
            from ..config import device_memory_budget
            use_table = g.n_vertices * wpad * 4 <= device_memory_budget(
                TABLE_FRACTION, device)

        vlab = None
        if g.vlabels is not None:
            vlab = g.vlabels.astype(np.int32)
        elab = None
        if g.elabels is not None:
            elab = np.full(epad, -1, dtype=np.int32)
            elab[: g.n_edges] = g.elabels

        put = lambda x: jax.device_put(x, device) if x is not None else None
        rowptr_d, colidx_d, deg_d = put(rowptr), put(colidx), put(deg)
        elab_d = put(elab)
        table = etable = None
        if use_table:
            # build the padded table ON DEVICE from the flat CSR (transfers
            # E ints instead of V*Wpad — host↔device bandwidth is precious)
            table = _build_table(rowptr_d, colidx_d, deg_d, wpad=wpad,
                                 epad=colidx.shape[0])
            if elab_d is not None:
                etable = _build_table(rowptr_d, elab_d, deg_d, wpad=wpad,
                                      epad=colidx.shape[0], fill=-1)
        return DeviceGraph(rowptr=rowptr_d, colidx=colidx_d,
                           deg=deg_d, adj_table=table,
                           vlabels=put(vlab), elabels=elab_d,
                           elab_table=etable,
                           n_vertices=g.n_vertices, n_edges=g.n_edges,
                           max_degree=maxdeg)

    def labels_of(self, vs: jax.Array) -> jax.Array:
        """Vertex labels with -1 for invalid/padded ids."""
        assert self.vlabels is not None
        vs_safe = jnp.clip(vs, 0, self.n_vertices - 1)
        valid = (vs >= 0) & (vs < self.n_vertices)
        return jnp.where(valid, self.vlabels[vs_safe], -1)

    def gather_rows(self, vs: jax.Array, width: int) -> jax.Array:
        """Padded adjacency tiles: [B, width] int32, SENTINEL beyond deg(v).

        vs entries that are out of range (e.g. SENTINEL task padding) yield
        all-SENTINEL rows. Rows are sorted ascending (SENTINEL at the end).
        Vertices with deg > width are truncated — callers pick `width` from
        the degree bucket they are processing.
        """
        vs_safe = jnp.clip(vs, 0, self.n_vertices - 1)
        valid_v = (vs >= 0) & (vs < self.n_vertices)
        if self.adj_table is not None:
            wpad = self.adj_table.shape[1]
            rows = self.adj_table[vs_safe]
            rows = jnp.where(valid_v[:, None], rows, SENTINEL)
            if width == wpad:
                return rows
            if width < wpad:
                return rows[:, :width]
            return jnp.pad(rows, ((0, 0), (0, width - wpad)),
                           constant_values=SENTINEL)
        # flat CSR fallback: element gather
        start = self.rowptr[vs_safe]
        d = jnp.where(valid_v, self.deg[vs_safe], 0)
        offs = jax.lax.broadcasted_iota(jnp.int32, (vs.shape[0], width), 1)
        idx = start[:, None] + offs
        valid = offs < d[:, None]
        epad = self.colidx.shape[0]
        rows = self.colidx[jnp.where(valid, idx, epad - 1)]
        return jnp.where(valid, rows, SENTINEL)

    def gather_elabel_rows(self, vs: jax.Array, width: int) -> jax.Array:
        """Edge labels aligned with gather_rows: [B, width] int32 where
        entry j is the label of edge (v, gather_rows(v)[j]); -1 beyond
        deg(v) or for invalid v."""
        assert self.elabels is not None
        vs_safe = jnp.clip(vs, 0, self.n_vertices - 1)
        valid_v = (vs >= 0) & (vs < self.n_vertices)
        if self.elab_table is not None:
            wpad = self.elab_table.shape[1]
            rows = self.elab_table[vs_safe]
            rows = jnp.where(valid_v[:, None], rows, -1)
            if width == wpad:
                return rows
            if width < wpad:
                return rows[:, :width]
            return jnp.pad(rows, ((0, 0), (0, width - wpad)),
                           constant_values=-1)
        start = self.rowptr[vs_safe]
        d = jnp.where(valid_v, self.deg[vs_safe], 0)
        offs = jax.lax.broadcasted_iota(jnp.int32, (vs.shape[0], width), 1)
        idx = start[:, None] + offs
        valid = offs < d[:, None]
        epad = self.elabels.shape[0]
        rows = self.elabels[jnp.where(valid, idx, epad - 1)]
        return jnp.where(valid, rows, -1)

    def degree_of(self, vs: jax.Array) -> jax.Array:
        vs_safe = jnp.clip(vs, 0, self.n_vertices - 1)
        valid = (vs >= 0) & (vs < self.n_vertices)
        return jnp.where(valid, self.deg[vs_safe], 0)
