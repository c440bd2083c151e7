"""Dense-core matmul counting path.

Parity/inspiration: the reference's matrix-multiply-based GPM subsystem
(src/matrix/omp_mm.cpp:104-215): split the graph by degree, count patterns in
the dense high-degree core with GEMM (A@A ⊙ A), handle the sparse tail with
ordinary intersections. Matrix units run 0/1 products far faster than
elementwise compares, and with an
ascending-degree relabel + orientation the core is CLOSED (out-neighbors of
core vertices are core vertices), so core-core edges are counted entirely
inside the dense block with no correction terms.

Exactness: inputs are 0/1 bf16, dot-product length ≤ C < 2^24 → f32
accumulation is exact; per-tile sums are cast to int32/int64 before reduction.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


@functools.partial(jax.jit, static_argnames=("tile",))
def _masked_aat_sum(d: jax.Array, tile: int = 2048) -> jax.Array:
    """Σ_ij (D @ Dᵀ)_ij ⊙ D_ij, blocked over row tiles. d: bf16 [C, C]."""
    c = d.shape[0]
    n_tiles = c // tile

    def body(i, acc):
        rows = jax.lax.dynamic_slice(d, (i * tile, 0), (tile, c))
        prod = jnp.dot(rows, d.T, preferred_element_type=jnp.float32)
        masked = prod * rows  # zero where no edge (i,j)
        return acc + jnp.sum(masked.astype(jnp.int32), dtype=jnp.int64)

    return jax.lax.fori_loop(0, n_tiles, body, jnp.int64(0))


def core_triangles(dag, core_start: int) -> int:
    """Triangles with all three vertices in the core [core_start, V).

    Requires: dag oriented toward higher (degree, id) AFTER an ascending
    degree relabel, so edges point to higher ids and N⁺(core) ⊆ core."""
    v = dag.n_vertices
    c = v - core_start
    # pad C to a power of two for the matmul tiles
    cpad = max(256, 1 << int(np.ceil(np.log2(c))))
    deg = np.diff(dag.rowptr)
    src = np.repeat(np.arange(v, dtype=np.int64), deg)
    dst = dag.colidx
    m = (src >= core_start) & (dst >= core_start)
    si = (src[m] - core_start).astype(np.int32)
    di = (dst[m] - core_start).astype(np.int32)
    # scatter the 0/1 matrix on device: ship E_cc index pairs, not C² bytes
    d_dev = _scatter_dense(jnp.asarray(si), jnp.asarray(di), cpad=cpad)
    tile = min(2048, cpad)
    return int(_masked_aat_sum(d_dev, tile=tile))


@functools.partial(jax.jit, static_argnames=("cpad",))
def _scatter_dense(si, di, *, cpad: int):
    d = jnp.zeros((cpad, cpad), dtype=jnp.bfloat16)
    return d.at[si, di].set(jnp.bfloat16(1))
