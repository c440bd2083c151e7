"""Chunked task-list execution.

The reference streams work as warp-strided loops over a COO edge list
(e.g. clique4_warp_edge.cuh:14). The device analogue: pad the task list to a
multiple of a static chunk size and `lax.map` a jitted chunk-kernel over the
fixed-shape chunks — memory use is bounded by one chunk regardless of E, and
XLA compiles the body once. Chunks are the natural unit for restart and for
sharding across mesh axes (parallel/mesh.py).
"""
from __future__ import annotations

from typing import Callable, Sequence

import jax
import jax.numpy as jnp

from ..types import SENTINEL, cdiv


def pad_to_chunks(arrays: Sequence[jax.Array], chunk: int, fill=SENTINEL):
    """Pad 1-D task arrays to a chunk multiple and reshape to [n_chunks, chunk]."""
    n = arrays[0].shape[0]
    n_chunks = max(1, cdiv(n, chunk))
    pad = n_chunks * chunk - n
    out = []
    for x in arrays:
        x = jnp.asarray(x)
        if pad:
            x = jnp.pad(x, (0, pad), constant_values=fill)
        out.append(x.reshape(n_chunks, chunk))
    return tuple(out)


def map_chunked(fn: Callable, arrays: Sequence[jax.Array], chunk: int):
    """Apply fn over task chunks and concatenate per-task results.

    fn maps chunk-shaped arrays -> per-task values [chunk] (or [chunk, ...]).
    Returns the stacked result with padding rows still present; callers slice
    [:n_tasks]."""
    chunks = pad_to_chunks(arrays, chunk)
    out = jax.lax.map(lambda xs: fn(*xs), chunks)
    return out.reshape((-1,) + out.shape[2:])


def sum_chunked(count_fn: Callable, arrays: Sequence[jax.Array], chunk: int,
                n_counters: int = 0) -> jax.Array:
    """Σ over tasks of count_fn(*task_chunk).

    count_fn maps chunk-shaped task arrays -> per-task int32 counts [chunk]
    (or [chunk, n_counters] when n_counters > 0). Padded tasks carry SENTINEL
    and must contribute 0. Returns int64 scalar (or [n_counters])."""
    chunks = pad_to_chunks(arrays, chunk)

    def body(xs):
        c = count_fn(*xs)
        return jnp.sum(c.astype(jnp.int64), axis=0)

    partials = jax.lax.map(body, chunks)
    return jnp.sum(partials, axis=0)
