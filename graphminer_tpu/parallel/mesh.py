"""Scale-out: task-sharded pattern counting over a device mesh.

Parity with the reference's three distribution tiers, on a device mesh:
  * multi-GPU single node (graph replicated, COO task list split by
    Scheduler::round_robin, per-device threads + host sum —
    src/clique/multigpu.cu:20-140)            →  1D mesh axis "chip"
  * MPI multi-node (rank = edge range, MPI_Allreduce —
    src/triangle/dist_gpu.cpp:9-34)           →  mesh axis "host"
  * hierarchical rank×GPU (even_task_split,
    gpu_kernel_wrapper.cu:83-110)             →  2D mesh ("host", "chip")

The CSR graph is replicated per device; edge tasks are sharded contiguously
over the flattened mesh axes (the analogue of Scheduler::round_robin chunking,
scheduler.cc:34-85); partial counts are reduced with lax.psum over NVLink
or the network — the device-native MPI_Allreduce. Degree-sorted task binning (least_first
equivalent) comes free when the host graph is relabeled by degree: contiguous
edge ranges then have near-uniform work.
"""
from __future__ import annotations

import functools
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.device_graph import DeviceGraph
from ..core.plan import Plan
from ..engine.frontier import _descend_compact
from ..utils.exec import pad_to_chunks
from ..types import SENTINEL, cdiv


def make_mesh(devices: Optional[Sequence] = None,
              shape: Optional[tuple] = None,
              axis_names: tuple = ("host", "chip")) -> Mesh:
    """Mesh over the available devices. shape=None → 1 host × all chips."""
    devices = list(devices if devices is not None else jax.devices())
    if shape is None:
        shape = (1, len(devices))
    arr = np.array(devices).reshape(shape)
    return Mesh(arr, axis_names=axis_names)


def _shard_tasks(src, dst, deg, n_shards: int, chunk: int,
                 policy: str = "least_first"):
    """Assign task chunks to shards and pad each shard to a uniform
    chunk-multiple length.

    policy="least_first" uses Scheduler-style greedy bin-packing by the
    min(deg(src), deg(dst)) workload estimate (scheduler.cc:133-214);
    "round_robin" is the chunk-cyclic fallback (scheduler.cc:34-85).
    Returns flat host [n_shards * per] arrays — shard w owns rows
    [w*per, (w+1)*per), matching a contiguous P(axes) sharding."""
    from .scheduler import least_first, round_robin
    src = np.asarray(src)
    dst = np.asarray(dst)
    n = src.shape[0]
    if policy == "least_first" and deg is not None and n:
        assign = least_first(n_shards, deg[src], deg[dst], chunk=chunk)
    else:
        assign = round_robin(n_shards, n, chunk=chunk)
    per = max(chunk, cdiv(max((a.shape[0] for a in assign), default=1),
                          chunk) * chunk)
    s_out = np.full((n_shards, per), SENTINEL, np.int32)
    d_out = np.full((n_shards, per), SENTINEL, np.int32)
    for w, idx in enumerate(assign):
        s_out[w, : idx.shape[0]] = src[idx]
        d_out[w, : idx.shape[0]] = dst[idx]
    return s_out.reshape(-1), d_out.reshape(-1)


def shard_balance(g, n_shards: int, chunk: int = 2048,
                  policy: str = "least_first", sym_break: bool = False):
    """Per-shard (task_count, workload_estimate) under `policy` — the
    dryrun's work-balance evidence. Workload estimate per task is
    min(deg(src), deg(dst)), the same proxy the reference scheduler packs
    by (scheduler.cc:14-20, 133-214)."""
    from .scheduler import least_first, round_robin
    src, dst = g.edge_list(sym_break=sym_break)
    deg = np.diff(g.rowptr)
    if policy == "least_first":
        assign = least_first(n_shards, deg[src], deg[dst], chunk=chunk)
    else:
        assign = round_robin(n_shards, src.shape[0], chunk=chunk)
    w = np.minimum(deg[src], deg[dst]).astype(np.int64)
    return [(int(idx.shape[0]), int(w[idx].sum())) for idx in assign]


def count_pattern_sharded(g, plan: Plan, mesh: Optional[Mesh] = None,
                          chunk: int = 2048, sub: Optional[int] = None,
                          backend: str = "auto", width: Optional[int] = None,
                          policy: str = "least_first") -> int:
    """Multi-device exact pattern count: replicated graph, sharded edge tasks,
    psum reduction. Works on any mesh (virtual CPU devices or a pod slice).

    Task→shard assignment goes through parallel/scheduler.py (least_first
    bin-packing by default) so per-shard work is balanced even when the task
    list is not degree-sorted."""
    if plan.use_dag and not g.is_dag:
        g = g.orientation()
    if mesh is None:
        mesh = make_mesh()
    axes = tuple(mesh.axis_names)
    # the graph is replicated and each device receives only its own tasks
    dg = jax.device_put(DeviceGraph.from_host(g), NamedSharding(mesh, P()))
    src, dst = g.edge_list(sym_break=plan.edge_sym_break)
    width = width or max(8, g.max_degree)
    sub_ = sub or chunk
    n_shards = mesh.devices.size
    deg = np.diff(g.rowptr)
    src, dst = (jax.device_put(x, NamedSharding(mesh, P(axes)))
                for x in _shard_tasks(src, dst, deg, n_shards, chunk,
                                      policy=policy))

    @jax.jit
    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(), P(axes), P(axes)),
        out_specs=P())
    def run(dg_repl, s, d):
        srcs, dsts = pad_to_chunks((s, d), chunk)

        def body(xs):
            emb = jnp.stack([xs[0], xs[1]], axis=1)
            return _descend_compact(dg_repl, plan, 2, emb, {}, width, sub_,
                                    backend)

        local = jnp.sum(jax.lax.map(body, (srcs, dsts)))
        for ax in axes:
            local = jax.lax.psum(local, ax)
        return local

    return int(run(dg, src, dst)) // plan.multiplicity
