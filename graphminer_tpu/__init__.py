"""graphminer_tpu — a graph pattern mining framework on JAX/XLA.

A from-scratch JAX/XLA redesign with the capability set of
chenxuhao/GraphMiner (G²Miner/Pangolin/Sandslash): triangle counting,
k-clique listing, subgraph listing, k-motif counting, frequent subgraph
mining — exact counts, scaled over device meshes with shard_map + psum.
"""
import jax as _jax

# Exact pattern counts routinely exceed 2^31 (e.g. 5-cliques on LiveJournal =
# 467,429,836,174). All device-side math is explicit int32; x64 is enabled so
# the *final* chunk-sum reductions can run in int64, which mirrors the
# reference's AccType=uint64 accumulators (include/common.h:40).
_jax.config.update("jax_enable_x64", True)

from .io.cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

from .core.graph import HostGraph  # noqa: E402,F401
from .core.device_graph import DeviceGraph  # noqa: E402,F401
from .io.loader import load_graph, save_graph  # noqa: E402,F401

__version__ = "0.1.0"
