"""Test configuration: force the local CPU backend with 8 virtual devices.

The platform is pinned through the config knob before any backend is
initialized, so the tests run on the CPU even on a machine with an
accelerator. Sharding tests then see an 8-device CPU mesh.

Tests that need the reference's citeseer input take the `citeseer_path`
fixture (or `citeseer`), which skips with a reason when the input is not
on this machine.
"""
import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

CITESEER = "/root/reference/inputs/citeseer/graph"
MICO = "/root/reference/inputs/mico/graph"


@pytest.fixture(scope="session")
def citeseer_path():
    if not os.path.exists(CITESEER + ".meta.txt"):
        pytest.skip(f"reference input {CITESEER} is not on this machine")
    return CITESEER


@pytest.fixture(scope="session")
def citeseer(citeseer_path):
    from graphminer_tpu import load_graph
    return load_graph(citeseer_path, use_vlabel=True, use_elabel=True)


@pytest.fixture(scope="session")
def rand_graphs():
    """Small random graphs for differential testing against brute force."""
    from graphminer_tpu.core.graph import HostGraph
    rng = np.random.default_rng(0)
    out = []
    for n, p in [(24, 0.25), (40, 0.15), (64, 0.1), (80, 0.3)]:
        m = rng.random((n, n)) < p
        m = np.triu(m, 1)
        src, dst = np.nonzero(m)
        g = HostGraph.from_edges(src, dst, n, symmetrize=True)
        out.append(g)
    return out
