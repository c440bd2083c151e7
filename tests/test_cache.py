"""Preprocessing persistence (io/cache.py): round-trip + build-once, and
the persistent compile cache's directory."""
import os

import numpy as np
import pytest

from graphminer_tpu.io.synth import rmat
from graphminer_tpu.io import cache


def test_graph_roundtrip(tmp_path):
    g = rmat(10, 8, seed=1)
    rg = g.relabel_by_degree(descending=False).orientation()
    cache.save_graph("t_rt", rg, cache_dir=str(tmp_path))
    g2 = cache.load_graph("t_rt", cache_dir=str(tmp_path))
    assert g2.is_dag
    assert np.array_equal(g2.rowptr, rg.rowptr)
    assert np.array_equal(g2.colidx, rg.colidx)


def test_cached_graph_builds_once(tmp_path):
    calls = []

    def build():
        calls.append(1)
        return rmat(9, 8, seed=2)

    g1 = cache.cached_graph("t_once", build, cache_dir=str(tmp_path))
    g2 = cache.cached_graph("t_once", build, cache_dir=str(tmp_path))
    assert len(calls) == 1
    assert np.array_equal(g1.colidx, g2.colidx)


def test_miss_returns_none(tmp_path):
    assert cache.load_graph("nope", cache_dir=str(tmp_path)) is None


_CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import jax, jax.numpy as jnp
import graphminer_tpu
print(jax.config.jax_compilation_cache_dir)
jax.jit(lambda x: jnp.sin(x) * 3)(jnp.arange(5.0)).block_until_ready()
"""


@pytest.mark.parametrize("env_set", [True, False],
                         ids=["env-dir", "checkout-default"])
def test_compile_cache_dir(tmp_path, env_set):
    """JAX_COMPILATION_CACHE_DIR, when set, is where executables land;
    otherwise the package points the cache at <checkout>/.jax_cache."""
    import subprocess
    import sys
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="0",
               PYTHONPATH=_CHECKOUT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_set:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / "xla")
    r = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                       cwd=str(tmp_path), capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    got = r.stdout.strip().splitlines()[-1]
    if env_set:
        assert got == str(tmp_path / "xla")
        assert os.listdir(tmp_path / "xla")      # the executable landed
    else:
        assert got == os.path.join(_CHECKOUT, ".jax_cache")
        assert cache.CHECKOUT_JAX_CACHE == got
