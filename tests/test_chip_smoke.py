"""chip_smoke.py refuses to run without a GPU: no result line, non-zero
exit — from the checkout on the CPU backend, and from a directory that
holds the script and nothing else of the repository. Its multi-process
check runs here on CPU ranks."""
import importlib.util
import os
import shutil
import subprocess
import sys

import pytest

_CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SCRIPT = os.path.join(_CHECKOUT, "chip_smoke.py")


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_device_guard(tmp_path, where):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    if where == "checkout":
        script, cwd = _SCRIPT, _CHECKOUT
    else:
        script = str(tmp_path / "chip_smoke.py")
        shutil.copy(_SCRIPT, script)
        cwd = str(tmp_path)
    r = subprocess.run([sys.executable, script], env=env, cwd=cwd,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_multiprocess_check_on_cpu(tmp_path, monkeypatch):
    """The --four multi-process TC (worker arguments, stage lines, the sum
    over ranks) at rmat16 on four CPU processes, against its golden."""
    spec = importlib.util.spec_from_file_location("chip_smoke", _SCRIPT)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    monkeypatch.setattr(cs, "GRAPH_DIR", str(tmp_path))
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    monkeypatch.delenv("XLA_FLAGS", raising=False)
    monkeypatch.setenv("PYTHONPATH", _CHECKOUT)
    rep = cs.Reporter("cpu")
    cs.multiprocess_tc(rep, cs.graph_prefix(16), 16, timeout_s=200)
    assert rep.failed == []
