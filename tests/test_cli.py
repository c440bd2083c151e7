"""CLI surface (__main__.py): workload dispatch, flags, profiler output."""
import json

import pytest

from graphminer_tpu.__main__ import main


@pytest.fixture(scope="module")
def rmat_prefix(tmp_path_factory):
    """A seeded RMAT graph saved in the reference format, as chip_smoke.py
    feeds the CLI."""
    from graphminer_tpu.io.loader import save_graph
    from graphminer_tpu.io.synth import rmat
    prefix = str(tmp_path_factory.mktemp("rmat") / "graph")
    save_graph(rmat(9, 16, seed=7), prefix)
    return prefix


def run_cli(capsys, *args):
    assert main(list(args) + ["--json"]) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_cli_tc(capsys, citeseer_path):
    out = run_cli(capsys, "tc", citeseer_path, "--cpu")
    assert out["total"] == 1166


def test_cli_tc_fast_and_profile(capsys, citeseer_path):
    out = run_cli(capsys, "tc", citeseer_path, "--cpu", "--fast",
                  "--profile")
    assert out["total"] == 1166
    assert "profile" in out


def test_cli_clique4_fast(capsys, citeseer_path):
    out = run_cli(capsys, "clique", citeseer_path, "4", "--cpu", "--fast")
    assert out["total"] == 255


def test_cli_sgl_diamond_fast(capsys, citeseer_path):
    out = run_cli(capsys, "sgl", citeseer_path, "diamond", "--cpu", "--fast")
    assert out["total"] == 3730


def test_cli_tc_partitioned(capsys, citeseer_path):
    out = run_cli(capsys, "tc", citeseer_path, "--cpu", "--partition", "2",
                  "--profile")
    assert out["total"] == 1166
    assert out["profile"]["set_intersections_per_s"] > 0


def test_cli_fsm_elabels_conformance(capsys, citeseer_path):
    """The fsm subcommand must load EDGE labels: the frozen citeseer anchor
    (4 frequent @ k<=3 minsup=100, independently numpy-verified) only
    reproduces with (vlabel, elabel, vlabel) pattern keys — the r4 CLI
    dropped use_elabel and computed the collapsed count instead."""
    out = run_cli(capsys, "fsm", citeseer_path, "2", "100", "--cpu")
    assert out["total"] == 4


def test_cli_query_labeled_triangles(capsys, citeseer_path):
    """query subcommand (reference query_omp_base parity). Frozen citeseer
    anchors: labeled triangles (0,0,3) = 11 and (0,0,0) = 116, verified
    against a direct numpy triangle enumeration + label-multiset count."""
    out = run_cli(capsys, "query", citeseer_path, "0,0,3:0-1,0-2,1-2", "--cpu")
    assert out["total"] == 11
    out = run_cli(capsys, "query", citeseer_path, "0,0,0:0-1,0-2,1-2", "--cpu")
    assert out["total"] == 116


def test_cli_unknown_backend_raises(capsys, rmat_prefix):
    with pytest.raises(ValueError):
        run_cli(capsys, "tc", rmat_prefix, "--cpu", "--backend", "pallas")


@pytest.mark.parametrize("args,pattern", [
    (["tc", "--fast"], "triangle"),
    (["tc", "--backend", "bc"], "triangle"),
    (["tc", "--backend", "bs"], "triangle"),
    (["clique", "4", "--fast"], "4clique"),
    (["clique", "5", "--fast"], "5clique"),
    (["sgl", "rectangle", "--fast"], "rectangle"),
    (["sgl", "diamond", "--fast"], "diamond"),
], ids=lambda a: "-".join(a) if isinstance(a, list) else a)
def test_cli_saved_graph_vs_frontier(capsys, rmat_prefix, args, pattern):
    """chip_smoke.py's CLI calls on a saved graph agree with the plan
    interpreter (an independent engine) on the same graph."""
    from graphminer_tpu import load_graph
    from graphminer_tpu.workloads.clique import clique_count
    from graphminer_tpu.workloads.sgl import sgl_count
    g = load_graph(rmat_prefix)
    if pattern.endswith("clique"):
        want = clique_count(g, int(pattern[0]))
    else:
        want = sgl_count(g, pattern)
    out = run_cli(capsys, args[0], rmat_prefix, *args[1:], "--cpu")
    assert out["total"] == want
