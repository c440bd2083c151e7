"""k-motif conformance: citeseer goldens (src/motif/README.md:52-57) +
brute-force differential on random graphs."""
import pytest

from graphminer_tpu.workloads.motif import motif_count
import oracle

# src/motif/README.md: citeseer 4-motif golden vector
CITESEER_MOTIF4 = {
    "4path": 111153, "3star": 222630, "4cycle": 3094,
    "tailedtriangle": 22900, "diamond": 2200, "4clique": 255,
}


def test_citeseer_motif4_golden(citeseer):
    assert motif_count(citeseer, 4) == CITESEER_MOTIF4


def test_citeseer_motif3(citeseer):
    got = motif_count(citeseer, 3)
    assert got["triangle"] == 1166
    assert got["wedge"] > 0


def test_motif3_vs_oracle(rand_graphs):
    for g in rand_graphs[:2]:
        want = oracle.motif_counts(g, 3)
        assert motif_count(g, 3, chunk=256) == want


def test_motif4_vs_oracle(rand_graphs):
    for g in rand_graphs[:2]:
        want = oracle.motif_counts(g, 4)
        got = motif_count(g, 4, chunk=256)
        assert got == {"4path": want["4path"], "3star": want["3star"],
                       "4cycle": want["rectangle"],
                       "tailedtriangle": want["tailedtriangle"],
                       "diamond": want["diamond"], "4clique": want["4clique"]}


def test_motif6_not_implemented(rand_graphs):
    with pytest.raises(NotImplementedError):
        motif_count(rand_graphs[0], 6)


def test_citeseer_motif4_fast_golden(citeseer):
    # fast=True rides tri_support + cliquek; identical induced vector
    assert motif_count(citeseer, 4, fast=True) == CITESEER_MOTIF4


def test_citeseer_motif3_fast(citeseer):
    assert motif_count(citeseer, 3, fast=True)["triangle"] == 1166
