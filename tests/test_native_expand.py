"""Native bit-expansion kernels (native/graphcore.cpp gm_expand_emit /
gm_count_multi) — differential vs numpy unpackbits on random bitmaps.
These are the host hot loops of the big-clique engines; the contract is
deterministic task-major, bit-ascending output with whole-task capacity
cuts."""
import numpy as np
import pytest

from graphminer_tpu import native_bridge


@pytest.fixture(autouse=True)
def _native_lib():
    # decided per test, not at import: the first get_lib() may build it
    lib = native_bridge.get_lib()
    if lib is None or not hasattr(lib, "gm_expand_emit"):
        pytest.skip("native lib unavailable")


def _numpy_ref(bases, rows, n_bits):
    n = rows[0].shape[0]
    w = bases[0].shape[1]
    acc = np.full((n, w), 0xFFFFFFFF, dtype=np.uint32)
    for b, r in zip(bases, rows):
        acc &= b.view(np.uint32)[r]
    bits = np.unpackbits(acc.view(np.uint8), axis=1, bitorder="little")
    ti, pos = np.nonzero(bits[:, :n_bits])
    return ti, pos


@pytest.mark.parametrize("seed,n,words,n_bits,n_src", [
    (0, 200, 8, 256, 2),
    (1, 64, 8, 100, 3),     # off-word n_bits tail mask
    (2, 500, 16, 512, 2),
    (3, 10, 8, 1, 2),       # single-bit universe
])
def test_expand_emit_vs_numpy(seed, n, words, n_bits, n_src):
    rng = np.random.default_rng(seed)
    v = 50
    bases = [rng.integers(0, 2**31, (v, words)).astype(np.int32)
             for _ in range(n_src)]
    rows = [rng.integers(0, v, n).astype(np.int32) for _ in range(n_src)]
    attrs = [np.arange(n, dtype=np.int32),
             rng.integers(0, 1000, n).astype(np.int32)]
    ti, pos = _numpy_ref(bases, rows, n_bits)
    out = np.empty((max(len(ti), 1), 3), np.int32)
    n_em, nxt = native_bridge.expand_emit(bases, rows, attrs, words,
                                          n_bits, 0, out.shape[0], out)
    assert nxt == n
    assert n_em == len(ti)
    assert np.array_equal(out[:n_em, 0], attrs[0][ti])
    assert np.array_equal(out[:n_em, 1], attrs[1][ti])
    assert np.array_equal(out[:n_em, 2], pos)
    # counts prepass agrees
    cnt = native_bridge.count_multi(bases, rows, words, n_bits)
    assert cnt.sum() == len(ti)
    assert np.array_equal(cnt, np.bincount(ti, minlength=n))


def test_expand_emit_resumable_capacity():
    """Capacity cuts stop on whole-task boundaries and resume exactly."""
    rng = np.random.default_rng(7)
    v, n, words = 30, 100, 8
    # thinned bitmaps (AND of three randoms, ~32 bits/task) so the awkward
    # capacity below still fits any single task — a cap smaller than one
    # task's bit count is a documented refusal (nxt == start)
    mk = lambda: rng.integers(0, 2**31, (v, words))
    bases = [(mk() & mk() & mk()).astype(np.int32)]
    rows = [rng.integers(0, v, n).astype(np.int32)]
    attrs = [np.arange(n, dtype=np.int32)]
    ti, pos = _numpy_ref(bases, rows, 256)
    got_t, got_p = [], []
    out = np.empty((97, 2), np.int32)   # awkward capacity
    start = 0
    while start < n:
        n_em, nxt = native_bridge.expand_emit(bases, rows, attrs, words,
                                              256, start, 97, out)
        assert nxt > start
        got_t.append(out[:n_em, 0].copy())
        got_p.append(out[:n_em, 1].copy())
        start = nxt
    assert np.array_equal(np.concatenate(got_t), ti)
    assert np.array_equal(np.concatenate(got_p), pos)
