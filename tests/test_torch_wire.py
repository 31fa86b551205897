"""The PyTorch port's legacy stream codec, per-symbol loop codecs and
single-chain mapping helpers ≡ the JAX package.

All of it is plain numpy in both packages, so the tolerance is byte and
bit identity.  Inputs come from a seeded numpy generator and reach both
packages as the same arrays.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import encode as ref_encode  # noqa: E402
from repro.core import mapping as ref_mapping  # noqa: E402
from repro.core import wire as ref_wire  # noqa: E402

from repro_torch.core import CodedSymbols, mapping, wire  # noqa: E402


def rand_items(rng, n, nbytes):
    return rng.integers(0, 256, size=(n, nbytes), dtype=np.uint8)


def port_sym(sym):
    return CodedSymbols(sym.sums.copy(), sym.checks.copy(),
                        sym.counts.copy(), sym.nbytes)


def assert_symbols_equal(a, b):
    for f in ("sums", "checks", "counts"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def test_frame_loop_and_vectorized_are_byte_identical():
    """Twin of the reference's test of the same name, both packages: the
    loop codecs write and read the vectorized codec's bytes (ℓ = 13, the
    word-padding case), and those bytes are the reference's."""
    sym = ref_encode(rand_items(np.random.default_rng(11), 300, 13), 13, 200)
    win = port_sym(sym.window(32, 200))
    blob = wire.encode_frames(win, 32, 300)
    assert blob == wire.encode_frames_loop(win, 32, 300) == \
        ref_wire.encode_frames_loop(sym.window(32, 200), 32, 300)
    a, na, sa = wire.decode_frames(blob)
    b, nb, sb = wire.decode_frames_loop(blob)
    c, nc, sc = ref_wire.decode_frames_loop(blob)
    assert (na, sa) == (nb, sb) == (nc, sc) == (300, 32)
    assert_symbols_equal(a, b)
    assert_symbols_equal(b, c)


def test_decode_stream_nonzero_start():
    """Twin of the reference's test: the legacy stream's expected-count
    baseline follows the window offset; the bytes are the reference's."""
    n = 5000
    sym = ref_encode(rand_items(np.random.default_rng(12), n, 24), 24, 512)
    for lo in (1, 33, 400):
        win = sym.window(lo, 512)
        blob = wire.encode_stream(port_sym(win), start=lo, n_items=n)
        assert blob == ref_wire.encode_stream(win, start=lo, n_items=n)
        back, got_n = wire.decode_stream(blob, start=lo)
        assert got_n == n
        assert_symbols_equal(back, win)
        wrong, _ = wire.decode_stream(blob, start=0)
        assert not np.array_equal(wrong.counts, sym.counts[lo:])


def test_empty_window_stream_roundtrip():
    """The stream case of the reference's empty-window test."""
    empty = CodedSymbols.zeros(0, 16)
    blob = wire.encode_stream(empty)
    assert blob == ref_wire.encode_stream(ref_wire.CodedSymbols.zeros(0, 16))
    back, n = wire.decode_stream(blob)
    assert (back.m, n) == (0, 0)


@pytest.mark.parametrize("seed", [1, 7, 2024])
def test_mapping_helpers_match_reference(seed):
    """``item_indices_np`` (one exact chain) and ``advance_np`` (the
    encoder's batched chain walk) against the reference's on the same
    seeds; each chain also equals its row of ``indices_matrix_np``."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 2**32, size=(40, 3), dtype=np.uint32)
    seeds = mapping.map_seeds(words, (seed, 99), 12)
    np.testing.assert_array_equal(
        seeds, ref_mapping.map_seeds(words, (seed, 99), 12))
    m = 3000
    mat = mapping.indices_matrix_np(seeds, m)
    for s, row in zip(seeds[:10], mat):
        got = mapping.item_indices_np(int(s), m)
        np.testing.assert_array_equal(got,
                                      ref_mapping.item_indices_np(int(s), m))
        np.testing.assert_array_equal(got, row[row < m])
    runs = []
    for fn in (mapping.advance_np, ref_mapping.advance_np):
        idx = np.zeros(seeds.shape[0], np.int64)
        state = seeds.copy()
        runs.append([(a.copy(), i.copy()) for a, i in fn(idx, state, m)] +
                    [(idx, state)])
    assert len(runs[0]) == len(runs[1])
    for (a0, i0), (a1, i1) in zip(*runs):
        np.testing.assert_array_equal(a0, a1)
        np.testing.assert_array_equal(i0, i1)
