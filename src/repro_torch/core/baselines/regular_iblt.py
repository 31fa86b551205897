"""Regular (fixed-size) IBLT [Goodrich & Mitzenmacher 2011; Eppstein+ 2011].

Each item maps to k distinct cells of a fixed table of m cells (double
hashing).  Not rateless: m must be parameterized for the expected difference
size, decoding fails w.h.p. if d > m, and enlarging m rewrites every cell
(paper §3, Fig 3, Theorems A.1/A.2).

Port of ``repro/core/baselines/regular_iblt.py``: numpy, unchanged.
"""
from __future__ import annotations

import numpy as np

from ..encoder import _xor_accumulate
from ..hashing import DEFAULT_KEY, siphash24
from ..symbols import CodedSymbols


class RegularIBLT:
    def __init__(self, m: int, nbytes: int, k: int = 3, key=DEFAULT_KEY):
        self.m = m
        self.k = k
        self.nbytes = nbytes
        self.key = key
        self.table = CodedSymbols.zeros(m, nbytes)

    def _cells(self, words: np.ndarray) -> np.ndarray:
        """(n, k) distinct cell indices via double hashing."""
        h1 = siphash24(words, self.key, self.nbytes)
        h2 = siphash24(words, (self.key[0] ^ 0xA5A5A5A5, self.key[1]),
                       self.nbytes)
        a = (h1 % np.uint64(self.m)).astype(np.int64)
        b = (h2 % np.uint64(max(self.m - 1, 1))).astype(np.int64) + 1
        idx = (a[:, None] + np.arange(self.k)[None, :] * b[:, None]) % self.m
        # double hashing can still collide when gcd(b, m) > 1; nudge dups
        for j in range(1, self.k):
            dup = (idx[:, j:j + 1] == idx[:, :j]).any(axis=1)
            while dup.any():
                idx[dup, j] = (idx[dup, j] + 1) % self.m
                dup = (idx[:, j:j + 1] == idx[:, :j]).any(axis=1)
        return idx

    def insert(self, words: np.ndarray, sign: int = 1) -> None:
        hashes = siphash24(words, self.key, self.nbytes)
        idx = self._cells(words)
        n = words.shape[0]
        rep = np.repeat(np.arange(n), self.k)
        _xor_accumulate(self.table.sums, self.table.checks, self.table.counts,
                        idx.reshape(-1), words[rep], hashes[rep],
                        np.full(n * self.k, sign, np.int64))

    def subtract(self, other: "RegularIBLT") -> CodedSymbols:
        return self.table.subtract(other.table)

    def decode(self, diff: CodedSymbols):
        """Peel; returns (items, sides, success)."""
        sym = diff.copy()
        rec_items, rec_sides = [], []
        for _ in range(10 * self.m):
            h = siphash24(sym.sums, self.key, self.nbytes)
            pure = np.flatnonzero((h == sym.checks) & (np.abs(sym.counts) == 1))
            if pure.size == 0:
                break
            i = pure[0]
            x = sym.sums[i:i + 1].copy()
            side = int(np.sign(sym.counts[i]))
            rec_items.append(x[0])
            rec_sides.append(side)
            hx = siphash24(x, self.key, self.nbytes)
            idx = self._cells(x)[0]
            _xor_accumulate(sym.sums, sym.checks, sym.counts, idx,
                            np.repeat(x, self.k, axis=0),
                            np.repeat(hx, self.k),
                            np.full(self.k, -side, np.int64))
        ok = bool(sym.is_empty().all())
        items = np.stack(rec_items) if rec_items else \
            np.zeros((0, sym.L), np.uint32)
        return items, np.array(rec_sides, np.int8), ok


def reconcile_regular(words_a, words_b, m, nbytes, k=3, key=DEFAULT_KEY):
    A = RegularIBLT(m, nbytes, k, key)
    B = RegularIBLT(m, nbytes, k, key)
    if len(words_a):
        A.insert(words_a)
    if len(words_b):
        B.insert(words_b)
    return A.decode(A.subtract(B))
