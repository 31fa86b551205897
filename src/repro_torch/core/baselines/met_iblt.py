"""MET-IBLT (multi-edge-type IBLT) — rate-compatible IBLT [Lázaro & Matuz
2023].  Our reimplementation (no open-source original, as the paper notes in
§7.2).

Cells are split into classes; items map to each class with a class-specific
degree.  The cell layout is *nested*: the table for difference budget
d_{i+1} extends the table for d_i, so a prefix is usable for smaller d —
rate-compatible at the *pre-selected* d values only (the paper's §2
criticism: off the grid of optimized d's, its overhead degrades 4–10×,
and there is no practical incremental encoder).

We use the degree/ratio structure from [15, §V-A]: three edge types with
cell-class ratios ~[0.4, 0.4, 0.2] and per-class item degrees [1, 2, 1] at
each rate step; steps double the table: m_i = m_0·2^i.

Port of ``repro/core/baselines/met_iblt.py``: numpy, unchanged.
"""
from __future__ import annotations

import numpy as np

from ..hashing import DEFAULT_KEY, siphash24
from ..symbols import CodedSymbols
from ..encoder import _xor_accumulate

_RATIOS = np.array([0.4, 0.4, 0.2])
_DEGREES = np.array([1, 2, 1])


class MetIBLT:
    """Nested MET-IBLT sized by rate steps: m(step) = m0 * 2**step."""

    def __init__(self, m0: int, steps: int, nbytes: int, key=DEFAULT_KEY):
        self.m0 = m0
        self.steps = steps
        self.nbytes = nbytes
        self.key = key
        self.layout = []  # (start, size) per (step, class)
        start = 0
        for s in range(steps):
            m_s = m0 * (2 ** s) - (m0 * (2 ** (s - 1)) if s else 0)
            sizes = np.maximum((np.floor(_RATIOS * m_s)).astype(int), 1)
            sizes[-1] = m_s - sizes[:-1].sum()
            for c, sz in enumerate(sizes):
                self.layout.append((start, int(sz), c))
                start += int(sz)
        self.m = start
        self.table = CodedSymbols.zeros(self.m, nbytes)

    def _cells(self, words: np.ndarray):
        """All (row, cell) pairs for a batch of items."""
        n = words.shape[0]
        rows, cells = [], []
        for li, (start, size, cls) in enumerate(self.layout):
            deg = _DEGREES[cls]
            for r in range(deg):
                h = siphash24(words, (self.key[0] ^ (li * 1315423911 + r),
                                      self.key[1] ^ 0x5DEECE66D), self.nbytes)
                cells.append(start + (h % np.uint64(size)).astype(np.int64))
                rows.append(np.arange(n))
        return np.concatenate(rows), np.concatenate(cells)

    def insert(self, words: np.ndarray, sign: int = 1) -> None:
        hashes = siphash24(words, self.key, self.nbytes)
        rows, cells = self._cells(words)
        _xor_accumulate(self.table.sums, self.table.checks, self.table.counts,
                        cells, words[rows], hashes[rows],
                        np.full(rows.size, sign, np.int64))

    def prefix(self, step: int) -> CodedSymbols:
        """Cells usable at rate step `step` (nested prefix)."""
        end = self.m0 * (2 ** step)
        end = min(end, self.m)
        return self.table.prefix(end)

    def decode(self, diff: CodedSymbols):
        sym = diff.copy()
        m_used = sym.m
        rec_items, rec_sides = [], []
        for _ in range(10 * m_used + 10):
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
            rows, cells = self._cells(x)
            keep = cells < m_used
            cells = cells[keep]
            _xor_accumulate(sym.sums, sym.checks, sym.counts, cells,
                            np.repeat(x, cells.size, axis=0),
                            np.repeat(hx, cells.size),
                            np.full(cells.size, -side, np.int64))
        ok = bool(sym.is_empty().all())
        items = np.stack(rec_items) if rec_items else \
            np.zeros((0, sym.L), np.uint32)
        return items, np.array(rec_sides, np.int8), ok
