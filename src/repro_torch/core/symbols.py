"""Coded symbols (paper §3): sum, checksum, count — and their algebra.

``CodedSymbols`` is the host-side (numpy) container for a prefix of the
infinite coded-symbol sequence.  Subtraction is index-wise, and by linearity
``symbols(A) - symbols(B) == symbols(A △ B)``.

Port of ``repro/core/symbols.py``: plain numpy, unchanged.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class CodedSymbols:
    sums: np.ndarray    # (m, L) uint32 — XOR of mapped items' words
    checks: np.ndarray  # (m,)   uint64 — XOR of mapped items' keyed hashes
    counts: np.ndarray  # (m,)   int64  — signed #items mapped (A: +1, B: -1)
    nbytes: int         # item length ℓ in bytes

    @property
    def m(self) -> int:
        return self.sums.shape[0]

    @property
    def L(self) -> int:
        return self.sums.shape[1]

    @classmethod
    def zeros(cls, m: int, nbytes: int) -> "CodedSymbols":
        L = (nbytes + 3) // 4
        return cls(np.zeros((m, L), np.uint32), np.zeros(m, np.uint64),
                   np.zeros(m, np.int64), nbytes)

    def copy(self) -> "CodedSymbols":
        return CodedSymbols(self.sums.copy(), self.checks.copy(),
                            self.counts.copy(), self.nbytes)

    def prefix(self, m: int) -> "CodedSymbols":
        assert m <= self.m
        return CodedSymbols(self.sums[:m], self.checks[:m], self.counts[:m],
                            self.nbytes)

    def window(self, lo: int, hi: int | None = None) -> "CodedSymbols":
        """Zero-copy view of symbols [lo, hi) of this prefix.

        The view aliases this container's arrays (mutations are shared);
        call ``.copy()`` on the result for an isolated snapshot.
        """
        hi = self.m if hi is None else hi
        if not 0 <= lo <= hi <= self.m:
            raise IndexError(f"window [{lo}, {hi}) outside prefix of {self.m}")
        return CodedSymbols(self.sums[lo:hi], self.checks[lo:hi],
                            self.counts[lo:hi], self.nbytes)

    def __getitem__(self, s: slice) -> "CodedSymbols":
        if not isinstance(s, slice):
            raise TypeError("CodedSymbols supports slice indexing only")
        lo, hi, step = s.indices(self.m)
        if step != 1:
            raise ValueError("CodedSymbols slicing requires step 1")
        return self.window(lo, hi)

    def subtract(self, other: "CodedSymbols") -> "CodedSymbols":
        """self ⊕ other (paper's ⊕ is subtraction: XOR sums/checks, −counts)."""
        m = min(self.m, other.m)
        return CodedSymbols(self.sums[:m] ^ other.sums[:m],
                            self.checks[:m] ^ other.checks[:m],
                            self.counts[:m] - other.counts[:m], self.nbytes)

    def concat(self, other: "CodedSymbols") -> "CodedSymbols":
        assert self.nbytes == other.nbytes
        return CodedSymbols(np.concatenate([self.sums, other.sums]),
                            np.concatenate([self.checks, other.checks]),
                            np.concatenate([self.counts, other.counts]),
                            self.nbytes)

    def is_empty(self) -> np.ndarray:
        """(m,) bool — symbol has no items mapped (all fields zero)."""
        return (self.counts == 0) & (self.checks == np.uint64(0)) & \
               (self.sums == 0).all(axis=1)

    def wire_bytes(self) -> int:
        """Transmitted size with the paper's variable-length count encoding
        (§6): sum (ℓ) + checksum (8) + ~1 byte amortized varint count."""
        from .wire import varint_count_bytes
        return self.m * (self.nbytes + 8) + varint_count_bytes(self.counts)
