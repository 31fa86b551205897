"""Rateless IBLT encoder — host path (paper §4.2, §6).

Port of ``repro/core/encoder.py``: plain numpy, unchanged.

The Go reference implementation extends the stream one symbol at a time with
a priority queue.  On this framework's host path we keep the *incremental*
semantics (a `Encoder` owns a growing prefix cache and extends it on demand,
so a node can stream an ever-longer prefix to any number of peers) but
replace the heap with vectorized chain-advancing rounds: each round advances
every item whose next mapped index falls inside the requested window and
XOR-accumulates with a sort + ``bitwise_xor.reduceat`` — O(total mapped
indices) work, the same asymptotics as the heap, at numpy speed.

Linearity makes the cache updatable in place: ``add_items`` /
``remove_items`` XOR the delta-set's symbols into the prefix (paper §4.1's
"treat the updates A △ A′ as a set and subtract its coded symbols").
"""
from __future__ import annotations

import numpy as np

from .hashing import DEFAULT_KEY, bytes_to_words, siphash24, words_per_item
from .mapping import _jump_np, map_seeds
from .symbols import CodedSymbols


def _xor_accumulate(sums: np.ndarray, checks: np.ndarray, counts: np.ndarray,
                    idx: np.ndarray, items: np.ndarray, hashes: np.ndarray,
                    sides: np.ndarray, base: int = 0) -> None:
    """Scatter-XOR ``items``/``hashes`` into rows ``idx - base`` (repeats ok)."""
    if idx.size == 0:
        return
    order = np.argsort(idx, kind="stable")
    sidx = idx[order] - base
    starts = np.flatnonzero(np.r_[True, sidx[1:] != sidx[:-1]])
    rows = sidx[starts]
    sums[rows] ^= np.bitwise_xor.reduceat(items[order], starts, axis=0)
    checks[rows] ^= np.bitwise_xor.reduceat(hashes[order], starts)
    np.add.at(counts, sidx, sides[order])


class Encoder:
    """Incremental rateless encoder for one set.

    Parameters
    ----------
    nbytes: item length ℓ in bytes (all items fixed-length).
    key: 128-bit session key (checksum PRF + mapping PRNG are derived).
    """

    def __init__(self, nbytes: int, key=DEFAULT_KEY):
        self.nbytes = nbytes
        self.L = words_per_item(nbytes)
        self.key = key
        self._items = np.zeros((0, self.L), np.uint32)
        self._hashes = np.zeros(0, np.uint64)
        self._seeds = np.zeros(0, np.uint64)
        self._next = np.zeros(0, np.int64)    # next unencoded mapped index
        self._state = np.zeros(0, np.uint64)  # PRNG state at `_next`
        self._weight = np.zeros(0, np.int8)   # +1 present, 0 tombstone
        self._cache = CodedSymbols.zeros(0, nbytes)

    # -- set mutation -------------------------------------------------------
    def __len__(self) -> int:
        return int((self._weight == 1).sum())

    @property
    def m(self) -> int:
        return self._cache.m

    def _coerce(self, items) -> np.ndarray:
        if isinstance(items, np.ndarray) and items.dtype == np.uint32:
            assert items.shape[1] == self.L
            return items
        return bytes_to_words(items, self.nbytes)

    def add_items(self, items) -> None:
        words = self._coerce(items)
        n = words.shape[0]
        hashes = siphash24(words, self.key, self.nbytes)
        seeds = map_seeds(words, self.key, self.nbytes)
        nxt = np.zeros(n, np.int64)
        state = seeds.copy()
        if self.m > 0:  # retro-encode the new items into the existing prefix
            nxt, state = self._encode_range(words, hashes, nxt, state,
                                            np.ones(n, np.int8), 0, self.m)
        self._items = np.concatenate([self._items, words])
        self._hashes = np.concatenate([self._hashes, hashes])
        self._seeds = np.concatenate([self._seeds, seeds])
        self._next = np.concatenate([self._next, nxt])
        self._state = np.concatenate([self._state, state])
        self._weight = np.concatenate([self._weight, np.ones(n, np.int8)])

    def remove_items(self, items) -> None:
        """Remove items (must be present).  XORs them out of the cached
        prefix and tombstones them for future extensions."""
        words = self._coerce(items)
        hashes = siphash24(words, self.key, self.nbytes)
        seeds = map_seeds(words, self.key, self.nbytes)
        if self.m > 0:
            self._encode_range(words, hashes, np.zeros(len(words), np.int64),
                               seeds.copy(), -np.ones(len(words), np.int8),
                               0, self.m)
        # tombstone by matching hash (hash collision on removal is negligible)
        kill = np.isin(self._hashes, hashes) & (self._weight == 1)
        self._weight[kill] = 0

    # -- encoding -----------------------------------------------------------
    def _encode_range(self, items, hashes, nxt, state, sides, lo: int, hi: int):
        """XOR chains of `items` into cache rows [lo, hi).  Returns final
        (next, state) positioned at the first index >= hi."""
        sums = self._cache.sums
        checks = self._cache.checks
        counts = self._cache.counts
        while True:
            live = np.flatnonzero(nxt < hi)
            if live.size == 0:
                return nxt, state
            _xor_accumulate(sums, checks, counts, nxt[live], items[live],
                            hashes[live], sides[live].astype(np.int64))
            nn, ns = _jump_np(nxt[live], state[live])
            nxt[live] = nn
            state[live] = ns

    def extend(self, m: int) -> None:
        """Grow the cached prefix to m coded symbols."""
        if m <= self.m:
            return
        old = self.m
        grown = CodedSymbols.zeros(m, self.nbytes)
        grown.sums[:old] = self._cache.sums
        grown.checks[:old] = self._cache.checks
        grown.counts[:old] = self._cache.counts
        self._cache = grown
        live = self._weight == 1
        nxt, state = self._encode_range(
            self._items[live], self._hashes[live], self._next[live],
            self._state[live], self._weight[live], old, m)
        self._next[live] = nxt
        self._state[live] = state

    def symbols(self, m: int) -> CodedSymbols:
        """The first m coded symbols (prefix of the universal sequence)."""
        self.extend(m)
        return self._cache.prefix(m).copy()

    def window(self, lo: int, hi: int) -> CodedSymbols:
        """Zero-copy view of coded symbols [lo, hi), extending on demand.

        The view aliases the cache *as of this call*: a later ``extend``
        past the current prefix reallocates the cache and detaches the
        view, while in-prefix ``add_items``/``remove_items`` mutate it.
        Consume (or ``.copy()``) a window before touching the encoder
        again; do not hold views across encoder operations.
        """
        self.extend(hi)
        return self._cache.window(lo, hi)


def encode(items, nbytes: int, m: int, key=DEFAULT_KEY) -> CodedSymbols:
    """One-shot: first m coded symbols of a set."""
    enc = Encoder(nbytes, key)
    enc.add_items(items)
    return enc.symbols(m)
