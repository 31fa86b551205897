"""Merkle-trie state synchronization cost simulator (Ethereum "state heal",
paper §2 & §7.3).

Models the binary hash trie over the keyed hashes of a set's items and
computes the exact sync transcript between two parties: starting from the
root, each round the requester fetches the children of every differing node
(lock-step descent — the O(log N) round-trip cost the paper §7.3 measures);
when a differing subtrie bottoms out, its leaves are transferred.  Returns
(bytes, rounds, differing leaves) — the quantities behind Figs. 11/12/15/16.

Port of ``repro/core/baselines/merkle.py``: numpy, unchanged.
"""
from __future__ import annotations

import numpy as np

from ..hashing import DEFAULT_KEY, siphash24

HASH_BYTES = 32          # production tries use 32-byte node hashes
REQUEST_OVERHEAD = 16    # per-node request framing


class MerkleTrieSync:
    def __init__(self, words: np.ndarray, nbytes: int, key=DEFAULT_KEY,
                 fanout_bits: int = 4):
        """fanout_bits=4 matches Geth's 16-ary trie."""
        self.nbytes = nbytes
        self.fb = fanout_bits
        self.keys = np.sort(siphash24(words, key, nbytes)) if len(words) \
            else np.zeros(0, np.uint64)

    def _range(self, prefix: int, depth: int):
        """[lo, hi) of sorted keys under `prefix` at `depth` nibbles."""
        bits = self.fb * depth
        if bits == 0:
            return 0, len(self.keys)
        lo = np.uint64(prefix) << np.uint64(64 - bits)
        if bits >= 64:
            hi = lo + np.uint64(1)
        else:
            hi = (np.uint64(prefix) + np.uint64(1)) << np.uint64(64 - bits)
        return (int(np.searchsorted(self.keys, lo, side="left")),
                int(np.searchsorted(self.keys, hi, side="left")) if
                prefix + 1 < (1 << bits) else len(self.keys))

    def _node_hash(self, prefix: int, depth: int):
        lo, hi = self._range(prefix, depth)
        return hash(self.keys[lo:hi].tobytes())

    def _node_count(self, prefix: int, depth: int) -> int:
        lo, hi = self._range(prefix, depth)
        return hi - lo

    def sync_cost(self, other: "MerkleTrieSync", value_bytes: int):
        """Transcript for self (stale) pulling other's (fresh) state.

        Returns (bytes_moved, round_trips, differing_leaves)."""
        bytes_moved = HASH_BYTES
        rounds = 1
        if self._node_hash(0, 0) == other._node_hash(0, 0):
            return bytes_moved, rounds, 0
        frontier = [(0, 0)]
        leaves = 0
        max_depth = 64 // self.fb
        while frontier:
            rounds += 1
            nxt = []
            for prefix, depth in frontier:
                # bottomed-out subtrie: transfer its differing leaves
                if depth >= max_depth or \
                        max(self._node_count(prefix, depth),
                            other._node_count(prefix, depth)) <= 1:
                    lo_a, hi_a = self._range(prefix, depth)
                    lo_b, hi_b = other._range(prefix, depth)
                    a = set(self.keys[lo_a:hi_a].tolist())
                    b = set(other.keys[lo_b:hi_b].tolist())
                    d = len(a ^ b)
                    leaves += d
                    bytes_moved += d * (self.nbytes + value_bytes)
                    continue
                # fetch children hashes of the differing node
                for c in range(1 << self.fb):
                    child = (prefix << self.fb) | c
                    ca = self._node_count(child, depth + 1)
                    cb = other._node_count(child, depth + 1)
                    if ca == 0 and cb == 0:
                        continue
                    bytes_moved += HASH_BYTES + REQUEST_OVERHEAD
                    if self._node_hash(child, depth + 1) != \
                            other._node_hash(child, depth + 1):
                        nxt.append((child, depth + 1))
            frontier = nxt
        return bytes_moved, rounds, leaves
