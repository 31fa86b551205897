"""Baselines the paper compares against (§7): regular IBLT [12], MET-IBLT
[15], CPI/PinSketch [19, 6], and Merkle-trie state sync [38].

Port of ``repro/core/baselines``: numpy on the port's ``hashing``,
``symbols`` and ``encoder._xor_accumulate``; the decoders stay host loops,
as in the reference."""
from .regular_iblt import RegularIBLT
from .met_iblt import MetIBLT
from .cpi import CPISketch
from .merkle import MerkleTrieSync

__all__ = ["RegularIBLT", "MetIBLT", "CPISketch", "MerkleTrieSync"]
