"""Rateless IBLT codec — port of ``repro.core`` (sketch and baselines are
not ported yet)."""
from .decoder import PeelResult, peel, reconcile
from .encoder import Encoder, encode
from .hashing import (DEFAULT_KEY, bytes_to_words, siphash24, siphash24_pair,
                      words_per_item, words_to_bytes)
from .mapping import ALPHA, kmax, rho
from .stream import StreamDecoder
from .symbols import CodedSymbols

__all__ = [
    "ALPHA", "CodedSymbols", "DEFAULT_KEY", "Encoder", "PeelResult",
    "StreamDecoder", "bytes_to_words", "encode", "kmax", "peel", "reconcile",
    "rho", "siphash24", "siphash24_pair", "words_per_item", "words_to_bytes",
]
