"""Rateless IBLT codec — port of ``repro.core``."""
from .decoder import PeelResult, peel, reconcile
from .encoder import Encoder, encode
from .hashing import (DEFAULT_KEY, bytes_to_words, siphash24, siphash24_pair,
                      words_per_item, words_to_bytes)
from .mapping import ALPHA, expected_degree, kmax, rho
from .sketch import Sketch, reconcile_sets
from .stream import StreamDecoder
from .symbols import CodedSymbols

__all__ = [
    "ALPHA", "CodedSymbols", "DEFAULT_KEY", "Encoder", "PeelResult", "Sketch",
    "StreamDecoder", "bytes_to_words", "encode", "expected_degree", "kmax",
    "peel", "reconcile", "reconcile_sets", "rho", "siphash24",
    "siphash24_pair", "words_per_item", "words_to_bytes",
]
