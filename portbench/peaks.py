"""The card's published peaks and the bytes a reconciliation's decode needs.

NVIDIA H100 SXM data sheet: 3.35 TB/s of HBM3; dense rates without
sparsity.  A share of these is stated with the card's power limit beside
it, since a card held below 700 W runs slower under load.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12


def symbol_bytes(L: int) -> int:
    """One coded symbol on the card: L words of sum, a 64-bit checksum
    and a 32-bit count."""
    return 4 * L + 8 + 4


def recovered_bytes(L: int) -> int:
    """One recovered item on the card: its L words and its checksum."""
    return 4 * L + 8


def decode_bytes(symbols_used: int, d: int, L: int) -> int:
    """Bytes a decode of ``d`` items from ``symbols_used`` symbols needs
    at the least: each symbol read once, each recovered item and its
    checksum written once.  It counts the work the inputs need, not what
    an implementation launches, so it stays valid when kernels are fused,
    replaced or moved."""
    return symbols_used * symbol_bytes(L) + d * recovered_bytes(L)


def bound_seconds(nbytes: float) -> float:
    return nbytes / HBM_BYTES_PER_S
