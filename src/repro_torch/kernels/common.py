"""Shared hashing for the encode-side and peel-side kernels' plain versions.

Port of ``repro/kernels/common.py``.  The mapping chain (``map_indices``)
and the purity test (``purity_scan``) need the same two keyed hashes of an
item: the SipHash-2-4 checksum (paper §4.3) and the mapping-PRNG seed
under the tweaked key.  The CUDA kernels share ``csrc/siphash.cuh`` for the
same reason: the encoder and decoder stay bit-identical by construction.
"""
from __future__ import annotations

import torch

from repro_torch.core.hashing import map_key, siphash24_pair, siphash24_t


def checksum_pair(items: torch.Tensor, key, nbytes: int):
    """(hi, lo) int32 bit patterns of the checksum of items ``(..., L)``."""
    return siphash24_pair(items, key, nbytes)


def checksum_and_seed(items: torch.Tensor, key, nbytes: int):
    """Checksum and mapping-PRNG seed of items ``(..., L)``.

    Returns ``(chk, seed)``, each a u64 bit pattern in an int64 tensor; the
    seed is forced odd so the xorshift64 state is never zero — the
    contract of :func:`repro_torch.core.mapping.map_seeds`.  (The
    reference returns the same two values as four u32 halves.)
    """
    chk = siphash24_t(items, key, nbytes)
    seed = siphash24_t(items, map_key(key), nbytes) | 1
    return chk, seed
