"""Keyed 64-bit hashing for Rateless IBLT (paper §4.3).

Port of ``repro/core/hashing.py``.  SipHash-2-4 keys the per-symbol
``checksum`` and seeds the mapping PRNG.  Two implementations:

* host path — vectorized numpy over ``uint64``, identical to the reference;
* torch path — the twin of the reference's ``siphash24_pair``.  torch has no
  usable unsigned 64-bit arithmetic on CPU, so a u64 lives in an ``int64``
  tensor as its bit pattern: add, XOR and left shift wrap exactly as on
  ``uint64``; every right shift is masked, because ``>>`` on a signed
  tensor is arithmetic.

Items are fixed-length bit strings stored as little-endian 32-bit word
arrays of shape ``(..., L)``; the true byte length feeds SipHash's length
block.  Device tensors hold those words as ``int32`` bit patterns.
"""
from __future__ import annotations

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Keys: the session key, and the tweak that derives the mapping-PRNG key.
# ---------------------------------------------------------------------------
DEFAULT_KEY = (0x0706050403020100, 0x0F0E0D0C0B0A0908)
_MAP_TWEAK = (0x9E3779B97F4A7C15, 0xD1B54A32D192ED03)

_U64 = np.uint64
_MASK32 = 0xFFFFFFFF


def map_key(key=DEFAULT_KEY):
    """Derive the mapping-PRNG key from the session key."""
    return (key[0] ^ _MAP_TWEAK[0], key[1] ^ _MAP_TWEAK[1])


# ---------------------------------------------------------------------------
# Host path: numpy uint64, vectorized over leading axes.
# ---------------------------------------------------------------------------
def _rotl_np(x, r):
    r = _U64(r)
    return (x << r) | (x >> _U64(64 - int(r)))


def _sipround_np(v0, v1, v2, v3):
    v0 = v0 + v1
    v1 = _rotl_np(v1, 13)
    v1 ^= v0
    v0 = _rotl_np(v0, 32)
    v2 = v2 + v3
    v3 = _rotl_np(v3, 16)
    v3 ^= v2
    v0 = v0 + v3
    v3 = _rotl_np(v3, 21)
    v3 ^= v0
    v2 = v2 + v1
    v1 = _rotl_np(v1, 17)
    v1 ^= v2
    v2 = _rotl_np(v2, 32)
    return v0, v1, v2, v3


def siphash24(words: np.ndarray, key=DEFAULT_KEY, nbytes: int | None = None) -> np.ndarray:
    """SipHash-2-4 of uint32 word arrays ``(..., L)`` -> uint64 ``(...,)``.

    Message = the L little-endian 32-bit words; the final block carries
    ``nbytes & 0xff`` in the top byte per the SipHash spec.
    """
    words = np.asarray(words, dtype=np.uint32)
    if words.ndim == 1:
        words = words[None, :]
        squeeze = True
    else:
        squeeze = False
    lead = words.shape[:-1]
    L = words.shape[-1]
    if nbytes is None:
        nbytes = 4 * L

    k0 = _U64(key[0])
    k1 = _U64(key[1])
    v0 = np.full(lead, k0 ^ _U64(0x736F6D6570736575), dtype=np.uint64)
    v1 = np.full(lead, k1 ^ _U64(0x646F72616E646F6D), dtype=np.uint64)
    v2 = np.full(lead, k0 ^ _U64(0x6C7967656E657261), dtype=np.uint64)
    v3 = np.full(lead, k1 ^ _U64(0x7465646279746573), dtype=np.uint64)

    w64 = words.astype(np.uint64)
    for i in range(L // 2):
        m = w64[..., 2 * i] | (w64[..., 2 * i + 1] << _U64(32))
        v3 ^= m
        v0, v1, v2, v3 = _sipround_np(v0, v1, v2, v3)
        v0, v1, v2, v3 = _sipround_np(v0, v1, v2, v3)
        v0 ^= m
    # final block: leftover word (if L odd) + length byte in the top byte.
    b = _U64((nbytes & 0xFF)) << _U64(56)
    if L % 2 == 1:
        b = b | w64[..., L - 1]
    v3 ^= b
    v0, v1, v2, v3 = _sipround_np(v0, v1, v2, v3)
    v0, v1, v2, v3 = _sipround_np(v0, v1, v2, v3)
    v0 ^= b
    v2 ^= _U64(0xFF)
    for _ in range(4):
        v0, v1, v2, v3 = _sipround_np(v0, v1, v2, v3)
    out = v0 ^ v1 ^ v2 ^ v3
    return out[0] if squeeze else out


# ---------------------------------------------------------------------------
# Torch path: u64 bit patterns in int64 tensors, on any device.
# ---------------------------------------------------------------------------
def as_i64(x: int) -> int:
    """A u64 constant as the int64 with the same bit pattern."""
    x &= (1 << 64) - 1
    return x - (1 << 64) if x >> 63 else x


def shr(x: torch.Tensor, r: int) -> torch.Tensor:
    """Logical right shift of u64 bits held in int64 (0 < r < 64)."""
    return (x >> r) & ((1 << (64 - r)) - 1)


def _rotl_t(x, r):
    return (x << r) | shr(x, 64 - r)


def _sipround_t(v0, v1, v2, v3):
    v0 = v0 + v1
    v1 = _rotl_t(v1, 13) ^ v0
    v0 = _rotl_t(v0, 32)
    v2 = v2 + v3
    v3 = _rotl_t(v3, 16) ^ v2
    v0 = v0 + v3
    v3 = _rotl_t(v3, 21) ^ v0
    v2 = v2 + v1
    v1 = _rotl_t(v1, 17) ^ v2
    v2 = _rotl_t(v2, 32)
    return v0, v1, v2, v3


def words_u32(words: torch.Tensor) -> torch.Tensor:
    """32-bit words (int32 bit patterns or int64) -> int64 in [0, 2**32)."""
    return words.to(torch.int64) & _MASK32


def to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> int32 tensor with the same low 32 bits."""
    x = x & _MASK32
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def siphash24_t(words: torch.Tensor, key=DEFAULT_KEY,
                nbytes: int | None = None) -> torch.Tensor:
    """SipHash-2-4 of 32-bit words ``(..., L)`` -> u64 bits as int64 ``(...,)``.

    Bit-exact with :func:`siphash24`; runs on the words' device.
    """
    L = words.shape[-1]
    if nbytes is None:
        nbytes = 4 * L
    w = words_u32(words)
    lead = w.shape[:-1]

    def full(c):
        return torch.full(lead, as_i64(c), dtype=torch.int64, device=w.device)

    v0 = full(key[0] ^ 0x736F6D6570736575)
    v1 = full(key[1] ^ 0x646F72616E646F6D)
    v2 = full(key[0] ^ 0x6C7967656E657261)
    v3 = full(key[1] ^ 0x7465646279746573)
    for i in range(L // 2):
        m = w[..., 2 * i] | (w[..., 2 * i + 1] << 32)
        v3 = v3 ^ m
        v0, v1, v2, v3 = _sipround_t(v0, v1, v2, v3)
        v0, v1, v2, v3 = _sipround_t(v0, v1, v2, v3)
        v0 = v0 ^ m
    b = full((nbytes & 0xFF) << 56)
    if L % 2 == 1:
        b = b | w[..., L - 1]
    v3 = v3 ^ b
    v0, v1, v2, v3 = _sipround_t(v0, v1, v2, v3)
    v0, v1, v2, v3 = _sipround_t(v0, v1, v2, v3)
    v0 = v0 ^ b
    v2 = v2 ^ 0xFF
    for _ in range(4):
        v0, v1, v2, v3 = _sipround_t(v0, v1, v2, v3)
    return v0 ^ v1 ^ v2 ^ v3


def split_u64(x: torch.Tensor):
    """u64 bits in int64 -> (hi, lo) int32 bit patterns."""
    return to_i32(shr(x, 32)), to_i32(x)


def join_u64(pair: torch.Tensor) -> torch.Tensor:
    """``(..., 2)`` int32 (hi, lo) bit patterns -> u64 bits in int64."""
    return (words_u32(pair[..., 0]) << 32) | words_u32(pair[..., 1])


def siphash24_pair(words: torch.Tensor, key=DEFAULT_KEY,
                   nbytes: int | None = None):
    """Twin of the reference's ``siphash24_pair``: (hi, lo) as int32 bit
    patterns (hi = result >> 32, lo = low word)."""
    return split_u64(siphash24_t(words, key, nbytes))


# ---------------------------------------------------------------------------
# Byte <-> word helpers.
# ---------------------------------------------------------------------------
def words_per_item(nbytes: int) -> int:
    return (nbytes + 3) // 4


def bytes_to_words(items, nbytes: int) -> np.ndarray:
    """(n, nbytes) uint8 (or list[bytes]) -> (n, L) uint32 little-endian."""
    if isinstance(items, (list, tuple)):
        items = np.frombuffer(b"".join(items), dtype=np.uint8).reshape(len(items), nbytes)
    items = np.asarray(items, dtype=np.uint8)
    n = items.shape[0]
    L = words_per_item(nbytes)
    pad = 4 * L - nbytes
    if pad:
        items = np.concatenate([items, np.zeros((n, pad), dtype=np.uint8)], axis=1)
    return items.reshape(n, L, 4).view(np.uint32).reshape(n, L).copy()


def words_to_bytes(words: np.ndarray, nbytes: int) -> np.ndarray:
    words = np.ascontiguousarray(np.asarray(words, dtype=np.uint32))
    n = words.shape[0]
    if n == 0:
        return np.zeros((0, nbytes), dtype=np.uint8)
    raw = words.view(np.uint8).reshape(n, -1)
    return raw[:, :nbytes].copy()
