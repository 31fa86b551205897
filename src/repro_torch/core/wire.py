"""Wire encoding of coded-symbol streams (paper §6): the protocol frame.

Port of the frame codec of ``repro/core/wire.py`` (plain numpy, byte-equal
with the reference).  The ``count`` field of the i-th coded symbol of a set
of N items is concentrated around N·ρ(i); a frame carries only the zig-zag
varint of (count − round(N·ρ(i))), ~1 byte/symbol, while ``sum`` and
``checksum`` travel raw (ℓ and 8 bytes).

:func:`encode_frames` / :func:`decode_frames` speak the self-describing
frame: a 24-byte header ``(m, nbytes, n_items, start)`` then a columnar
body — all sums, all checksums, all varint count deltas.  The byte layout
is ``docs/WIRE_FORMAT.md``.  The reference's legacy stream codec and its
sharded "RSH1" payload are not ported yet.
"""
from __future__ import annotations

import struct

import numpy as np

from .mapping import rho
from .symbols import CodedSymbols

_FRAME_HDR = struct.Struct("<IIQQ")   # m, nbytes, n_items, start
_MAX_VARINT = 10                      # ⌈64/7⌉ bytes bound a u64 varint


def _zigzag(v: np.ndarray) -> np.ndarray:
    v = v.astype(np.int64)
    return ((v << 1) ^ (v >> 63)).astype(np.uint64)


def _unzigzag(u: np.ndarray) -> np.ndarray:
    u = u.astype(np.uint64)
    return ((u >> np.uint64(1)).astype(np.int64)) ^ -(u & np.uint64(1)).astype(np.int64)


def expected_counts(n_items: int, start: int, stop: int) -> np.ndarray:
    i = np.arange(start, stop, dtype=np.float64)
    return np.rint(n_items * rho(i)).astype(np.int64)


# ---------------------------------------------------------------------------
# Vectorized varint (LEB128) codec for uint64 vectors.
# ---------------------------------------------------------------------------
def _varint_encode_vec(u: np.ndarray) -> np.ndarray:
    """(n,) uint64 -> concatenated LEB128 bytes, one varint per value."""
    u = np.ascontiguousarray(u, dtype=np.uint64)
    n = u.shape[0]
    if n == 0:
        return np.zeros(0, np.uint8)
    shifts = (np.arange(_MAX_VARINT, dtype=np.uint64) * np.uint64(7))
    chunks = (u[:, None] >> shifts[None, :]) & np.uint64(0x7F)   # (n, 10)
    nb = np.ones(n, np.int64)                                    # bytes/value
    v = u >> np.uint64(7)
    for _ in range(_MAX_VARINT - 1):
        nb += (v != 0)
        v >>= np.uint64(7)
    cols = np.arange(_MAX_VARINT)[None, :]
    cont = cols < (nb[:, None] - 1)                              # MSB flags
    mat = (chunks | (cont.astype(np.uint64) << np.uint64(7))).astype(np.uint8)
    return mat[cols < nb[:, None]]                               # row-major


def _varint_decode_vec(buf: np.ndarray, n: int) -> tuple[np.ndarray, int]:
    """Decode exactly ``n`` varints from the head of ``buf`` (uint8 view).

    Returns (values uint64, bytes consumed).
    """
    if n == 0:
        return np.zeros(0, np.uint64), 0
    is_last = (buf & 0x80) == 0
    ends = np.flatnonzero(is_last)
    if ends.size < n:
        raise ValueError("truncated varint section")
    used = int(ends[n - 1]) + 1
    buf = buf[:used]
    is_last = is_last[:used]
    value_id = np.cumsum(np.r_[0, is_last[:-1].astype(np.int64)])
    starts = np.r_[np.int64(0), ends[: n - 1] + 1]
    pos = np.arange(used, dtype=np.int64) - starts[value_id]
    vals = np.zeros(n, np.uint64)
    np.bitwise_or.at(vals, value_id,
                     (buf & 0x7F).astype(np.uint64) << (np.uint64(7) * pos.astype(np.uint64)))
    return vals, used


def varint_count_bytes(counts: np.ndarray, n_items: int | None = None,
                       start: int = 0) -> int:
    """Size in bytes of the varint-delta encoding of a count vector."""
    counts = np.asarray(counts, dtype=np.int64)
    if n_items is None:
        n_items = int(abs(counts[0])) if counts.size else 0
    exp = expected_counts(n_items, start, start + counts.size)
    return int(_varint_encode_vec(_zigzag(counts - exp)).size)


# ---------------------------------------------------------------------------
# Columnar body: [sums: m·ℓ] [checks: m·8 LE] [count deltas: varints].
# ---------------------------------------------------------------------------
def _pack_body(sym: CodedSymbols, exp: np.ndarray) -> bytes:
    raw = np.ascontiguousarray(sym.sums).view(np.uint8).reshape(sym.m, 4 * sym.L)
    sums = np.ascontiguousarray(raw[:, : sym.nbytes])           # drop word pad
    checks = np.ascontiguousarray(sym.checks.astype("<u8"))
    deltas = _varint_encode_vec(_zigzag(sym.counts - exp))
    return sums.tobytes() + checks.tobytes() + deltas.tobytes()


def _unpack_body(buf: memoryview, pos: int, m: int, nbytes: int,
                 exp: np.ndarray) -> tuple[CodedSymbols, int]:
    L = (nbytes + 3) // 4
    sym = CodedSymbols.zeros(m, nbytes)
    raw = np.frombuffer(buf, np.uint8, count=m * nbytes, offset=pos)
    pos += m * nbytes
    padded = sym.sums.view(np.uint8).reshape(m, 4 * L)
    padded[:, :nbytes] = raw.reshape(m, nbytes)
    sym.checks[:] = np.frombuffer(buf, "<u8", count=m, offset=pos)
    pos += 8 * m
    z, used = _varint_decode_vec(
        np.frombuffer(buf, np.uint8, offset=pos), m)
    pos += used
    sym.counts[:] = _unzigzag(z) + exp
    return sym, pos


def _infer_n_items(sym: CodedSymbols, start: int, n_items: int | None) -> int:
    """Default n_items to |count of symbol 0|; only valid at start == 0."""
    if n_items is not None:
        return n_items
    if start != 0:
        raise ValueError("n_items is required for a nonzero-start window")
    return int(abs(sym.counts[0])) if sym.m else 0


# ---------------------------------------------------------------------------
# Protocol frames (self-describing windows of the universal stream).
# ---------------------------------------------------------------------------
def encode_frames(sym: CodedSymbols, start: int = 0,
                  n_items: int | None = None) -> bytes:
    """Serialize symbols [start, start+m) of the stream of a set with
    ``n_items`` elements into one self-describing frame."""
    n_items = _infer_n_items(sym, start, n_items)
    exp = expected_counts(n_items, start, start + sym.m)
    return _FRAME_HDR.pack(sym.m, sym.nbytes, n_items, start) + \
        _pack_body(sym, exp)


def decode_frames(data: bytes) -> tuple[CodedSymbols, int, int]:
    """Inverse of :func:`encode_frames`: (symbols, n_items, start)."""
    m, nbytes, n_items, start = _FRAME_HDR.unpack_from(data, 0)
    exp = expected_counts(n_items, start, start + m)
    sym, _ = _unpack_body(memoryview(data), _FRAME_HDR.size, m, nbytes, exp)
    return sym, n_items, start
