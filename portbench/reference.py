"""The plain reference: what an exact reconciliation has to report.

It works from the generated sets alone and imports nothing of the program.
For one replica against the serving node it gives

* the records only the node holds (the replica must fetch them) and the
  records only the replica holds (it must drop them), by plain set
  arithmetic on the records' bytes;
* the number of coded symbols the session uses: the first end of a pacing
  window at which the symbols of the difference peel to the end.

The second rests on the protocol's public definition (Yang, Gilad,
Alizadeh, SIGCOMM 2024, section 4): every record maps to symbol 0 and
then jumps ahead by skip sampling, driven by an xorshift64 generator
seeded with the record's keyed SipHash-2-4; a symbol is pure when exactly
one unrecovered record maps to it.  So whether a prefix of P symbols
decodes is a question about the graph of records and indices below P,
answered here by peeling that graph with counts, without building a
single coded symbol.  Subtracting the replica's symbols from the node's
leaves the symbols of the difference (linearity), so only the d differing
records are mapped.

Records are ``(n, nbytes)`` uint8 rows.  The hash reads them as
little-endian 32-bit words, zero-padded to whole words, and carries the
byte length in its final block.
"""
from __future__ import annotations

import numpy as np

_U64 = np.uint64
MAP_TWEAK = (0x9E3779B97F4A7C15, 0xD1B54A32D192ED03)


# ---------------------------------------------------------------------------
# SipHash-2-4 over 32-bit word rows, and the mapping chain.
# ---------------------------------------------------------------------------
def as_words(records: np.ndarray) -> np.ndarray:
    """(n, nbytes) uint8 -> (n, ceil(nbytes / 4)) little-endian uint32."""
    n, nbytes = records.shape
    L = (nbytes + 3) // 4
    padded = np.zeros((n, 4 * L), np.uint8)
    padded[:, :nbytes] = records
    return padded.view("<u4").astype(np.uint32)


def _rotl(x, r: int):
    return (x << _U64(r)) | (x >> _U64(64 - r))


def _round(v0, v1, v2, v3):
    v0 = v0 + v1
    v1 = _rotl(v1, 13) ^ v0
    v0 = _rotl(v0, 32)
    v2 = v2 + v3
    v3 = _rotl(v3, 16) ^ v2
    v0 = v0 + v3
    v3 = _rotl(v3, 21) ^ v0
    v2 = v2 + v1
    v1 = _rotl(v1, 17) ^ v2
    v2 = _rotl(v2, 32)
    return v0, v1, v2, v3


def siphash24(records: np.ndarray, key) -> np.ndarray:
    """(n,) uint64 keyed SipHash-2-4 of each record, over its words."""
    nbytes = records.shape[1]
    w = as_words(records).astype(np.uint64)
    n, L = w.shape
    k0, k1 = _U64(key[0]), _U64(key[1])
    v0 = np.full(n, k0 ^ _U64(0x736F6D6570736575), np.uint64)
    v1 = np.full(n, k1 ^ _U64(0x646F72616E646F6D), np.uint64)
    v2 = np.full(n, k0 ^ _U64(0x6C7967656E657261), np.uint64)
    v3 = np.full(n, k1 ^ _U64(0x7465646279746573), np.uint64)
    with np.errstate(over="ignore"):
        for i in range(L // 2):
            m = w[:, 2 * i] | (w[:, 2 * i + 1] << _U64(32))
            v3 ^= m
            v0, v1, v2, v3 = _round(*_round(v0, v1, v2, v3))
            v0 ^= m
        b = np.full(n, _U64(nbytes & 0xFF) << _U64(56), np.uint64)
        if L % 2:
            b |= w[:, L - 1]
        v3 ^= b
        v0, v1, v2, v3 = _round(*_round(v0, v1, v2, v3))
        v0 ^= b
        v2 ^= _U64(0xFF)
        for _ in range(4):
            v0, v1, v2, v3 = _round(v0, v1, v2, v3)
    return v0 ^ v1 ^ v2 ^ v3


def chains(records: np.ndarray, key, limit: int):
    """Every mapped index below ``limit`` of every record.

    Returns ``(item, index)`` int64 arrays, one entry per mapping, ordered
    by item.  Index 0 always; then ``g = max(1, ceil((1.5 + i) * ((1 - r)
    ** -0.5 - 1)))`` in float32, ``r`` the top 24 bits of the next
    xorshift64 state, the state seeded by the record's SipHash under the
    mapping key, with its low bit set.
    """
    n = records.shape[0]
    mkey = (key[0] ^ MAP_TWEAK[0], key[1] ^ MAP_TWEAK[1])
    state = siphash24(records, mkey) | _U64(1) if n else np.zeros(0, _U64)
    idx = np.zeros(n, np.int64)
    live = np.arange(n)
    items, indices = [], []
    one = np.float32(1.0)
    while live.size:
        items.append(live)
        indices.append(idx[live])
        s = state[live]
        s ^= s << _U64(13)
        s ^= s >> _U64(7)
        s ^= s << _U64(17)
        state[live] = s
        r = (s >> _U64(40)).astype(np.float32) * np.float32(2.0 ** -24)
        u = one / np.sqrt(one - r) - one
        f = np.float32(1.5) + idx[live].astype(np.float32)
        g = np.maximum(np.ceil(f * u).astype(np.int64), 1)
        idx[live] += g
        live = live[idx[live] < limit]
    if not items:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    item = np.concatenate(items)
    index = np.concatenate(indices)
    order = np.argsort(item, kind="stable")
    return item[order], index[order]


# ---------------------------------------------------------------------------
# Peeling the graph of records and symbol indices.
# ---------------------------------------------------------------------------
def peel(item: np.ndarray, index: np.ndarray, n: int, P: int) -> np.ndarray:
    """(n,) bool: which of the n records the first P symbols recover.

    ``item``/``index`` are :func:`chains`' entries (ordered by item).  A
    symbol is pure while one unrecovered record maps to it; its record is
    then recovered and leaves every symbol it maps to.
    """
    got = np.zeros(n, bool)
    if n == 0 or P <= 0:
        return got
    keep = index < P
    item, index = item[keep], index[keep]
    starts = np.searchsorted(item, np.arange(n + 1))
    deg = np.bincount(index, minlength=P)
    ids = np.bincount(index, weights=item.astype(np.float64), minlength=P)
    cand = np.flatnonzero(deg == 1)
    while cand.size:
        new = np.unique(np.rint(ids[cand]).astype(np.int64))
        new = new[~got[new]]
        if new.size == 0:
            break
        got[new] = True
        lo, hi = starts[new], starts[new + 1]
        span = hi - lo
        rows = np.repeat(lo - np.cumsum(span) + span, span) + \
            np.arange(int(span.sum()))
        hit = index[rows]
        deg -= np.bincount(hit, minlength=P)
        ids -= np.bincount(hit, weights=item[rows].astype(np.float64),
                           minlength=P)
        cand = np.unique(hit)
        cand = cand[deg[cand] == 1]
    return got


def window_ends(block: int, growth: float, max_m: int) -> list[int]:
    """The ends of the windows a session pulls under the doubling pacing
    ``take = max(block, floor(m * (growth - 1)))``, up to ``max_m``."""
    ends, m = [], 0
    while m < max_m:
        m = min(m + max(block, int(m * (growth - 1.0))), max_m)
        ends.append(m)
    return ends


class Expected:
    """What one replica's exact reconciliation reports.

    ``remote`` and ``local`` are the records only the node and only the
    replica hold; ``symbols`` the first window end at which the
    difference decodes (None: not within ``max_m``).  ``control`` gives
    the answer one window earlier: what a session that stopped there
    would hold.
    """

    def __init__(self, remote: np.ndarray, local: np.ndarray, key,
                 ends: list[int]):
        self.remote, self.local = remote, local
        self.ends = ends
        diff = np.concatenate([remote, local])
        d = diff.shape[0]
        self._item, self._index = chains(diff, key, ends[-1])
        self.symbols = None
        for P in ends:
            if P < d:
                continue
            if peel(self._item, self._index, d, P).all():
                self.symbols = P
                break

    def control(self) -> tuple[np.ndarray, np.ndarray, int]:
        """(remote, local, symbols) as they stand one window before the
        end at which the difference decodes."""
        if self.symbols is None:
            raise ValueError("the difference does not decode within max_m")
        at = self.ends.index(self.symbols)
        P = self.ends[at - 1] if at else 0
        n_remote = self.remote.shape[0]
        got = peel(self._item, self._index,
                   n_remote + self.local.shape[0], P)
        return self.remote[got[:n_remote]], self.local[got[n_remote:]], P


# ---------------------------------------------------------------------------
# Judging one report.
# ---------------------------------------------------------------------------
def _rows(a: np.ndarray) -> np.ndarray:
    a = np.ascontiguousarray(a)
    return a.view(np.dtype((np.void, a.shape[1]))).ravel()


def record_gap(got: np.ndarray, want: np.ndarray) -> int:
    """Records in one set and not the other, plus repeats in ``got``:
    0 when ``got`` holds exactly the records of ``want``."""
    if got.shape[0] == 0 or want.shape[0] == 0:
        return got.shape[0] + want.shape[0]
    g, w = _rows(got), _rows(want)
    repeats = g.size - np.unique(g).size
    both = np.unique(np.concatenate([np.unique(g), w]), return_counts=True)[1]
    return int(repeats + (both == 1).sum())


def judge(got_remote, got_local, got_symbols, want: Expected) -> dict:
    """The gaps between one report and the reference: records wrong and
    whether the symbols used differ."""
    return {"records": record_gap(got_remote, want.remote) +
            record_gap(got_local, want.local),
            "symbols": int(got_symbols != want.symbols)}
