"""Plain torch versions of the CUDA kernels (no tricks, any device).

Port of ``repro/kernels/ref.py``.  Each function computes what its kernel
computes, with torch ops only: the wrappers use them for tensors on the
CPU, the tests hold them against the reference package, and
``chip_smoke.py`` holds each kernel against its plain version on the card.

torch has no scatter-XOR, so :func:`iblt_apply_ref` and
:func:`iblt_encode_ref` go through bit parity, one bit plane at a time:
``index_add_`` of each bit into its target row, mod 2, repacked.
"""
from __future__ import annotations

import torch

from repro_torch.core.hashing import split_u64
from repro_torch.core.mapping import indices_matrix_t

from .common import checksum_and_seed, checksum_pair


def _live(count, n: int) -> int:
    """The live prefix of n items: all of them, or the (1,) ``count``."""
    return n if count is None else max(0, min(n, int(count.reshape(-1)[0])))


def map_indices_ref(items: torch.Tensor, *, K: int, m: int, nbytes: int,
                    key, count=None):
    """items (n, L) int32 -> (idx (n, K) int32, pad = m; chk (n, 2) int32
    (hi, lo)).  With ``count`` ((1,) int64) only the first ``count`` items
    are mapped; the kernel leaves the rows past it unwritten, here they
    hold pads and zero checksums."""
    n = _live(count, items.shape[0])
    idx = torch.full((items.shape[0], K), m, dtype=torch.int32,
                     device=items.device)
    cks = torch.zeros((items.shape[0], 2), dtype=torch.int32,
                      device=items.device)
    if n:
        chk, seed = checksum_and_seed(items[:n], key, nbytes)
        idx[:n] = indices_matrix_t(seed, m, K)
        cks[:n] = torch.stack(split_u64(chk), dim=1)
    return idx, cks


def purity_ref(sums: torch.Tensor, checks: torch.Tensor, counts: torch.Tensor,
               *, key, nbytes: int) -> torch.Tensor:
    """(mp, L) sums, (mp, 2) checks, (mp, 1) counts -> (mp,) int32 side.

    ``+1`` / ``-1`` where the symbol is pure (checksum matches the keyed
    hash of its sum and it is non-empty), ``0`` otherwise.
    """
    h_hi, h_lo = checksum_pair(sums, key, nbytes)
    cnt = counts.reshape(-1)
    pure = (h_hi == checks[:, 0]) & (h_lo == checks[:, 1]) & (cnt != 0)
    side = torch.where(cnt > 0, 1, -1)
    return torch.where(pure, side, 0).to(torch.int32)


def _xor_scatter(vals: torch.Tensor, tgt: torch.Tensor, rows: int):
    """(r, W) int32 -> (rows, W) int32: row ``j`` is the XOR of the ``vals``
    rows whose ``tgt`` is ``j`` (repeats fine)."""
    out = torch.zeros((rows, vals.shape[1]), dtype=torch.int32,
                      device=vals.device)
    for b in range(32):
        plane = torch.zeros_like(out).index_add_(0, tgt, (vals >> b) & 1)
        out |= (plane & 1) << b
    return out


def _scatter(items, idxs, chks, weights, limit, base, *, rows: int):
    """The shared body of the two scatters: slot ``(i, k)`` counts when
    ``0 <= idx < limit[i]`` and ``weights[i] != 0``; it XORs item and
    checksum into row ``base[i] + idx`` and adds ``weights[i]`` to that
    row's count.  ``limit`` and ``base`` are (n,) int64."""
    n, L = items.shape
    K = idxs.shape[1]
    flat = idxs.reshape(-1).to(torch.int64)
    row = torch.arange(n, device=items.device).repeat_interleave(K)
    live = (flat >= 0) & (flat < limit[row]) & (weights[row] != 0)
    tgt = (flat + base[row])[live]
    row = row[live]
    both = _xor_scatter(torch.cat([items, chks], dim=1)[row], tgt, rows)
    counts = torch.zeros(rows, dtype=torch.int32, device=items.device)
    counts.index_add_(0, tgt, weights[row].to(torch.int32))
    return both[:, :L], both[:, L:], counts[:, None]


def iblt_apply_ref(items: torch.Tensor, idxs: torch.Tensor, chks: torch.Tensor,
                   sides: torch.Tensor, unit: torch.Tensor,
                   m_units: torch.Tensor, *, mp: int, count=None):
    """Signed coded-symbol delta of ``items`` over their mapped chains, for
    U decode units laid end to end (a plain decode is U = 1).

    items (n, L) int32, idxs (n, K) int32, chks (n, 2) int32, sides (n,)
    int32, unit (n,) int32 and m_units (U,) int32 -> (sums (U·mp, L),
    checks (U·mp, 2), counts (U·mp, 1)), all int32.  Item ``i`` scatters
    into block ``unit[i]`` of ``mp`` rows, where ``0 <= idx <
    m_units[unit[i]]`` and its side is nonzero.  The caller XORs sums and
    checks into its residual and subtracts the counts.  With ``count``
    ((1,) int64) only the first ``count`` items take part.
    """
    n = _live(count, items.shape[0])
    if n == 0:
        rows, L = mp * m_units.numel(), items.shape[1]
        return (torch.zeros((rows, L), dtype=torch.int32, device=items.device),
                torch.zeros((rows, 2), dtype=torch.int32, device=items.device),
                torch.zeros((rows, 1), dtype=torch.int32, device=items.device))
    u = unit[:n].long()
    return _scatter(items[:n], idxs[:n], chks[:n], sides.reshape(-1)[:n],
                    m_units.long()[u], u * mp, rows=mp * m_units.numel())


def iblt_encode_ref(items: torch.Tensor, idxs: torch.Tensor,
                    chks: torch.Tensor, *, m: int):
    """Coded-symbol accumulation, the encoder's half of the codec.

    items (n, L) int32, idxs (n, K) int32 (pad = m), chks (n, 2) int32 ->
    (sums (m, L) int32, checks (m, 2) int32, counts (m, 1) int32): symbol
    ``j`` holds the XOR of the items and checksums with a slot ``idx == j``
    and their count, for every ``0 <= j < m``.
    """
    n = items.shape[0]
    ones = torch.ones(n, dtype=torch.int32, device=items.device)
    limit = torch.full((n,), m, dtype=torch.int64, device=items.device)
    return _scatter(items, idxs, chks, ones, limit, torch.zeros_like(limit),
                    rows=m)
