"""Plain torch versions of the CUDA kernels (no tricks, any device).

Port of ``repro/kernels/ref.py``.  Each function computes what its kernel
computes, with torch ops only: the wrappers use them for tensors on the
CPU, the tests hold them against the reference package, and
``chip_smoke.py`` holds each kernel against its plain version on the card.

torch has no scatter-XOR, so :func:`iblt_apply_ref` goes through bit
parity, one bit plane at a time: ``index_add_`` of each bit into its target
row, mod 2, repacked.
"""
from __future__ import annotations

import torch

from repro_torch.core.hashing import split_u64
from repro_torch.core.mapping import indices_matrix_t

from .common import checksum_and_seed, checksum_pair


def map_indices_ref(items: torch.Tensor, *, K: int, m: int, nbytes: int,
                    key):
    """items (n, L) int32 -> (idx (n, K) int32, pad = m; chk (n, 2) int32
    (hi, lo))."""
    chk, seed = checksum_and_seed(items, key, nbytes)
    idx = indices_matrix_t(seed, m, K)
    return idx, torch.stack(split_u64(chk), dim=1)


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


def iblt_apply_ref(items: torch.Tensor, idxs: torch.Tensor, chks: torch.Tensor,
                   sides: torch.Tensor, *, m: int, m_out: int | None = None):
    """Signed coded-symbol delta of ``items`` over their mapped chains.

    items (n, L) int32, idxs (n, K) int32, chks (n, 2) int32, sides (n,)
    int32 -> (sums (m_out, L) int32, checks (m_out, 2) int32, counts
    (m_out, 1) int32).  A slot counts when ``0 <= idx < m`` and its row's
    side is nonzero; rows [m, m_out) stay zero.  The caller XORs sums and
    checks into its residual and subtracts the counts.
    """
    n, L = items.shape
    K = idxs.shape[1]
    m_out = m if m_out is None else m_out
    flat = idxs.reshape(-1).to(torch.int64)
    row = torch.arange(n, device=items.device).repeat_interleave(K)
    live = (flat >= 0) & (flat < m) & (sides.reshape(-1)[row] != 0)
    tgt, row = flat[live], row[live]
    both = _xor_scatter(torch.cat([items, chks], dim=1)[row], tgt, m_out)
    counts = torch.zeros(m_out, dtype=torch.int32, device=items.device)
    counts.index_add_(0, tgt, sides.reshape(-1)[row].to(torch.int32))
    return both[:, :L], both[:, L:], counts[:, None]
