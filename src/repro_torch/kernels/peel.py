"""Device wave-peeling decoder: kernels B and C and the wave loop.

Port of ``repro/kernels/peel.py``.  Each belief-propagation round of the
paper's peeling decoder (§3) becomes one wave of three stages:

1. **purity scan** — kernel B (``csrc/purity_scan.cu``) re-keys every coded
   symbol's sum with SipHash-2-4 and compares it with the stored checksum:
   ``±1`` where the symbol holds exactly one item, ``0`` elsewhere.
2. **compaction + dedupe** — the first ``cap`` pure rows in ascending
   symbol order, deduped by checksum within the wave (first occurrence
   wins) and against everything recovered in earlier waves.
3. **chain removal** — the recovered items re-derive their mapped-index
   chains with kernel A (:mod:`.map_indices`) and kernel C
   (``csrc/iblt_apply.cu``) scatters their signed delta, which is XOR-ed
   into the residual (counts subtracted).

The loop runs in Python and reads ``n_new``/``overflow`` on the host each
wave, as the reference's CPU path does.  Every choice that shapes the
outcome matches the reference — ``cap``, ``K``, the dedupe order, the
``max_diff`` overflow rule and the ``rounds``/``success`` semantics — so
items, their order, rounds and residual are identical.

Where the reference dedupes with a ``cap × cap`` pairwise mask and a
``cap × D`` seen-mask (quadratic; ~10¹⁰ elements at a 160,000-symbol
prefix), this port sorts the wave's 64-bit checksums (stable, so the first
occurrence is the lowest symbol index) and tests them against the
recovered checksums with ``torch.isin``: the identical ``keep`` vector in
O(cap log cap).

Kernels B and C follow the wrapper rule of :mod:`.map_indices`: the plain
torch version for CPU tensors, the kernel or an exception for CUDA tensors.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.hashing import join_u64

from ._build import check_launch, device_ptr, launcher, stream_of
from .map_indices import map_indices
from .ref import iblt_apply_ref, purity_ref


# ---------------------------------------------------------------------------
# Kernel B: purity scan.
# ---------------------------------------------------------------------------
def purity_scan(sums: torch.Tensor, checks: torch.Tensor, counts: torch.Tensor,
                *, key, nbytes: int) -> torch.Tensor:
    """(mp, L) int32 sums, (mp, 2) int32 checks, (mp, 1) int32 counts ->
    (mp,) int32 sides.  ``purity_scan.launches`` counts kernel launches."""
    if sums.device.type == "cpu":
        return purity_ref(sums, checks, counts, key=key, nbytes=nbytes)
    mp, L = sums.shape
    p_sums = device_ptr(sums, "sums", torch.int32, 2)
    p_checks = device_ptr(checks, "checks", torch.int32, 2)
    p_counts = device_ptr(counts, "counts", torch.int32, 2)
    if checks.shape != (mp, 2) or counts.shape != (mp, 1):
        raise ValueError(f"checks {tuple(checks.shape)} / counts "
                         f"{tuple(counts.shape)} do not match sums {mp}")
    side = torch.empty(mp, dtype=torch.int32, device=sums.device)
    if mp == 0:
        return side
    with torch.cuda.device(sums.device):
        rc = launcher("purity_scan")(
            p_sums, p_checks, p_counts, mp, L, nbytes, key[0], key[1],
            side.data_ptr(), stream_of(sums))
    check_launch("purity_scan", rc)
    purity_scan.launches += 1
    return side


purity_scan.launches = 0


# ---------------------------------------------------------------------------
# Kernel C: signed scatter of a wave's recovered items.
# ---------------------------------------------------------------------------
def iblt_apply(items: torch.Tensor, idxs: torch.Tensor, chks: torch.Tensor,
               sides: torch.Tensor, *, m: int, m_out: int | None = None):
    """Signed coded-symbol delta of ``items`` over their mapped chains.

    items (n, L) int32, idxs (n, K) int32, chks (n, 2) int32, sides (n,)
    int32 -> (sums (m_out, L), checks (m_out, 2), counts (m_out, 1)), all
    int32, ``m_out`` defaulting to ``m``.  A slot counts when
    ``0 <= idx < m`` and its side is nonzero; rows [m, m_out) stay zero.
    The caller XORs sums/checks into its residual and *subtracts* counts.
    ``iblt_apply.launches`` counts kernel launches.
    """
    if items.device.type == "cpu":
        return iblt_apply_ref(items, idxs, chks, sides, m=m, m_out=m_out)
    m_out = m if m_out is None else m_out
    if not 0 <= m <= m_out:
        raise ValueError(f"need 0 <= m <= m_out, got m={m}, m_out={m_out}")
    n, L = items.shape
    K = idxs.shape[1]
    p_items = device_ptr(items, "items", torch.int32, 2)
    p_idxs = device_ptr(idxs, "idxs", torch.int32, 2)
    p_chks = device_ptr(chks, "chks", torch.int32, 2)
    p_sides = device_ptr(sides, "sides", torch.int32, 1)
    if idxs.shape[0] != n or chks.shape != (n, 2) or sides.shape != (n,):
        raise ValueError("items, idxs, chks and sides disagree on n")
    dev = items.device
    sums = torch.zeros((m_out, L), dtype=torch.int32, device=dev)
    checks = torch.zeros((m_out, 2), dtype=torch.int32, device=dev)
    counts = torch.zeros((m_out, 1), dtype=torch.int32, device=dev)
    if n * K == 0:
        return sums, checks, counts
    with torch.cuda.device(dev):
        rc = launcher("iblt_apply")(
            p_items, p_idxs, p_chks, p_sides, n, K, L, m, sums.data_ptr(),
            checks.data_ptr(), counts.data_ptr(), stream_of(items))
    check_launch("iblt_apply", rc)
    iblt_apply.launches += 1
    return sums, checks, counts


iblt_apply.launches = 0


# ---------------------------------------------------------------------------
# The wave loop.
# ---------------------------------------------------------------------------
class PeelState(NamedTuple):
    sums: torch.Tensor        # (mp, L) int32 — residual symbol sums
    checks: torch.Tensor      # (mp, 2) int32 — residual checksums (hi, lo)
    counts: torch.Tensor      # (mp, 1) int32 — residual signed counts
    rec_items: torch.Tensor   # (n_rec, L) int32 — recovered source symbols
    rec_checks: torch.Tensor  # (n_rec, 2) int32 — their checksums
    rec_sides: torch.Tensor   # (n_rec,) int32   — +1 remote-only, -1 local
    n_rec: int
    changed: bool             # last wave recovered something
    overflow: bool            # a wave would exceed max_diff
    rounds: int


def _stage1(state: PeelState, *, cap: int, max_diff: int, key, nbytes: int):
    """Purity scan + pure-row compaction + dedupe.

    Returns ``(rows, side, n_new, overflow)``: the symbol indices of this
    wave's new items in ascending order, their sides, their count, and
    whether appending them would exceed ``max_diff``.  Pure rows beyond
    the first ``cap`` wait for the next wave, as in the reference.
    """
    side = purity_scan(state.sums, state.checks, state.counts, key=key,
                       nbytes=nbytes)
    pidx = torch.nonzero(side).reshape(-1)[:cap]
    chk = join_u64(state.checks[pidx])
    # first occurrence by symbol index wins: a stable sort keeps equal
    # checksums in ascending index order
    skey, order = torch.sort(chk, stable=True)
    first = torch.ones_like(skey, dtype=torch.bool)
    first[1:] = skey[1:] != skey[:-1]
    keep = torch.empty_like(first)
    keep[order] = first
    keep &= ~torch.isin(chk, join_u64(state.rec_checks))
    rows = pidx[keep]
    n_new = int(rows.numel())
    return rows, side[rows], n_new, state.n_rec + n_new > max_diff


def _stage2(state: PeelState, rows, side, m: int, *, K: int, key,
            nbytes: int) -> PeelState:
    """Chain re-derivation + signed removal + recovered-buffer append."""
    items = state.sums[rows]
    chks = state.checks[rows]
    idxs, _ = map_indices(items, K=K, m=m, nbytes=nbytes, key=key)
    mp = state.sums.shape[0]
    d_sums, d_checks, d_counts = iblt_apply(items, idxs, chks, side, m=m,
                                            m_out=mp)
    return state._replace(
        sums=state.sums ^ d_sums,
        checks=state.checks ^ d_checks,
        counts=state.counts - d_counts,
        rec_items=torch.cat([state.rec_items, items]),
        rec_checks=torch.cat([state.rec_checks, chks]),
        rec_sides=torch.cat([state.rec_sides, side]),
        n_rec=state.n_rec + int(rows.numel()))


def peel_waves(sums, checks, counts, *, m: int, nbytes: int, key,
               max_diff: int, K: int, max_rounds: int = 10_000,
               block_n: int = 256):
    """Iterate purity → compact/dedupe → remove to a fixed point.

    Inputs are the *padded* difference symbols on one device: sums (mp, L)
    int32, checks (mp, 2) int32, counts (mp, 1) int32, rows [m, mp) zero.
    Returns the final :class:`PeelState` and ``success`` (all symbols empty
    and no overflow).  A wave that would take the recovered items past
    ``max_diff`` is not applied: the state keeps the completed waves and
    ``overflow`` is set, so the caller can fall back to the host decoder.
    """
    mp, L = sums.shape
    cap = min(2 * max(max_diff, 1), mp)
    cap = max(((cap + block_n - 1) // block_n) * block_n, block_n)
    key = tuple(key)
    dev = sums.device
    state = PeelState(
        sums=sums, checks=checks, counts=counts,
        rec_items=torch.zeros((0, L), dtype=torch.int32, device=dev),
        rec_checks=torch.zeros((0, 2), dtype=torch.int32, device=dev),
        rec_sides=torch.zeros(0, dtype=torch.int32, device=dev),
        n_rec=0, changed=True, overflow=False, rounds=0)
    while state.rounds < max_rounds:
        rows, side, n_new, overflow = _stage1(
            state, cap=cap, max_diff=max_diff, key=key, nbytes=nbytes)
        state = state._replace(rounds=state.rounds + 1)
        if overflow or n_new == 0:
            state = state._replace(changed=False, overflow=overflow)
            break
        state = _stage2(state, rows, side, m, K=K, key=key, nbytes=nbytes)
    empty = (state.counts[:, 0] == 0) & (state.checks == 0).all(dim=1) & \
        (state.sums == 0).all(dim=1)
    success = bool(empty.all()) and not state.overflow
    return state, success
