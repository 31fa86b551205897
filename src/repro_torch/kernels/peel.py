"""Device wave-peeling decoder: kernels B and C and the wave loop.

Port of ``repro/kernels/peel.py``.  Each belief-propagation round of the
paper's peeling decoder (§3) becomes one wave of three stages, run over U
independent decode units at once (one unit for a plain decode):

1. **purity scan** — kernel B (``csrc/purity_scan.cu``) re-keys every coded
   symbol's sum with SipHash-2-4 and compares it with the stored checksum:
   ``±1`` where the symbol holds exactly one item, ``0`` elsewhere.
2. **compaction + dedupe** — each unit's first ``cap`` pure rows in
   ascending symbol order, deduped by checksum within the wave (first
   occurrence wins) and against everything the unit recovered in earlier
   waves.
3. **chain removal** — the recovered items re-derive their mapped-index
   chains with kernel A (:mod:`.map_indices`) and kernel C
   (``csrc/iblt_apply.cu``) scatters their signed delta, which is XOR-ed
   into the residual (counts subtracted).

The loop runs in Python and reads each unit's ``n_new`` on the host each
wave, as the reference's CPU path does.  Every choice that shapes the
outcome matches the reference — ``cap``, ``K``, the dedupe order, the
``max_diff`` overflow rule and the ``rounds``/``success`` semantics — so
items, their order, rounds and residual are identical.

The reference batches units with ``jax.vmap`` over its jnp engine; the
CUDA kernels have no ``vmap`` rule, so here the units lie end to end on
the symbol axis, each padded to the shared ``mp``: purity runs unchanged
over ``(U·mp, L)``, kernel A builds every chain at ``mp``, and kernel C
takes each item's unit (it scatters into that unit's block, up to the
unit's own prefix).

Where the reference dedupes with a ``cap × cap`` pairwise mask and a
``cap × D`` seen-mask (quadratic; ~10¹⁰ elements at a 160,000-symbol
prefix), this port sorts the recovered and the wave's (unit, checksum)
keys together, stably, so within a key the recovered ones come first and
then the wave's in ascending symbol order: the identical ``keep`` vector
in O((D + cap) log(D + cap)), and keyed on the unit, so two units that
recover the same item both keep it.

Kernels B and C follow the wrapper rule of :mod:`.map_indices`: the plain
torch version for CPU tensors, the kernel or an exception for CUDA tensors.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
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
               sides: torch.Tensor, unit: torch.Tensor,
               m_units: torch.Tensor, *, mp: int):
    """Signed coded-symbol delta of ``items`` over their mapped chains, for
    U decode units laid end to end (a plain decode is U = 1).

    items (n, L) int32, idxs (n, K) int32, chks (n, 2) int32, sides (n,)
    int32, unit (n,) int32 and m_units (U,) int32 -> (sums (U·mp, L),
    checks (U·mp, 2), counts (U·mp, 1)), all int32.  Item ``i`` scatters
    into block ``unit[i]`` of ``mp`` rows, where ``0 <= idx <
    m_units[unit[i]]`` (each at most ``mp``) and its side is nonzero; the
    rows past a unit's prefix stay zero.  The caller XORs sums/checks into
    its residual and *subtracts* counts.  ``iblt_apply.launches`` counts
    kernel launches.
    """
    if items.device.type == "cpu":
        return iblt_apply_ref(items, idxs, chks, sides, unit, m_units, mp=mp)
    n, L = items.shape
    K = idxs.shape[1]
    p_items = device_ptr(items, "items", torch.int32, 2)
    p_idxs = device_ptr(idxs, "idxs", torch.int32, 2)
    p_chks = device_ptr(chks, "chks", torch.int32, 2)
    p_sides = device_ptr(sides, "sides", torch.int32, 1)
    p_unit = device_ptr(unit, "unit", torch.int32, 1)
    p_m_units = device_ptr(m_units, "m_units", torch.int32, 1)
    if idxs.shape[0] != n or chks.shape != (n, 2) or sides.shape != (n,) \
            or unit.shape != (n,):
        raise ValueError("items, idxs, chks, sides and unit disagree on n")
    rows = mp * m_units.numel()
    dev = items.device
    sums = torch.zeros((rows, L), dtype=torch.int32, device=dev)
    checks = torch.zeros((rows, 2), dtype=torch.int32, device=dev)
    counts = torch.zeros((rows, 1), dtype=torch.int32, device=dev)
    if n * K == 0:
        return sums, checks, counts
    with torch.cuda.device(dev):
        rc = launcher("iblt_apply")(
            p_items, p_idxs, p_chks, p_sides, n, K, L, p_unit, p_m_units, mp,
            sums.data_ptr(), checks.data_ptr(), counts.data_ptr(),
            stream_of(items))
    check_launch("iblt_apply", rc)
    iblt_apply.launches += 1
    return sums, checks, counts


iblt_apply.launches = 0


# ---------------------------------------------------------------------------
# The wave loop over U units laid end to end.
# ---------------------------------------------------------------------------
class PeelState(NamedTuple):
    sums: torch.Tensor        # (U·mp, L) int32 — residual symbol sums
    checks: torch.Tensor      # (U·mp, 2) int32 — residual checksums (hi, lo)
    counts: torch.Tensor      # (U·mp, 1) int32 — residual signed counts
    rec_items: torch.Tensor   # (R, L) int32 — recovered source symbols
    rec_checks: torch.Tensor  # (R, 2) int32 — their checksums
    rec_sides: torch.Tensor   # (R,) int32   — +1 remote-only, -1 local
    rec_units: torch.Tensor   # (R,) int64   — the unit that recovered each
    n_rec: np.ndarray         # (U,) int64 — items recovered per unit
    overflow: np.ndarray      # (U,) bool — a wave would exceed max_diff
    rounds: int               # waves run (the same for every unit)


def _fresh(units, chk, rec_units, rec_chk) -> torch.Tensor:
    """keep[i]: key (units[i], chk[i]) is the first of its kind among the
    wave's candidates (given in ascending symbol order) and no earlier
    wave of that unit recovered it."""
    n_r = rec_chk.numel()
    u = torch.cat([rec_units, units])
    c = torch.cat([rec_chk, chk])
    _, by_chk = torch.sort(c, stable=True)
    _, by_unit = torch.sort(u[by_chk], stable=True)
    order = by_chk[by_unit]               # by (unit, chk), ties in input order
    su, sc = u[order], c[order]
    first = torch.ones_like(su, dtype=torch.bool)
    first[1:] = (su[1:] != su[:-1]) | (sc[1:] != sc[:-1])
    keep = torch.empty_like(first)
    keep[order] = first
    return keep[n_r:]


def _stage1(state: PeelState, *, mp: int, cap: int, max_diff: int, key,
            nbytes: int):
    """Purity scan + per-unit pure-row compaction + dedupe.

    Returns ``(rows, side, n_new, over)``: the flat symbol indices of this
    wave's new items in ascending order (units whose wave overflows left
    out), their sides, the new items per unit, and which units' waves would
    take them past ``max_diff``.  Pure rows beyond a unit's first ``cap``
    wait for the next wave, as in the reference; units that overflowed
    earlier stay frozen.
    """
    U = state.n_rec.shape[0]
    side = purity_scan(state.sums, state.checks, state.counts, key=key,
                       nbytes=nbytes)
    pure = (side != 0).view(U, mp)
    if state.overflow.any():
        frozen = torch.from_numpy(state.overflow).to(pure.device)
        pure &= ~frozen[:, None]
    pure &= torch.cumsum(pure, dim=1, dtype=torch.int32) <= cap
    pidx = torch.nonzero(pure.view(-1)).view(-1)
    units = pidx // mp
    keep = _fresh(units, join_u64(state.checks[pidx]), state.rec_units,
                  join_u64(state.rec_checks))
    rows, units = pidx[keep], units[keep]
    n_new = torch.bincount(units, minlength=U).cpu().numpy()
    over = state.n_rec + n_new > max_diff
    if over.any():
        rows = rows[~torch.from_numpy(over).to(rows.device)[units]]
    return rows, side[rows], n_new, over


def _stage2(state: PeelState, rows, side, m_units, *, mp: int, K: int,
            key, nbytes: int) -> PeelState:
    """Chain re-derivation + signed removal + recovered-buffer append.

    Chains are built at the shared ``mp``; the apply drops the slots past
    each unit's own prefix (a chain's entries below a bound do not depend
    on the bound).
    """
    items = state.sums[rows]
    chks = state.checks[rows]
    units = rows // mp
    idxs, _ = map_indices(items, K=K, m=mp, nbytes=nbytes, key=key)
    delta = iblt_apply(items, idxs, chks, side, units.to(torch.int32),
                       m_units, mp=mp)
    d_sums, d_checks, d_counts = delta
    return state._replace(
        sums=state.sums ^ d_sums,
        checks=state.checks ^ d_checks,
        counts=state.counts - d_counts,
        rec_items=torch.cat([state.rec_items, items]),
        rec_checks=torch.cat([state.rec_checks, chks]),
        rec_sides=torch.cat([state.rec_sides, side]),
        rec_units=torch.cat([state.rec_units, units]))


def peel_waves_batched(sums, checks, counts, *, m, nbytes: int, key,
                       max_diff: int, K: int, max_rounds: int = 10_000,
                       block_n: int = 256):
    """Iterate purity → compact/dedupe → remove to a fixed point, over U
    units at once.

    Inputs are the *padded* difference symbols of U units laid end to end
    on one device: sums (U·mp, L) int32, checks (U·mp, 2) int32, counts
    (U·mp, 1) int32, unit ``u`` at rows ``[u·mp, (u+1)·mp)`` with its rows
    past ``m[u]`` zero; ``m`` is the (U,) sequence of prefix lengths.
    Returns the final :class:`PeelState` and a (U,) bool ``success`` (the
    unit's symbols all empty and no overflow).

    A unit whose wave would take its recovered items past ``max_diff`` is
    not applied and freezes with ``overflow`` set, so the caller can fall
    back to the host decoder for that unit alone; the others go on
    peeling.  The loop ends when no unit recovers anything new.
    """
    m_np = np.asarray(m, np.int64).reshape(-1)
    U = m_np.shape[0]
    mp, L = sums.shape[0] // U, sums.shape[1]
    cap = min(2 * max(max_diff, 1), mp)
    cap = max(((cap + block_n - 1) // block_n) * block_n, block_n)
    key = tuple(key)
    dev = sums.device
    state = PeelState(
        sums=sums, checks=checks, counts=counts,
        rec_items=torch.zeros((0, L), dtype=torch.int32, device=dev),
        rec_checks=torch.zeros((0, 2), dtype=torch.int32, device=dev),
        rec_sides=torch.zeros(0, dtype=torch.int32, device=dev),
        rec_units=torch.zeros(0, dtype=torch.int64, device=dev),
        n_rec=np.zeros(U, np.int64), overflow=np.zeros(U, bool), rounds=0)
    m_units = torch.from_numpy(m_np.astype(np.int32)).to(dev)
    while state.rounds < max_rounds:
        rows, side, n_new, over = _stage1(state, mp=mp, cap=cap,
                                          max_diff=max_diff, key=key,
                                          nbytes=nbytes)
        state = state._replace(rounds=state.rounds + 1,
                               overflow=state.overflow | over)
        if rows.numel() == 0:
            break
        state = _stage2(state, rows, side, m_units, mp=mp, K=K, key=key,
                        nbytes=nbytes)
        state = state._replace(n_rec=state.n_rec + np.where(over, 0, n_new))
    empty = (state.counts[:, 0] == 0) & (state.checks == 0).all(dim=1) & \
        (state.sums == 0).all(dim=1)
    success = empty.view(U, mp).all(dim=1).cpu().numpy() & ~state.overflow
    return state, success

