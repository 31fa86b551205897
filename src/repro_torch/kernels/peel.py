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

Every shape is fixed, as in the reference's ``lax.while_loop`` form: each
unit's wave has ``cap`` candidate slots, its recovered items go into a
``max_diff``-row buffer, and the counters and the loop's condition stay on
the device.  A wave after the condition failed changes nothing and counts
no round.  So the host enqueues waves without reading anything back, and
reads the condition once a chunk of ``WAVES_PER_CHUNK`` waves
(:class:`WaveLoop`).  On the card a wave is some hundred small launches;
the loop captures it once as a CUDA graph and replays it, so one call
from the host enqueues a whole wave (``_build.CountedGraph``, which
counts each kernel's launches at every replay), and a finished loop's
graph serves the next loop of the same shape.  Every choice that shapes
the outcome matches the reference — ``cap``, ``K``, the dedupe order, the
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
in O(U (D + cap) log), and keyed on the unit, so two units that recover
the same item both keep it.  Empty slots and unused buffer rows take the
key of a unit past the last, so they match nothing.

The wave's new items are compacted to the front of its ``U·cap`` slots
(their order kept) and their number stays on the device: kernels A and C
take it as ``count`` and read it there, so they launch over the fixed
slots but work on the live ones only.  The slots past it also carry side
0, which kernel C's contract treats as contributing nothing, so the same
arrays serve a launch without ``count``.

Kernels B and C follow the wrapper rule of :mod:`.map_indices`: the plain
torch version for CPU tensors, the kernel or an exception for CUDA tensors.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.hashing import join_u64

from ._build import (CountedGraph, check_launch, count_launch, device_ptr,
                     launcher, stream_of)
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
    count_launch(purity_scan)
    return side


purity_scan.launches = 0


# ---------------------------------------------------------------------------
# Kernel C: signed scatter of a wave's recovered items.
# ---------------------------------------------------------------------------
def iblt_apply(items: torch.Tensor, idxs: torch.Tensor, chks: torch.Tensor,
               sides: torch.Tensor, unit: torch.Tensor,
               m_units: torch.Tensor, *, mp: int,
               count: torch.Tensor | None = None):
    """Signed coded-symbol delta of ``items`` over their mapped chains, for
    U decode units laid end to end (a plain decode is U = 1).

    items (n, L) int32, idxs (n, K) int32, chks (n, 2) int32, sides (n,)
    int32, unit (n,) int32 and m_units (U,) int32 -> (sums (U·mp, L),
    checks (U·mp, 2), counts (U·mp, 1)), all int32.  Item ``i`` scatters
    into block ``unit[i]`` of ``mp`` rows, where ``0 <= idx <
    m_units[unit[i]]`` (each at most ``mp``) and its side is nonzero; the
    rows past a unit's prefix stay zero.  The caller XORs sums/checks into
    its residual and *subtracts* counts.  ``count``, a (1,) int64 tensor
    beside the items, limits the work to the first ``count`` items; the
    kernel reads it on the card.  ``iblt_apply.launches`` counts kernel
    launches.
    """
    if items.device.type == "cpu":
        return iblt_apply_ref(items, idxs, chks, sides, unit, m_units, mp=mp,
                              count=count)
    n, L = items.shape
    K = idxs.shape[1]
    p_items = device_ptr(items, "items", torch.int32, 2)
    p_idxs = device_ptr(idxs, "idxs", torch.int32, 2)
    p_chks = device_ptr(chks, "chks", torch.int32, 2)
    p_sides = device_ptr(sides, "sides", torch.int32, 1)
    p_unit = device_ptr(unit, "unit", torch.int32, 1)
    p_m_units = device_ptr(m_units, "m_units", torch.int32, 1)
    p_count = None if count is None else device_ptr(count, "count",
                                                    torch.int64, 1)
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
            sums.data_ptr(), checks.data_ptr(), counts.data_ptr(), p_count,
            stream_of(items))
    check_launch("iblt_apply", rc)
    count_launch(iblt_apply)
    return sums, checks, counts


iblt_apply.launches = 0


# ---------------------------------------------------------------------------
# The wave loop over U units laid end to end.
# ---------------------------------------------------------------------------
# Waves enqueued between two reads of the stop flag.  Each wave past the
# loop's end is a whole wave of work on the card, and a read of a flag
# costs less: one wave a read was the fastest on every decode path
# measured (experiments/wave_chunks.py; PERF.md).
WAVES_PER_CHUNK = 1
# Devices on which a wave already ran op by op, so every kernel it
# launches is loaded and a wave can be captured as a CUDA graph.
_loaded_on: set = set()


class PeelState(NamedTuple):
    """The loop's state, every leaf a tensor of fixed shape on the device.

    Unit u's recovered items are rows ``[u·D, u·D + n_rec[u])`` of the
    ``rec_*`` buffers, in recovery order; the ``U·cap`` rows past ``U·D``
    take the writes of the slots a wave drops, one row a slot, so no two
    writes meet on one address.
    """
    sums: torch.Tensor        # (U·mp, L) int32 — residual symbol sums
    checks: torch.Tensor      # (U·mp, 2) int32 — residual checksums (hi, lo)
    counts: torch.Tensor      # (U·mp, 1) int32 — residual signed counts
    rec_items: torch.Tensor   # (U·D + U·cap, L) int32 — recovered symbols
    rec_checks: torch.Tensor  # (U·D + U·cap, 2) int32 — their checksums
    rec_sides: torch.Tensor   # (U·D + U·cap,) int32 — +1 remote-only, -1
    n_rec: torch.Tensor       # (U,) int64 — items recovered per unit
    overflow: torch.Tensor    # (U,) bool — a wave would exceed max_diff
    rounds: torch.Tensor      # () int64 — waves run while ``live``
    live: torch.Tensor        # () bool — the loop's condition


class Wave(NamedTuple):
    """One wave's new items, compacted to the front of ``U·cap`` slots in
    ascending symbol order (so unit by unit); ``count`` of them are live,
    the slots past it read the last row and carry side 0."""
    rows: torch.Tensor        # (U·cap,) int64 — flat symbol row of the item
    items: torch.Tensor       # (U·cap, L) int32
    chks: torch.Tensor        # (U·cap, 2) int32
    sides: torch.Tensor       # (U·cap,) int32
    unit: torch.Tensor        # (U·cap,) int32 — the item's unit
    dest: torch.Tensor        # (U·cap,) int64 — its row in the rec_* buffers
    count: torch.Tensor       # (1,) int64 — live items
    n_new: torch.Tensor       # (U,) int64 — new items per unit
    over: torch.Tensor        # (U,) bool — they would pass max_diff


class _Program(NamedTuple):
    """What a wave loop's CUDA graph reads and writes, kept for the next
    loop of the same shape: its state, index constants and unit prefixes,
    and the graph of one wave over them."""
    state: PeelState
    consts: tuple              # rec_unit, rec_pos, slot_ids, row_ids
    m_units: torch.Tensor
    graph: CountedGraph


class _Programs:
    """The wave graphs of one card.

    Every wave graph captured while ``stream`` is current is captured into
    one memory pool, so a capture takes the memory earlier captures left
    instead of new allocations (each a ``cudaMalloc`` during the capture).
    Graphs in the pool may write the same temporaries; that is safe because
    a wave writes each temporary before it reads it and every replay runs
    on ``stream``, so no two replays overlap.  A small graph captured at
    first use and kept holds the pool open.  The programs of finished loops
    wait here by shape, at most ``KEEP``, the least recently used dropped
    first; a loop of the same shape takes one and skips its capture.
    """

    KEEP = 16

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.current_stream(device)
        self.pool = torch.cuda.graph_pool_handle()
        self._anchor = CountedGraph(lambda: torch.zeros(1, device=device),
                                    device, pool=self.pool)
        self._free: list = []          # (shape, _Program), oldest first

    def shares(self, stream) -> bool:
        return stream.cuda_stream == self.stream.cuda_stream

    def capture(self, fn) -> CountedGraph:
        return CountedGraph(fn, self.device, pool=self.pool)

    def take(self, shape):
        for i, (s, prog) in enumerate(self._free):
            if s == shape:
                del self._free[i]
                return prog
        return None

    def put(self, shape, prog: _Program) -> None:
        self._free.append((shape, prog))
        del self._free[:-self.KEEP]


_programs: dict = {}


def _to_host(tensors) -> list[np.ndarray]:
    """Copy ``tensors`` to the host; on the card through pinned memory,
    behind one wait for the stream."""
    if not tensors or tensors[0].device.type != "cuda":
        return [t.numpy() for t in tensors]
    out = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
           for t in tensors]
    for o, t in zip(out, tensors):
        o.copy_(t, non_blocking=True)
    torch.cuda.current_stream(tensors[0].device).synchronize()
    return [o.numpy() for o in out]


def read_back(*tensors) -> list[np.ndarray]:
    """Copy ``tensors`` to the host after one wait for the card's queued
    work: the only place the wave loop waits for the device.
    ``read_back.count`` counts the waits, beside the kernels'
    ``.launches``."""
    read_back.count += 1
    return _to_host(tensors)


read_back.count = 0


def upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """numpy -> tensor on ``device`` without a host wait: through pinned
    memory and an asynchronous copy on the card."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def _fresh(units, chk, valid, rec_units, rec_chk, live, U: int):
    """keep[i]: candidate i is valid, and its key (units[i], chk[i]) is the
    first of its kind among the wave's valid candidates (given in ascending
    symbol order) and among the live recovered ones."""
    u = torch.cat([torch.where(live, rec_units, U),
                   torch.where(valid, units, U)])
    c = torch.cat([rec_chk, chk])
    _, by_chk = torch.sort(c, stable=True)
    _, by_unit = torch.sort(u[by_chk], stable=True)
    order = by_chk[by_unit]               # by (unit, chk), ties in input order
    su, sc = u[order], c[order]
    first = torch.ones_like(su, dtype=torch.bool)
    first[1:] = (su[1:] != su[:-1]) | (sc[1:] != sc[:-1])
    keep = torch.empty_like(first)
    keep[order] = first
    return keep[rec_chk.numel():] & valid


class WaveLoop:
    """The wave decode of U units laid end to end on one device.

    Inputs are the *padded* difference symbols: sums (U·mp, L) int32,
    checks (U·mp, 2) int32, counts (U·mp, 1) int32, unit ``u`` at rows
    ``[u·mp, (u+1)·mp)`` with its rows past ``m[u]`` zero; ``m`` is the
    (U,) sequence of prefix lengths; the loop updates the three tensors in
    place.  :meth:`step` enqueues ``WAVES_PER_CHUNK`` waves (as it was
    when the loop was made) and reads nothing back; :meth:`running` reads
    the stop flag (one :func:`read_back`); :meth:`finish` reads the
    outcome (one more).  On the card every wave is a replay of a CUDA
    graph of one wave, captured at the first (or kept from an earlier
    loop of the same shape); on the CPU the waves run op by op.

    A unit whose wave would take its recovered items past ``max_diff`` is
    not applied and freezes with ``overflow`` set, so the caller can fall
    back to the host decoder for that unit alone; the others go on
    peeling.  The loop ends after the first wave in which no unit recovers
    anything new, or at ``max_rounds`` waves.
    """

    def __init__(self, sums, checks, counts, m, *, nbytes: int, key,
                 max_diff: int, K: int, max_rounds: int = 10_000,
                 block_n: int = 256):
        m_np = np.asarray(m, np.int64).reshape(-1)
        U = m_np.shape[0]
        mp, L = sums.shape[0] // U, sums.shape[1]
        cap = min(2 * max(max_diff, 1), mp)
        self.cap = max(((cap + block_n - 1) // block_n) * block_n, block_n)
        self.U, self.mp, self.D, self.K = U, mp, max_diff, K
        self.key, self.nbytes = tuple(key), nbytes
        dev = sums.device
        self.max_rounds = max_rounds
        self.chunk = WAVES_PER_CHUNK
        self.reads, self.enqueued, self.done = 0, 0, False
        self._graph = self._programs = None
        self._shape = (U, mp, L, max_diff, self.cap, K, nbytes, self.key,
                       max_rounds)
        if dev.type == "cuda":
            self._stream = torch.cuda.current_stream(dev)
            progs = _programs.get(dev)
            if progs is None:
                progs = _programs[dev] = _Programs(dev)
            if progs.shares(self._stream):
                self._programs = progs
                prog = progs.take(self._shape)
                if prog is not None:
                    self._adopt(prog, sums, checks, counts, m_np)
                    return
        self.rec_unit = torch.arange(U * max_diff, device=dev) // max_diff
        self.rec_pos = torch.arange(max_diff, device=dev)
        self.slot_ids = torch.arange(U * self.cap, device=dev)
        self.row_ids = torch.arange(U * mp, device=dev)
        self.m_units = upload(m_np.astype(np.int32), dev)
        D1 = U * max_diff + U * self.cap
        self.state = PeelState(
            sums=sums, checks=checks, counts=counts,
            rec_items=torch.zeros((D1, L), dtype=torch.int32, device=dev),
            rec_checks=torch.zeros((D1, 2), dtype=torch.int32, device=dev),
            rec_sides=torch.zeros(D1, dtype=torch.int32, device=dev),
            n_rec=torch.zeros(U, dtype=torch.int64, device=dev),
            overflow=torch.zeros(U, dtype=torch.bool, device=dev),
            rounds=torch.zeros((), dtype=torch.int64, device=dev),
            live=torch.full((), max_rounds > 0, dtype=torch.bool,
                            device=dev))

    def _adopt(self, prog: _Program, sums, checks, counts, m_np) -> None:
        """Run on a kept program: the inputs copied into its state, the
        counters reset (the recovered rows past ``n_rec`` are never
        read)."""
        st = prog.state
        st.sums.copy_(sums)
        st.checks.copy_(checks)
        st.counts.copy_(counts)
        st.n_rec.zero_()
        st.overflow.zero_()
        st.rounds.zero_()
        st.live.fill_(self.max_rounds > 0)
        prog.m_units.copy_(upload(m_np.astype(np.int32), st.sums.device))
        self.state, self.m_units, self._graph = st, prog.m_units, prog.graph
        self.rec_unit, self.rec_pos, self.slot_ids, self.row_ids = \
            prog.consts

    # -- one wave -------------------------------------------------------
    def _compact(self, mask: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        """(U·cap,) positions of the set entries of ``mask`` (``ids`` is
        ``arange(mask.numel())``) in order, the slots past them
        ``mask.numel()``: a cumsum and a scatter (the unset entries land on
        rows of their own past the slots)."""
        n = self.U * self.cap
        pos = torch.where(mask, torch.cumsum(mask, dim=0) - 1, n + ids)
        out = torch.full((n + mask.numel(),), mask.numel(),
                         dtype=torch.int64, device=mask.device)
        out.scatter_(0, pos, ids)
        return out[:n]

    def _stage1(self, state: PeelState) -> Wave:
        """Purity scan, each unit's first ``cap`` pure rows as candidates,
        dedupe, the ``max_diff`` test, and the new items compacted.  Frozen
        units, and every unit once the loop's condition failed, offer no
        candidate."""
        U, mp, D = self.U, self.mp, self.D
        side = purity_scan(state.sums, state.checks, state.counts,
                           key=self.key, nbytes=self.nbytes)
        pure = (side != 0).view(U, mp) & ~state.overflow[:, None] & state.live
        pure &= torch.cumsum(pure, dim=1) <= self.cap
        ends = torch.cumsum(pure.sum(dim=1), dim=0)  # each unit's last + 1
        cand = self._compact(pure.view(-1), self.row_ids)  # unit by unit
        valid = cand < U * mp
        rows = cand.clamp(max=U * mp - 1)
        unit = rows // mp
        chks = state.checks[rows]
        live_rec = (self.rec_pos < state.n_rec[:, None]).view(-1)
        keep = _fresh(unit, join_u64(chks), valid, self.rec_unit,
                      join_u64(state.rec_checks[:U * D]), live_rec, U)
        upto = torch.cat([keep.new_zeros(1, dtype=torch.int64),
                          torch.cumsum(keep, dim=0)])   # kept before each
        n_new = upto[ends] - upto[torch.cat([ends.new_zeros(1), ends[:-1]])]
        over = state.n_rec + n_new > D
        keep &= ~over[unit]
        sel = self._compact(keep, self.slot_ids)
        live = sel < keep.numel()
        sel = sel.clamp(max=keep.numel() - 1)
        rows, unit, chks = rows[sel], unit[sel], chks[sel]
        kept = torch.where(over, 0, n_new)
        first = torch.cumsum(kept, dim=0) - kept     # each unit's first slot
        dest = unit * D + state.n_rec[unit] + self.slot_ids - first[unit]
        return Wave(rows, state.sums[rows], chks,
                    torch.where(live, side[rows], 0), unit.to(torch.int32),
                    torch.where(live, dest, U * D + self.slot_ids),
                    keep.sum().view(1), n_new, over)

    def _stage2(self, state: PeelState, wave: Wave) -> PeelState:
        """Chain re-derivation, signed removal, the new items written at
        each unit's ``n_rec``, and the counters, all in ``state``'s own
        tensors (returned).

        Chains are built at the shared ``mp``; the apply drops the slots
        past each unit's own prefix (a chain's entries below a bound do not
        depend on the bound).
        """
        idxs, _ = map_indices(wave.items, K=self.K, m=self.mp,
                              nbytes=self.nbytes, key=self.key,
                              count=wave.count)
        d_sums, d_checks, d_counts = iblt_apply(
            wave.items, idxs, wave.chks, wave.sides, wave.unit, self.m_units,
            mp=self.mp, count=wave.count)
        state.rec_items.index_copy_(0, wave.dest, wave.items)
        state.rec_checks.index_copy_(0, wave.dest, wave.chks)
        state.rec_sides.index_copy_(0, wave.dest, wave.sides)
        changed = (wave.n_new > 0) & ~wave.over
        state.sums.bitwise_xor_(d_sums)
        state.checks.bitwise_xor_(d_checks)
        state.counts.sub_(d_counts)
        state.n_rec.add_(torch.where(wave.over, 0, wave.n_new))
        state.overflow.logical_or_(wave.over)
        state.rounds.add_(state.live)
        torch.logical_and(changed.any(), state.rounds < self.max_rounds,
                          out=state.live)
        return state

    def _wave(self) -> Wave:
        """Enqueue one wave op by op."""
        wave = self._stage1(self.state)
        self._stage2(self.state, wave)
        return wave

    # -- the host's side ------------------------------------------------
    def _next_wave(self) -> None:
        """Enqueue one wave.  On the card the loop captures its wave once
        as a CUDA graph and replays it, one call from the host a wave; the
        process's first wave on a card runs op by op, so every kernel is
        loaded before anything is captured."""
        dev = self.state.sums.device
        if self._graph is None and dev.type == "cuda":
            if dev not in _loaded_on:
                self._wave()
                _loaded_on.add(dev)
                return
            self._graph = (self._programs.capture(self._wave)
                           if self._programs is not None
                           else CountedGraph(self._wave, dev))
        if self._graph is None:
            self._wave()
            return
        with torch.cuda.stream(self._stream):
            self._graph.replay()

    def step(self, waves: int | None = None) -> None:
        """Enqueue ``waves`` waves (default ``chunk``); nothing is read
        back."""
        waves = self.chunk if waves is None else waves
        for _ in range(waves):
            self._next_wave()
        self.enqueued += waves

    def running(self) -> bool:
        """Whether the loop's condition still holds after the waves
        enqueued so far: one read of the flag, until it reads False."""
        if not self.done:
            self.reads += 1
            self.done = not bool(read_back(self.state.live)[0])
        return not self.done

    def run(self) -> "WaveLoop":
        """Drive the loop to its end: ceil(waves / chunk) reads."""
        self.step()
        while self.running():
            self.step()
        return self

    def success(self) -> torch.Tensor:
        """(U,) bool: the unit's symbols all empty and no overflow."""
        st = self.state
        empty = (st.counts[:, 0] == 0) & (st.checks == 0).all(dim=1) & \
            (st.sums == 0).all(dim=1)
        return empty.view(self.U, self.mp).all(dim=1) & ~st.overflow

    def finish(self) -> dict:
        """The outcome on the host (numpy arrays), after one wait: the
        residual, each unit's recovered rows, and the flags."""
        st, D = self.state, self.D
        self.reads += 1
        UD = self.U * D
        (n_rec, overflow, success, rounds, sums, checks, counts, items,
         chks, sides) = read_back(
            st.n_rec, st.overflow, self.success(), st.rounds, st.sums,
            st.checks, st.counts, st.rec_items[:UD], st.rec_checks[:UD],
            st.rec_sides[:UD])
        rows = np.concatenate([np.arange(u * D, u * D + n)
                               for u, n in enumerate(n_rec)])
        if self._graph is not None and self._programs is not None:
            self._programs.put(self._shape, _Program(
                st, (self.rec_unit, self.rec_pos, self.slot_ids,
                     self.row_ids), self.m_units, self._graph))
            self.state = None       # the next loop of this shape owns it
        self._graph = None
        return dict(sums=sums, checks=checks, counts=counts,
                    rec_items=items[rows], rec_checks=chks[rows],
                    rec_sides=sides[rows], n_rec=n_rec, overflow=overflow,
                    success=success, rounds=rounds)
