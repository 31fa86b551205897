"""Reconciliation engine — one event-driven core serving N concurrent peers.

Port of ``repro/protocol/engine.py``.  The engine restates reconciliation
as an event loop with an explicit **plan/execute split**:

* **plan** — each tick, pending work from every registered peer is
  collected into a :class:`DecodePlan` of ``(peer, shard, window)``
  :class:`DecodeUnit`\\ s and coalesced by *shape bucket* (tile-padded
  prefix length, item geometry, session key, ``max_diff`` bound, device);
* **execute** — each bucket becomes ONE
  :func:`repro_torch.kernels.ops.decode_device_batched` call: the units lie
  end to end on the symbol axis and one wave loop peels them all, each
  wave one launch of each CUDA kernel whatever the number of units — so
  8 peers × 4 shards at the same pacing is still one batched decode per
  tick.  A lone plain session in sync mode takes
  :func:`~repro_torch.kernels.ops.decode_device` instead, as in the
  reference;
* **double-buffering** — with ``pipeline=True`` (the default) the engine
  dispatches tick t's buckets (:class:`PendingRound`), absorbs tick t+1's
  frames and computes the next window requests from the stateless pacing
  policies, and only then reads tick t's results.  Decode results merge
  *behind* the newly absorbed symbols
  (:meth:`repro_torch.core.stream.StreamDecoder.merge_device_result` is
  tail-aware), and ``decoded_at`` is pinned to the prefix length the
  successful decode actually covered, so pipelining never inflates the
  reported overhead.  The wave loop keeps its stop test on the card and
  enqueues a wave as one CUDA graph replay, and the dispatch returns
  without reading anything back, so the waves it enqueued run while the
  host ingests; each poll enqueues more.  The decode's later waves still
  run inside the final read-back, so only part of it overlaps ingest;
  ``PERF.md`` records the measured share.

``Session`` and ``ShardedSession`` are thin single-peer wrappers over this
module.  A unit whose device decode overflows ``max_diff`` falls back to
the exact host peel and is **pinned to the host** from then on; every
window such a unit peels on the host is counted in its decoder's
``host_fallbacks``.

Pull protocol, multi-peer::

    engine = ReconcileEngine()
    for stream, session in peers:
        engine.register(stream, session, wire=True)
    reports = engine.run()

:func:`~repro_torch.protocol.session.run_session` /
:func:`~repro_torch.protocol.sharded.run_sharded_session` delegate their
single pair to a non-pipelined engine, which reproduces the serial
request → offer → decode lockstep exactly.
"""
from __future__ import annotations

from typing import NamedTuple

from repro_torch.core.decoder import resolve_backend, resolve_device
from repro_torch.core.stream import StreamDecoder
from repro_torch.core.wire import decode_frames, decode_shard_frames


class ProtocolError(RuntimeError):
    """A window arrived out of order / with inconsistent geometry."""


# ---------------------------------------------------------------------------
# Peer state: decode units + pacing + accounting, shared by every wrapper.
# ---------------------------------------------------------------------------
class UnitState:
    """One (peer, shard) decode unit: an incremental decoder plus its
    protocol bookkeeping.  ``pinned_host`` is set the first time a device
    decode of this unit overflows ``max_diff`` — from then on the unit
    peels on the host even if the peer's backend is (re)set to device."""

    __slots__ = ("shard", "decoder", "remote_items", "pinned_host")

    def __init__(self, shard: int, decoder: StreamDecoder):
        self.shard = shard
        self.decoder = decoder
        self.remote_items: int | None = None
        self.pinned_host = False


class PeerState:
    """Everything the engine knows about one registered peer.

    Owns the per-shard :class:`UnitState`\\ s (a plain session is the
    S=1 special case), the pacing policy, the backend / device /
    ``max_diff`` decode configuration, and the wire accounting.  Wrappers keep a ``PeerState``
    as their single source of truth; a :class:`ReconcileEngine` drives any
    number of them through one shared plan/execute loop.
    """

    def __init__(self, *, nbytes: int, key, locals_, pacing, max_m: int,
                 backend: str, max_diff: int | None, sharded: bool,
                 device="cuda"):
        self.nbytes = nbytes
        self.key = tuple(key)
        self.pacing = pacing
        self.max_m = max_m
        self.max_diff = max_diff
        self.sharded = sharded
        self.bytes_received = 0
        self.grow_steps = 0
        # the ENGINE owns decode dispatch (plan/execute), so the decoders
        # never self-dispatch here; their backend/max_diff are still kept
        # in sync so a decoder used directly (decoder.receive) behaves
        # like the session that owns it
        self.units = [
            UnitState(s, StreamDecoder(nbytes, local=loc, key=key,
                                       backend=backend, max_diff=max_diff,
                                       device=device))
            for s, loc in enumerate(locals_)]
        self.backend = self.units[0].decoder.backend
        self.device = self.units[0].decoder.device

    @property
    def n_units(self) -> int:
        return len(self.units)

    @property
    def decoded(self) -> bool:
        """True once every unit hit its ρ(0)=1 termination signal."""
        return all(u.decoder.decoded for u in self.units)

    @property
    def symbols_received(self) -> int:
        return sum(u.decoder.symbols_received for u in self.units)

    @property
    def host_fallbacks(self) -> int:
        """Windows peeled on the host although the backend is "device"."""
        return sum(u.decoder.host_fallbacks for u in self.units)

    def set_backend(self, backend: str) -> None:
        backend = resolve_backend(backend)
        if backend == "device":
            self.device = resolve_device(self.device)
        self.backend = backend
        for u in self.units:
            u.decoder.backend = backend
            u.decoder.device = self.device

    def requests(self, strict: bool = True) -> list[tuple[int, int, int]]:
        """Next window ``(shard, lo, hi)`` per still-undecoded unit.

        Window sizes come from the stateless pacing policy applied to each
        unit's own progress, clamped to ``max_m``.  A unit at ``max_m``
        without a decode signal raises ``RuntimeError`` (diverging
        reconciliation) — unless ``strict=False``, where it is skipped so
        a pipelined engine can defer the verdict until the unit's
        in-flight decode result lands.
        """
        reqs = []
        for u in self.units:
            if u.decoder.decoded:
                continue
            lo = u.decoder.symbols_received
            if lo >= self.max_m:
                if not strict:
                    continue
                what = f"shard {u.shard}" if self.sharded else \
                    "reconciliation"
                raise RuntimeError(f"{what} did not converge within "
                                   f"{self.max_m} symbols")
            reqs.append((u.shard, *self.pacing.next_window(lo, self.max_m)))
        return reqs


class DecodeUnit(NamedTuple):
    """One tick's pending work for one (peer, shard): the unit absorbed a
    window and rows ``[old, m)`` of its residual await peeling."""
    peer: PeerState
    unit: UnitState
    old: int
    m: int


# ---------------------------------------------------------------------------
# Ingest: validate + absorb (no peeling — that is the execute phase's job).
# ---------------------------------------------------------------------------
def validate_round(peer: PeerState, windows) -> list:
    """Check one round of ``(shard, symbols, start)`` windows against the
    peer's positions without mutating anything.

    Validation is all-or-nothing: every window is checked (shard id,
    order, geometry) before ANY state mutates, so a rejected round can be
    corrected and retried without losing symbols.  Overlap with already-
    consumed symbols is trimmed, wholly stale windows are dropped; a round
    may carry several windows for one unit, each validated against the
    position the previous ones will leave behind.  Returns the accepted
    ``(unit, symbols)`` list in arrival order.
    """
    have = {}
    accepted = []
    for shard_id, sym, start in windows:
        if not 0 <= shard_id < peer.n_units:
            raise ProtocolError(f"shard_id {shard_id} outside "
                                f"[0, {peer.n_units})")
        unit = peer.units[shard_id]
        pos = have.setdefault(shard_id, unit.decoder.symbols_received)
        if start > pos:
            where = f"shard {shard_id} gap" if peer.sharded else "gap"
            raise ProtocolError(f"{where}: expected window at {pos}, "
                                f"got {start}")
        if sym.nbytes != peer.nbytes:
            raise ProtocolError(f"geometry mismatch: ℓ={sym.nbytes}, "
                                f"session ℓ={peer.nbytes}")
        if start < pos:
            if start + sym.m <= pos:
                continue                      # wholly stale window
            sym = sym.window(pos - start)
        have[shard_id] = pos + sym.m
        accepted.append((unit, sym))
    return accepted


def absorb_round(peer: PeerState, windows) -> list[DecodeUnit]:
    """Validate and ingest one round of windows; return the decode units.

    Each touched unit absorbs all of its windows (local-symbol
    subtraction, chain extension of already-recovered items — see
    :meth:`repro_torch.core.stream.StreamDecoder.absorb`) and contributes ONE
    :class:`DecodeUnit` covering everything it absorbed this round.  Units
    that terminate on absorb alone (a d=0 unit subtracts to an all-empty
    residual) are marked decoded immediately and excluded, so an identical
    peer never occupies a decode slot or stalls its neighbours.
    """
    accepted = validate_round(peer, windows)
    if not accepted:
        return []
    spans: dict[int, DecodeUnit] = {}
    for unit, sym in accepted:
        old, m = unit.decoder.absorb(sym)
        prev = spans.get(unit.shard)
        spans[unit.shard] = DecodeUnit(peer, unit,
                                       prev.old if prev else old, m)
    peer.grow_steps += 1
    out = []
    for du in spans.values():
        if du.unit.decoder.mark_decoded(at=du.m):
            continue                          # settled on absorb alone
        out.append(du)
    return out


def ingest_frames(peer: PeerState, data: bytes) -> list[DecodeUnit]:
    """Absorb one self-describing wire frame (plain, single-unit peers)."""
    sym, n_items, start = decode_frames(data)
    peer.bytes_received += len(data)
    peer.units[0].remote_items = n_items
    return absorb_round(peer, [(0, sym, start)])


def ingest_payload(peer: PeerState, data: bytes) -> list[DecodeUnit]:
    """Absorb one merged shard payload (sharded peers)."""
    n_shards, frames = decode_shard_frames(data)
    if n_shards != peer.n_units:
        raise ProtocolError(f"partition mismatch: payload has {n_shards} "
                            f"shards, session {peer.n_units}")
    peer.bytes_received += len(data)
    windows = []
    for shard_id, sym, n_items, start in frames:
        if 0 <= shard_id < peer.n_units:
            peer.units[shard_id].remote_items = n_items
        windows.append((shard_id, sym, start))
    return absorb_round(peer, windows)


# ---------------------------------------------------------------------------
# Plan: bucket pending units by shape; Execute: one dispatch per bucket.
# ---------------------------------------------------------------------------
class DecodePlan:
    """One tick's decode work, split by engine and shape.

    ``host`` units peel on the exact numpy engine; ``buckets`` maps a
    shape key — ``(mp, L, nbytes, key, max_diff, device)`` with ``mp`` the
    tile-padded prefix length — to the units that batch into one
    :func:`repro_torch.kernels.ops.decode_device_batched` call.  Units of
    different peers land in the same bucket whenever their shapes agree
    (the common case for peers on the same pacing schedule), which is what
    makes the engine's device cost per tick O(#buckets), not O(#peers).
    """

    def __init__(self, host: list[DecodeUnit],
                 buckets: dict[tuple, list[DecodeUnit]]):
        self.host = host
        self.buckets = buckets


def build_plan(units: list[DecodeUnit], block_m: int = 256) -> DecodePlan:
    """Split pending units into host work and per-shape device buckets."""
    host, buckets = [], {}
    for du in units:
        if du.peer.backend != "device" or du.unit.pinned_host:
            host.append(du)
            continue
        mp = ((du.m + block_m - 1) // block_m) * block_m
        D = mp if du.peer.max_diff is None else max(int(du.peer.max_diff), 1)
        key = (mp, du.unit.decoder.work.L, du.peer.nbytes, du.peer.key, D,
               du.peer.device)
        buckets.setdefault(key, []).append(du)
    return DecodePlan(host, buckets)


class PendingRound:
    """In-flight device work for one tick: one pending batched decode per
    shape bucket.  ``poll()`` is non-blocking; :meth:`finish` materializes
    results, merges them into the decoders (tail-aware, so symbols
    absorbed *after* dispatch survive), applies the per-unit host fallback
    on overflow — pinning the unit to the host and counting a host
    fallback — and records each unit's termination signal at the prefix
    length the decode covered."""

    def __init__(self, dispatches: list):
        self._dispatches = dispatches      # [(units, PendingBatchedDecode)]
        self.n_dispatches = len(dispatches)

    def poll(self) -> bool:
        """True once every bucket's device result is ready (non-blocking;
        every bucket is polled, so each enqueues its next chunk)."""
        return all([pending.ready() for _, pending in self._dispatches])

    def finish(self) -> None:
        for units, pending in self._dispatches:
            for du, res in zip(units, pending.wait()):
                if res.overflow:
                    du.unit.pinned_host = True
                    du.unit.decoder.host_fallbacks += 1
                    du.unit.decoder.peel_window(du.old, du.m)
                else:
                    du.unit.decoder.merge_device_result(res)
                du.unit.decoder.mark_decoded(at=du.m)


def _next_pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def execute_round(units: list[DecodeUnit], block_m: int = 256,
                  pipeline: bool = False) -> PendingRound:
    """Decode one tick's absorbed units: host units peel immediately, each
    device bucket becomes one batched dispatch.  With ``pipeline=False``
    each bucket is decoded synchronously
    (:func:`repro_torch.kernels.ops.decode_device_batched`) and the round
    is finished before returning; with ``pipeline=True`` each bucket is a
    :func:`~repro_torch.kernels.ops.decode_device_batched_start` dispatch
    whose results are read back only when the caller calls ``finish()``,
    after it has absorbed the next tick's frames.

    The unit axis is padded to the next power of two (``pad_units``), the
    reference's contract.  A lone plain session in sync mode skips the
    batch and takes :func:`~repro_torch.kernels.ops.decode_device`, as in
    the reference.  A device-backend unit pinned to the host counts a host
    fallback for every window it peels there."""
    from repro_torch.kernels import ops
    plan = build_plan(units, block_m)
    for du in plan.host:
        if du.peer.backend == "device":
            du.unit.decoder.host_fallbacks += 1
        du.unit.decoder.peel_window(du.old, du.m)
        du.unit.decoder.mark_decoded(at=du.m)
    dispatches = []
    for (mp, L, nbytes, key, D, device), us in plan.buckets.items():
        works = [du.unit.decoder.work for du in us]
        if pipeline:
            pending = ops.decode_device_batched_start(
                works, nbytes=nbytes, key=key, max_diff=D, block_m=block_m,
                pad_units=_next_pow2(len(us)), device=device)
        elif len(us) == 1 and not us[0].peer.sharded:
            pending = ops.PendingBatchedDecode(
                None, (), nbytes, results=[ops.decode_device(
                    *ops.host_symbols_to_device(works[0], device),
                    nbytes=nbytes, key=key, max_diff=us[0].peer.max_diff,
                    block_m=block_m, device=device)])
        else:
            pending = ops.PendingBatchedDecode(
                None, (), nbytes, results=ops.decode_device_batched(
                    works, nbytes=nbytes, key=key, max_diff=D,
                    block_m=block_m, pad_units=_next_pow2(len(us)),
                    device=device))
        dispatches.append((us, pending))
    round_ = PendingRound(dispatches)
    if not pipeline:
        round_.finish()
    return round_


def offer_round(peer: PeerState, windows) -> bool:
    """The wrappers' push-style entry: absorb one round of in-process
    windows and decode it synchronously.  Returns ``decoded``."""
    execute_round(absorb_round(peer, windows))
    return peer.decoded


# ---------------------------------------------------------------------------
# The engine: N peers, one tick loop.
# ---------------------------------------------------------------------------
class _Registered(NamedTuple):
    stream: object      # SymbolStream | ShardedStream
    session: object     # Session | ShardedSession
    peer: PeerState
    wire: bool


class ReconcileEngine:
    """Drive any number of (stream, session) pairs through one shared
    plan/execute loop.

    Parameters
    ----------
    pipeline: overlap device decode with host ingest (double-buffering).
        While tick t's buckets peel on the device, the engine already
        fetches and absorbs tick t+1's frames — speculatively, from the
        stateless pacing policies — and only then blocks on tick t's
        results.  Peers whose decode lands keep their speculative window
        as ordinary pacing overshoot (``symbols_received`` grows,
        ``symbols_used`` does not — the termination point is pinned to the
        decoded prefix).  ``False`` reproduces the serial lockstep
        request → offer → decode trajectory exactly;
        :func:`~repro_torch.protocol.session.run_session` uses that mode.
        A batched dispatch enqueues its first chunk of waves and returns
        without reading the card back
        (:class:`~repro_torch.kernels.ops.PendingBatchedDecode`); between
        peers the speculative gather polls the round, which enqueues more
        waves of a decode that has not converged.  The waves left at
        the read-back run while the host waits (PERF.md: the measured
        hidden share).
    block_m: device tile size — the shape-bucket quantum.

    ``ticks`` counts plan/execute rounds, ``dispatches`` the batched
    device programs issued; with N peers on one pacing schedule
    ``dispatches == ticks`` regardless of N.
    """

    def __init__(self, *, pipeline: bool = True, block_m: int = 256):
        self.pipeline = pipeline
        self.block_m = block_m
        self.ticks = 0
        self.dispatches = 0
        self._peers: list[_Registered] = []

    # -- registration -------------------------------------------------------
    def register(self, stream, session, *, wire: bool = True) -> int:
        """Attach one (stream, session) pair; returns its index.

        ``session`` is an ordinary
        :class:`~repro_torch.protocol.session.Session` or
        :class:`~repro_torch.protocol.sharded.ShardedSession` — the engine
        adopts its :class:`PeerState`, so a session driven to completion
        here reports through its own ``report()`` exactly as if it had
        been driven by its own wrapper loop.  Sharded pairs must agree on
        the partition up front (mixed shard counts would silently
        mis-reconcile in-process).
        """
        peer = session._peer
        n_shards = getattr(stream, "n_shards", None)
        if peer.sharded:
            if n_shards != peer.n_units:
                raise ProtocolError(
                    f"partition mismatch: stream has {n_shards} shards, "
                    f"session {peer.n_units}")
        elif n_shards is not None:
            raise ProtocolError("plain Session registered against a "
                                "ShardedStream; use ShardedSession")
        self._peers.append(_Registered(stream, session, peer, wire))
        return len(self._peers) - 1

    # -- ingest (request + fetch + absorb, no decode) -----------------------
    def _gather_one(self, entry: _Registered,
                    strict: bool = True) -> list[DecodeUnit]:
        reqs = entry.peer.requests(strict=strict)
        if not reqs:
            return []
        if entry.peer.sharded:
            if entry.wire:
                return ingest_payload(entry.peer, entry.stream.payload(reqs))
            windows = [(s, entry.stream.window(s, lo, hi), lo)
                       for s, lo, hi in reqs]
            return absorb_round(entry.peer, windows)
        ((_, lo, hi),) = reqs
        if entry.wire:
            return ingest_frames(entry.peer, entry.stream.frames(lo, hi))
        return absorb_round(entry.peer, [(0, entry.stream.window(lo, hi), lo)])

    def _gather(self, strict: bool = True, poll=None) -> list[DecodeUnit]:
        """Ingest one round of every live peer; ``poll`` (the in-flight
        round's) is called before each peer, to keep its decode fed."""
        units = []
        for entry in self._peers:
            if poll is not None:
                poll()
            if not entry.peer.decoded:
                units += self._gather_one(entry, strict=strict)
        return units

    # -- the loop -----------------------------------------------------------
    def tick(self) -> bool:
        """One synchronous plan/execute round over all live peers.
        Returns True while any peer still has work (event-driven callers
        loop on it; :meth:`run` adds the double-buffered fast path)."""
        units = self._gather()
        if not units:
            return any(not e.peer.decoded for e in self._peers)
        self.ticks += 1
        self.dispatches += execute_round(units, self.block_m).n_dispatches
        return any(not e.peer.decoded for e in self._peers)

    def run(self) -> list:
        """Drive every registered peer to termination; returns reports in
        registration order."""
        if not self.pipeline:
            while self.tick():
                pass
            return self.reports()
        staged = self._gather()
        while staged:
            self.ticks += 1
            round_ = execute_round(staged, self.block_m, pipeline=True)
            self.dispatches += round_.n_dispatches
            # device busy → absorb the next tick's frames now.  Speculative:
            # decodes in flight count as "not decoded", and a unit already
            # at max_m defers its non-convergence verdict.
            staged = self._gather(strict=False, poll=round_.poll)
            round_.finish()
            # units that deferred (skipped by the speculative gather, still
            # undecoded after their results landed) get an authoritative
            # verdict now — this is where a genuinely diverging
            # reconciliation raises, at most one tick later than serial.
            speculated = {id(du.unit) for du in staged}
            for entry in self._peers:
                peer = entry.peer
                if peer.decoded:
                    continue
                pending = [u for u in peer.units if not u.decoder.decoded]
                unstaged = [u for u in pending
                            if id(u) not in speculated]
                for u in unstaged:
                    if u.decoder.symbols_received >= peer.max_m:
                        what = f"shard {u.shard}" if peer.sharded else \
                            "reconciliation"
                        raise RuntimeError(
                            f"{what} did not converge within "
                            f"{peer.max_m} symbols")
                if unstaged:
                    # defensive: an undecoded unit below max_m is always
                    # staged by the speculative gather today — regather
                    # authoritatively rather than exit with it stalled
                    staged += self._gather_one(entry, strict=True)
            # drop speculative units whose peer terminated meanwhile — the
            # absorbed window stays as accounted pacing overshoot.
            staged = [du for du in staged if not du.unit.decoder.decoded]
        return self.reports()

    # -- outcome ------------------------------------------------------------
    def reports(self) -> list:
        """Current reports for every registered peer, in registration
        order (valid mid-run: undecoded peers report partial recovery)."""
        return [entry.session.report() for entry in self._peers]


def serve(pairs, *, wire: bool = True, backend: str | None = None,
          pipeline: bool = True) -> list:
    """Drive ``(stream, session)`` pairs to completion on one engine.

    The multi-peer counterpart of
    :func:`~repro_torch.protocol.session.run_session`:
    all sessions advance in shared ticks, decode work batches across peers
    per shape bucket, and (with ``pipeline=True``) device decode overlaps
    host ingest.  Returns the reports in input order.
    """
    engine = ReconcileEngine(pipeline=pipeline)
    for stream, session in pairs:
        if backend is not None:
            session.set_backend(backend)
        engine.register(stream, session, wire=wire)
    return engine.run()
