"""Reconciliation engine — the plan/execute core behind every session.

Port of the single-peer path of ``repro/protocol/engine.py``.  Each tick,
pending work from the registered peers is collected into a
:class:`DecodePlan` of ``(peer, unit, window)`` :class:`DecodeUnit`\\ s:
host units peel on the exact numpy engine, device units are grouped by
shape bucket (tile-padded prefix length, item geometry, key, ``max_diff``).
A bucket of one plain unit decodes through
:func:`repro_torch.kernels.ops.decode_device` — the CUDA wave peel.

Not ported yet, and refused with ``NotImplementedError`` rather than run on
the host: a bucket that holds more than one unit (cross-peer batched
decode, ROADMAP module item 8) and ``pipeline=True`` (double-buffered
device decode, ROADMAP module item 9), as well as sharded peers.

A unit whose device decode overflows ``max_diff`` falls back to the exact
host peel and is **pinned to the host** from then on; every window such a
unit peels on the host is counted in its decoder's ``host_fallbacks``.

:func:`~repro_torch.protocol.session.run_session` drives its single pair
through :func:`serve` on a non-pipelined :class:`ReconcileEngine` — the
serial request → offer → decode lockstep of the reference.
"""
from __future__ import annotations

from typing import NamedTuple

from repro_torch.core.decoder import resolve_backend, resolve_device
from repro_torch.core.stream import StreamDecoder
from repro_torch.core.wire import decode_frames

_BATCHED = ("batched multi-unit device decode is not ported yet "
            "(ROADMAP module items 8 and 9)")


class ProtocolError(RuntimeError):
    """A window arrived out of order / with inconsistent geometry."""


# ---------------------------------------------------------------------------
# Peer state: decode units + pacing + accounting, shared by every wrapper.
# ---------------------------------------------------------------------------
class UnitState:
    """One decode unit: an incremental decoder plus its protocol
    bookkeeping.  ``pinned_host`` is set the first time a device decode of
    this unit overflows ``max_diff`` — from then on the unit peels on the
    host even if the peer's backend is (re)set to device."""

    __slots__ = ("shard", "decoder", "remote_items", "pinned_host")

    def __init__(self, shard: int, decoder: StreamDecoder):
        self.shard = shard
        self.decoder = decoder
        self.remote_items: int | None = None
        self.pinned_host = False


class PeerState:
    """Everything the engine knows about one registered peer: its decode
    unit, pacing policy, backend / device / ``max_diff`` configuration and
    wire accounting.  Only plain (one-unit) peers are ported."""

    def __init__(self, *, nbytes: int, key, locals_, pacing, max_m: int,
                 backend: str, max_diff: int | None, device="cuda"):
        if len(locals_) != 1:
            raise NotImplementedError("sharded peers are not ported yet "
                                      "(ROADMAP module item 9)")
        self.nbytes = nbytes
        self.key = tuple(key)
        self.pacing = pacing
        self.max_m = max_m
        self.max_diff = max_diff
        self.bytes_received = 0
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
        return sum(u.decoder.host_fallbacks for u in self.units)

    def set_backend(self, backend: str) -> None:
        backend = resolve_backend(backend)
        if backend == "device":
            self.device = resolve_device(self.device)
        self.backend = backend
        for u in self.units:
            u.decoder.backend = backend
            u.decoder.device = self.device

    def requests(self) -> list[tuple[int, int, int]]:
        """Next window ``(unit, lo, hi)`` per still-undecoded unit, sized by
        the stateless pacing policy and clamped to ``max_m``.  A unit at
        ``max_m`` without a decode signal raises ``RuntimeError``."""
        reqs = []
        for u in self.units:
            if u.decoder.decoded:
                continue
            lo = u.decoder.symbols_received
            if lo >= self.max_m:
                raise RuntimeError(f"reconciliation did not converge within "
                                   f"{self.max_m} symbols")
            reqs.append((u.shard, *self.pacing.next_window(lo, self.max_m)))
        return reqs


class DecodeUnit(NamedTuple):
    """One tick's pending work for one unit: it absorbed a window and rows
    ``[old, m)`` of its residual await peeling."""
    peer: PeerState
    unit: UnitState
    old: int
    m: int


# ---------------------------------------------------------------------------
# Ingest: validate + absorb (no peeling — that is the execute phase's job).
# ---------------------------------------------------------------------------
def validate_round(peer: PeerState, windows) -> list:
    """Check one round of ``(unit, symbols, start)`` windows against the
    peer's positions without mutating anything.

    All-or-nothing: every window is checked (unit id, order, geometry)
    before any state mutates.  Overlap with already-consumed symbols is
    trimmed, wholly stale windows are dropped.  Returns the accepted
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
            raise ProtocolError(f"gap: expected window at {pos}, got {start}")
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

    Each touched unit absorbs its windows (local-symbol subtraction, chain
    extension of already-recovered items) and contributes ONE
    :class:`DecodeUnit`.  Units that terminate on absorb alone (a d=0 unit
    subtracts to an all-empty residual) are marked decoded and excluded.
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
    return [du for du in spans.values()
            if not du.unit.decoder.mark_decoded(at=du.m)]


def ingest_frames(peer: PeerState, data: bytes) -> list[DecodeUnit]:
    """Absorb one self-describing wire frame."""
    sym, n_items, start = decode_frames(data)
    peer.bytes_received += len(data)
    peer.units[0].remote_items = n_items
    return absorb_round(peer, [(0, sym, start)])


# ---------------------------------------------------------------------------
# Plan: bucket pending units by shape; Execute: one decode per bucket.
# ---------------------------------------------------------------------------
class DecodePlan:
    """One tick's decode work: ``host`` units peel on the numpy engine;
    ``buckets`` maps a shape key ``(mp, L, nbytes, key, max_diff)`` to the
    device units that would share one batched decode."""

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
        key = (mp, du.unit.decoder.work.L, du.peer.nbytes, du.peer.key, D)
        buckets.setdefault(key, []).append(du)
    return DecodePlan(host, buckets)


def execute_round(units: list[DecodeUnit], block_m: int = 256) -> int:
    """Decode one tick's absorbed units synchronously; returns the number
    of device decodes issued.

    Host units peel at once (a device-backend unit pinned to the host
    counts a host fallback).  Each device bucket must hold one plain unit,
    which decodes through :func:`~repro_torch.kernels.ops.decode_device`;
    a ``max_diff`` overflow peels the window on the host, pins the unit
    there and counts a host fallback.
    """
    from repro_torch.kernels import ops
    plan = build_plan(units, block_m)
    for us in plan.buckets.values():
        if len(us) > 1:
            raise NotImplementedError(_BATCHED)
    for du in plan.host:
        dec = du.unit.decoder
        if du.peer.backend == "device":
            dec.host_fallbacks += 1
        dec.peel_window(du.old, du.m)
        dec.mark_decoded(at=du.m)
    for (_, _, nbytes, key, _), (du,) in plan.buckets.items():
        dec = du.unit.decoder
        res = ops.decode_device(
            *ops.host_symbols_to_device(dec.work, dec.device), nbytes=nbytes,
            key=key, max_diff=du.peer.max_diff, block_m=block_m,
            device=dec.device)
        if res.overflow:
            du.unit.pinned_host = True
            dec.host_fallbacks += 1
            dec.peel_window(du.old, du.m)
        else:
            dec.merge_device_result(res)
        dec.mark_decoded(at=du.m)
    return len(plan.buckets)


def offer_round(peer: PeerState, windows) -> bool:
    """The wrappers' push-style entry: absorb one round of in-process
    windows and decode it synchronously.  Returns ``decoded``."""
    execute_round(absorb_round(peer, windows))
    return peer.decoded


# ---------------------------------------------------------------------------
# The engine: one tick loop over the registered peers.
# ---------------------------------------------------------------------------
class _Registered(NamedTuple):
    stream: object      # SymbolStream
    session: object     # Session
    peer: PeerState
    wire: bool


class ReconcileEngine:
    """Drive (stream, session) pairs through one shared plan/execute loop.

    Parameters
    ----------
    pipeline: must be False — double-buffered device decode is not ported
        yet (ROADMAP module item 9).
    block_m: device tile size — the shape-bucket quantum.

    ``ticks`` counts plan/execute rounds, ``dispatches`` the device
    decodes issued.
    """

    def __init__(self, *, pipeline: bool = False, block_m: int = 256):
        if pipeline:
            raise NotImplementedError(_BATCHED)
        self.block_m = block_m
        self.ticks = 0
        self.dispatches = 0
        self._peers: list[_Registered] = []

    def register(self, stream, session, *, wire: bool = True) -> int:
        """Attach one (stream, session) pair; returns its index.  The
        engine adopts the session's :class:`PeerState`, so the session
        reports through its own ``report()`` afterwards."""
        if getattr(stream, "n_shards", None) is not None:
            raise ProtocolError("sharded streams are not ported yet")
        self._peers.append(_Registered(stream, session, session._peer, wire))
        return len(self._peers) - 1

    def _gather_one(self, entry: _Registered) -> list[DecodeUnit]:
        reqs = entry.peer.requests()
        if not reqs:
            return []
        ((_, lo, hi),) = reqs
        if entry.wire:
            return ingest_frames(entry.peer, entry.stream.frames(lo, hi))
        return absorb_round(entry.peer, [(0, entry.stream.window(lo, hi), lo)])

    def tick(self) -> bool:
        """One synchronous plan/execute round over all live peers.
        Returns True while any peer still has work."""
        units = []
        for entry in self._peers:
            if not entry.peer.decoded:
                units += self._gather_one(entry)
        if units:
            self.ticks += 1
            self.dispatches += execute_round(units, self.block_m)
        return any(not e.peer.decoded for e in self._peers)

    def run(self) -> list:
        """Drive every registered peer to termination; returns reports in
        registration order."""
        while self.tick():
            pass
        return [entry.session.report() for entry in self._peers]


def serve(pairs, *, wire: bool = True, backend: str | None = None,
          pipeline: bool = False) -> list:
    """Drive ``(stream, session)`` pairs to completion on one engine;
    returns the reports in input order."""
    engine = ReconcileEngine(pipeline=pipeline)
    for stream, session in pairs:
        if backend is not None:
            session.set_backend(backend)
        engine.register(stream, session, wire=wire)
    return engine.run()
