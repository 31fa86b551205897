"""Reconciliation reports — one overhead/bytes vocabulary for every peer.

Port of ``repro/protocol/reports.py``.

:class:`SessionReport` (plain sessions) and :class:`ShardedReport` (sharded
sessions) derive their words-to-bytes and overhead arithmetic from
:class:`ReportBase`; the builders here assemble either from the engine's
:class:`~repro_torch.protocol.engine.PeerState` — the single place session
outcome lives, whether the peer was driven by its own wrapper
(``Session.offer``/``ShardedSession.offer_payload``) or by a multi-peer
:class:`~repro_torch.protocol.engine.ReconcileEngine`.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.hashing import words_to_bytes


@dataclasses.dataclass
class ReportBase:
    """Fields and arithmetic shared by every reconciliation outcome."""
    only_remote: np.ndarray   # (r, L) uint32 words — items only in remote set
    only_local: np.ndarray    # (s, L) uint32 words — items only in local set
    nbytes: int               # item length ℓ
    symbols_used: int         # stream prefix length at the decode signal
    symbols_received: int     # including pacing overshoot
    bytes_received: int       # wire-mode traffic (0 for in-process sessions)
    remote_items: int | None  # |remote set|, learned from frame headers

    def only_remote_bytes(self) -> np.ndarray:
        """(r, ℓ) uint8 — remote-exclusive items as raw bytes."""
        return words_to_bytes(self.only_remote, self.nbytes)

    def only_local_bytes(self) -> np.ndarray:
        return words_to_bytes(self.only_local, self.nbytes)

    def overhead(self, d: int | None = None) -> float:
        """symbols_used / d (defaults to the recovered difference size)."""
        if d is None:
            d = self.only_remote.shape[0] + self.only_local.shape[0]
        return self.symbols_used / max(d, 1)


@dataclasses.dataclass
class SessionReport(ReportBase):
    """Outcome of a completed :class:`~repro_torch.protocol.session.Session`."""


@dataclasses.dataclass
class ShardReport:
    """Per-shard slice of a completed sharded reconciliation."""
    shard: int
    only_remote: np.ndarray   # (r, L) uint32 words — remote-only, this shard
    only_local: np.ndarray    # (s, L) uint32 words — local-only, this shard
    symbols_used: int         # shard prefix length at its decode signal
    symbols_received: int     # including pacing overshoot
    remote_items: int | None  # |remote shard set|, from frame headers


@dataclasses.dataclass
class ShardedReport(ReportBase):
    """Outcome of a completed :class:`~repro_torch.protocol.sharded.ShardedSession`.

    The aggregate fields mirror :class:`SessionReport` (the union over
    shards *is* the unsharded difference — shard invariance); ``shards``
    keeps the per-shard breakdown.
    """
    shards: list[ShardReport]  # per-shard breakdown
    grow_steps: int            # merged windows consumed (decode rounds run)


def build_session_report(peer) -> SessionReport:
    """Snapshot a single-unit peer as a :class:`SessionReport`.

    Valid at any time: before decode it reports the partial recovery
    (``symbols_used`` then falls back to ``symbols_received``); after
    decode it is the final reconciliation result.
    """
    (unit,) = peer.units
    only_remote, only_local = unit.decoder.result()
    return SessionReport(
        only_remote=only_remote, only_local=only_local,
        nbytes=peer.nbytes,
        symbols_used=unit.decoder.decoded_at or unit.decoder.symbols_received,
        symbols_received=unit.decoder.symbols_received,
        bytes_received=peer.bytes_received,
        remote_items=unit.remote_items)


def build_sharded_report(peer) -> ShardedReport:
    """Snapshot a multi-unit peer as a :class:`ShardedReport`."""
    per_shard = []
    for unit in peer.units:
        only_remote, only_local = unit.decoder.result()
        per_shard.append(ShardReport(
            shard=unit.shard, only_remote=only_remote, only_local=only_local,
            symbols_used=unit.decoder.decoded_at or
            unit.decoder.symbols_received,
            symbols_received=unit.decoder.symbols_received,
            remote_items=unit.remote_items))
    counts = [sr.remote_items for sr in per_shard]
    return ShardedReport(
        only_remote=np.concatenate([sr.only_remote for sr in per_shard]),
        only_local=np.concatenate([sr.only_local for sr in per_shard]),
        nbytes=peer.nbytes,
        symbols_used=sum(sr.symbols_used for sr in per_shard),
        symbols_received=sum(sr.symbols_received for sr in per_shard),
        bytes_received=peer.bytes_received,
        remote_items=None if any(c is None for c in counts) else sum(counts),
        shards=per_shard,
        grow_steps=peer.grow_steps)
