"""Checkpoint reconciliation via Rateless IBLT — the paper's technique as
the framework's state-repair path (paper §7.3's Ethereum scenario, with the
ledger replaced by a checkpoint store).

Port of ``repro/checkpoint/reconcile.py``.  A stale/corrupt replica holds
store B; a healthy peer holds store A.  The stores' manifests are sets of
16-byte records (key-hash ‖ chunk-digest).  The peer exposes one universal
`SymbolStream` (it can serve any number of replicas at any staleness with
the same stream — §4.1 universality); each replica runs a
`repro_torch.protocol.Session` over the byte-level wire frames, peeling on
the device backend (the CUDA kernels on ``device="cuda"``, their plain
torch versions on ``device="cpu"``), and learns exactly which chunk ids
differ — then fetches only those chunks.
"""
from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

from repro_torch.core import CodedSymbols, Sketch
from repro_torch.protocol import Exponential, Session, SymbolStream

from .manager import cid_hashes

REC_BYTES = 16


@dataclasses.dataclass
class SyncReport:
    symbols_used: int
    symbol_bytes: int      # actual wire traffic of the symbol frames
    chunks_fetched: int
    chunk_bytes: int
    naive_bytes: int       # cost of downloading the full store
    host_fallbacks: int = 0  # windows the device decode left to the host

    @property
    def total_bytes(self):
        return self.symbol_bytes + self.chunk_bytes

    @property
    def savings(self):
        return self.naive_bytes / max(self.total_bytes, 1)


def _record_key_hashes(recs: np.ndarray) -> np.ndarray:
    """(n, 4) uint32 record words -> (n,) uint64 leading key-hash halves.

    Only uint32 words are taken: int32 bit patterns would sign-extend a
    word whose top bit is set, and the chunk lookup would miss silently."""
    if recs.dtype != np.uint32:
        raise TypeError(f"record words must be uint32, got {recs.dtype}")
    if recs.shape[0] == 0:
        return np.zeros(0, np.uint64)
    w = np.ascontiguousarray(recs[:, :2]).astype(np.uint64)
    return w[:, 0] | (w[:, 1] << np.uint64(32))


class PeerEndpoint:
    """The healthy side: serves coded-symbol wire frames + chunk bodies.

    The symbol stream is universal and incremental: it is extended on
    demand and reused across every syncing replica; when the store changes,
    the cached prefix is *updated* (add/remove the delta records) instead of
    rebuilt — the paper's linearity property."""

    def __init__(self, store):
        self.store = store
        self.stream = SymbolStream(Sketch.from_items(store.records(),
                                                     REC_BYTES))
        self._cid_by_key: dict[int, str] = {}
        self._kh_by_cid: dict[str, int] = {}
        self._refresh_cid_map()

    def _refresh_cid_map(self):
        """Sync the kh→cid map with the manifest, hashing only the delta."""
        chunks = self.store.manifest()["chunks"].keys()
        for cid in self._kh_by_cid.keys() - chunks:
            self._cid_by_key.pop(self._kh_by_cid.pop(cid), None)
        new = sorted(chunks - self._kh_by_cid.keys())
        for cid, kh in zip(new, cid_hashes(new).tolist()):
            self._kh_by_cid[cid] = kh
            self._cid_by_key[kh] = cid

    def frames(self, lo: int, hi: int) -> bytes:
        """Wire frame for symbols [lo, hi) of the universal stream."""
        return self.stream.frames(lo, hi)

    def symbols(self, lo: int, hi: int) -> CodedSymbols:
        """Deprecated shim (pre-session API): raw symbol window [lo, hi)."""
        return self.stream.window(lo, hi).copy()

    def fetch_chunk(self, cid: str) -> bytes:
        with open(self.store._chunk_path(cid), "rb") as f:
            return f.read()

    def notify_update(self, added: np.ndarray, removed: np.ndarray):
        """Store changed: update the universal symbol cache in place."""
        if len(added):
            self.stream.add_items(added)
        if len(removed):
            self.stream.remove_items(removed)
        self._refresh_cid_map()


def sync_from_peer(store, peer: PeerEndpoint, block: int = 16,
                   max_m: int = 1 << 20, device="cuda") -> SyncReport:
    """Repair `store` to match `peer.store`, peeling on ``device``.
    Returns transfer accounting."""
    local = Sketch.from_items(store.records(), REC_BYTES)
    session = Session(local=local,
                      pacing=Exponential(block=block, growth=1.5),
                      max_m=max_m, device=device)
    while (win := session.request()) is not None:
        session.offer_bytes(peer.frames(*win))
    rep = session.report()
    only_peer, only_local = rep.only_remote, rep.only_local
    man = store.manifest()
    peer_man = peer.store.manifest()
    # map recovered records back to chunk ids via the key-hash half
    fetched = 0
    fetched_bytes = 0
    for kh in _record_key_hashes(only_peer).tolist():
        cid = peer._cid_by_key.get(kh)
        if cid is None:
            continue
        data = peer.fetch_chunk(cid)
        with open(store._chunk_path(cid), "wb") as f:
            f.write(data)
        man["chunks"][cid] = peer_man["chunks"][cid]
        fetched += 1
        fetched_bytes += len(data)
    # records only in the stale store = chunks that no longer exist
    # upstream; one reverse key-hash map, built once
    cids = list(man["chunks"])
    key_to_cid = dict(zip(cid_hashes(cids).tolist(), cids))
    for kh in _record_key_hashes(only_local).tolist():
        cid = key_to_cid.get(kh)
        if cid is not None and cid not in peer_man["chunks"]:
            man["chunks"].pop(cid, None)
    man["leaves"] = peer_man["leaves"]
    man["step"] = peer_man["step"]
    with open(os.path.join(store.root, "manifest.json"), "w") as f:
        json.dump(man, f)
    naive = sum(os.path.getsize(peer.store._chunk_path(cid))
                for cid in peer_man["chunks"])
    return SyncReport(symbols_used=rep.symbols_used,
                      symbol_bytes=rep.bytes_received,
                      chunks_fetched=fetched, chunk_bytes=fetched_bytes,
                      naive_bytes=naive,
                      host_fallbacks=session.host_fallbacks)
