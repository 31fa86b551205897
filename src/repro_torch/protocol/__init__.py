"""Session-oriented reconciliation protocol (paper §4.1 universality, §6).

Port of ``repro.protocol``.  One :class:`SymbolStream` per set serves
windows or wire frames of the universal coded-symbol stream to any number
of :class:`Session` peers, each with its own pacing policy, peeling on the
CUDA kernels by default.  :class:`ShardedStream` / :class:`ShardedSession`
hash-partition the key space into S shards served as merged wire payloads,
and a :class:`ReconcileEngine` drives any number of concurrent peers
through one plan/execute loop: pending (peer, shard, window) decode units
coalesce into ONE batched device decode per shape bucket per tick.
"""
from .engine import (DecodePlan, PeerState, ProtocolError, ReconcileEngine,
                     serve)
from .pacing import Exponential, FixedBlock, LineRate, Pacing
from .reports import SessionReport, ShardedReport, ShardReport
from .session import Session, run_session
from .sharded import (ShardedSession, ShardedStream, run_sharded_session,
                      shard_of)
from .stream import SymbolStream

__all__ = [
    "DecodePlan", "Exponential", "FixedBlock", "LineRate", "Pacing",
    "PeerState", "ProtocolError", "ReconcileEngine", "Session",
    "SessionReport", "ShardReport", "ShardedReport", "ShardedSession",
    "ShardedStream", "SymbolStream", "run_session", "run_sharded_session",
    "serve", "shard_of",
]
