"""Session-oriented reconciliation protocol (paper §4.1 universality, §6).

Port of ``repro.protocol``, single-peer path: one :class:`SymbolStream` per
set serves windows or wire frames of the universal coded-symbol stream,
and a :class:`Session` pulls them until its difference decodes, peeling on
the CUDA kernels by default.  Sharded serving and the batched multi-peer
engine are not ported yet.
"""
from .engine import (DecodePlan, PeerState, ProtocolError, ReconcileEngine,
                     serve)
from .pacing import Exponential, FixedBlock, LineRate, Pacing
from .reports import SessionReport
from .session import Session, run_session
from .stream import SymbolStream

__all__ = [
    "DecodePlan", "Exponential", "FixedBlock", "LineRate", "Pacing",
    "PeerState", "ProtocolError", "ReconcileEngine", "Session",
    "SessionReport", "SymbolStream", "run_session", "serve",
]
