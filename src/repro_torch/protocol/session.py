"""Session — one peer's half of a rateless reconciliation (paper §4.1).

Port of ``repro/protocol/session.py``.  A ``Session`` is a thin single-peer
wrapper over the engine's :class:`~repro_torch.protocol.engine.PeerState`:

* a :class:`~repro_torch.core.stream.StreamDecoder` (subtracts the local
  set's symbols index-wise, peels each window, terminates the moment
  symbol 0 empties — the ρ(0)=1 signal);
* a :class:`~repro_torch.protocol.pacing.Pacing` policy deciding how much
  more of the remote universal stream to pull per round trip;
* window bookkeeping: the remote stream is consumed as contiguous windows,
  either as in-process :class:`CodedSymbols` views (``offer``) or as wire
  byte frames (``offer_bytes``).

The default backend is ``"device"`` on ``device="cuda"``: each window is
wave-peeled by the CUDA kernels.  Without CUDA the constructor raises
unless the caller passes ``device="cpu"`` (the kernels' plain torch
versions) or ``backend="host"`` (the reference's numpy engine).

Pull protocol::

    while (win := session.request()) is not None:
        lo, hi = win
        session.offer_bytes(stream.frames(lo, hi))   # or offer(window, lo)
    report = session.report()

:func:`run_session` packages that loop (on a single-peer, non-pipelined
:class:`~repro_torch.protocol.engine.ReconcileEngine`); to reconcile
against many peers at once — shared ticks, cross-peer batched decode —
register several sessions on one engine instead.
"""
from __future__ import annotations

from repro_torch.core.hashing import DEFAULT_KEY
from repro_torch.core.symbols import CodedSymbols

from .engine import (PeerState, ProtocolError, execute_round, ingest_frames,
                     offer_round)
from .pacing import Exponential, Pacing
from .reports import SessionReport, build_session_report
from .stream import SymbolStream

__all__ = ["ProtocolError", "Session", "SessionReport", "run_session"]


class Session:
    """Incremental reconciliation of one local set against a remote stream.

    Parameters
    ----------
    local: Encoder of the local set, or None to decode a raw stream
        (recovers the remote set itself rather than a difference).
    nbytes, key: stream geometry — inferred from ``local`` when given.
    pacing: window schedule (default: the doubling schedule).
    max_m: abort bound on stream consumption.
    backend: "device" | "host" | "auto" peel engine (see
        :mod:`repro_torch.core.decoder`); "device" wave-peels each window
        on ``device``, with a counted host fallback on ``max_diff``
        overflow (:attr:`host_fallbacks`).
    max_diff: recovered-item buffer bound for the device engine.
    device: where the device engine runs — "cuda" (the default; raises
        without CUDA) or "cpu" (the kernels' plain torch versions).
    """

    def __init__(self, local=None, nbytes: int | None = None,
                 pacing: Pacing | None = None, key=None,
                 max_m: int = 1 << 22, backend: str = "device",
                 max_diff: int | None = None, device="cuda"):
        if local is not None:
            nbytes = local.nbytes if nbytes is None else nbytes
            key = local.key if key is None else key
        if nbytes is None:
            raise ValueError("need nbytes (or a local set to infer it from)")
        key = DEFAULT_KEY if key is None else key
        self.nbytes = nbytes
        self._peer = PeerState(
            nbytes=nbytes, key=key, locals_=[local],
            pacing=pacing or Exponential(block=8, growth=2.0),
            max_m=max_m, backend=backend, max_diff=max_diff, sharded=False,
            device=device)
        self.decoder = self._peer.units[0].decoder

    # -- state --------------------------------------------------------------
    @property
    def backend(self) -> str:
        return self._peer.backend

    def set_backend(self, backend: str) -> None:
        """Switch the peel engine; safe between windows (both engines keep
        the identical decoder state)."""
        self._peer.set_backend(backend)

    @property
    def pacing(self) -> Pacing:
        return self._peer.pacing

    @pacing.setter
    def pacing(self, pacing: Pacing) -> None:
        self._peer.pacing = pacing

    @property
    def max_m(self) -> int:
        return self._peer.max_m

    @property
    def bytes_received(self) -> int:
        return self._peer.bytes_received

    @property
    def remote_items(self) -> int | None:
        return self._peer.units[0].remote_items

    @property
    def decoded(self) -> bool:
        return self.decoder.decoded

    @property
    def symbols_received(self) -> int:
        return self.decoder.symbols_received

    @property
    def symbols_used(self) -> int | None:
        return self.decoder.decoded_at

    @property
    def host_fallbacks(self) -> int:
        """Windows peeled on the host although the backend is "device"."""
        return self._peer.host_fallbacks

    # -- pull protocol ------------------------------------------------------
    def request(self) -> tuple[int, int] | None:
        """Next stream window [lo, hi) this session wants; None if done.

        Raises ``RuntimeError`` once ``max_m`` symbols have been consumed
        without decoding — the reconciliation is diverging.
        """
        reqs = self._peer.requests()
        if not reqs:
            return None
        (_, lo, hi), = reqs
        return lo, hi

    def offer(self, sym: CodedSymbols, start: int = 0) -> bool:
        """Feed stream symbols [start, start+sym.m) as in-process views.

        Windows arrive in order (``start`` past the current position raises
        :class:`ProtocolError`); overlap with consumed symbols is trimmed,
        wholly stale windows are no-ops.  Returns ``decoded``.
        """
        return offer_round(self._peer, [(0, sym, start)])

    def offer_bytes(self, data: bytes) -> bool:
        """Feed one wire frame (:func:`repro_torch.core.wire.encode_frames`
        output); its header carries the window start and the remote set
        size (:attr:`remote_items`).  Returns ``decoded``."""
        execute_round(ingest_frames(self._peer, data))
        return self.decoded

    # -- outcome ------------------------------------------------------------
    def result(self):
        """(only_remote, only_local) as uint32 word arrays."""
        return self.decoder.result()

    def report(self) -> SessionReport:
        """Snapshot the session outcome as a :class:`SessionReport`."""
        return build_session_report(self._peer)


def run_session(stream: SymbolStream, session: Session, wire: bool = False,
                backend: str | None = None) -> SessionReport:
    """Drive ``session`` to completion against ``stream``.

    ``wire=True`` routes every window through the byte-level frame codec —
    exactly what two networked peers would exchange.  ``backend``
    optionally switches the session's peel engine first (the switch
    persists).  A :class:`~repro_torch.protocol.sharded.ShardedSession`
    against a :class:`~repro_torch.protocol.sharded.ShardedStream` is
    dispatched to
    :func:`~repro_torch.protocol.sharded.run_sharded_session`.  The loop is
    one single-peer, non-pipelined
    :class:`~repro_torch.protocol.engine.ReconcileEngine`.
    """
    from .engine import serve
    from .sharded import ShardedSession, run_sharded_session
    if isinstance(session, ShardedSession):
        return run_sharded_session(stream, session, wire=wire,
                                   backend=backend)
    return serve([(stream, session)], wire=wire, backend=backend,
                 pipeline=False)[0]
