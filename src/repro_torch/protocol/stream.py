"""SymbolStream — one universal coded-symbol stream, any number of peers.

Port of ``repro/protocol/stream.py``: plain numpy, unchanged.

The paper's central claim (§4.1) is that the coded-symbol sequence of a set
is *universal*: the same incrementally extended prefix reconciles any peer
at any difference size.  ``SymbolStream`` is that claim as an object: it
wraps exactly one :class:`~repro_torch.core.encoder.Encoder`, owns its growing
prefix cache, and serves **zero-copy windows** (or wire-ready byte frames)
of the stream to any number of concurrent sessions.  Serving a window never
re-encodes — it extends the shared cache at most once and aliases it.
Windows are snapshots to consume immediately (a later extension reallocates
the cache and detaches them); sessions and the frame codec do exactly that.

When the underlying set changes, ``add_items`` / ``remove_items`` update
the cached prefix *in place* (linearity, §4.1) — every session keeps
pulling from the same stream.

Concurrent peers are first-class consumers: a
:class:`~repro_torch.protocol.engine.ReconcileEngine` registers many
``(stream, session)`` pairs against the same (or different) streams and
pulls all of their windows in shared ticks — the cache still extends at
most once per tick, by whichever peer reaches deepest.
"""
from __future__ import annotations

from repro_torch.core.encoder import Encoder
from repro_torch.core.hashing import DEFAULT_KEY
from repro_torch.core.symbols import CodedSymbols
from repro_torch.core.wire import encode_frames


class SymbolStream:
    """Serve windows of one set's universal coded-symbol stream.

    Wraps one :class:`~repro_torch.core.encoder.Encoder` (the set plus its grown
    symbol-prefix cache).  Invariants: the stream is *universal* — every
    peer sees the same symbol at the same index, whatever window schedule
    it pulls by — and serving is zero-copy: a window call extends the
    shared cache at most once and returns views of it.
    """

    def __init__(self, encoder: Encoder):
        self.encoder = encoder

    @classmethod
    def from_items(cls, items, nbytes: int, key=DEFAULT_KEY) -> "SymbolStream":
        """Stream of the set ``items`` (list of ``bytes``, ``(n, nbytes)``
        uint8 rows, or ``(n, L)`` uint32 word rows) of fixed item length
        ``nbytes``, under session ``key``."""
        enc = Encoder(nbytes, key)
        if len(items):
            enc.add_items(items)
        return cls(enc)

    # -- stream geometry ----------------------------------------------------
    @property
    def nbytes(self) -> int:
        return self.encoder.nbytes

    @property
    def key(self):
        return self.encoder.key

    @property
    def n_items(self) -> int:
        return len(self.encoder)

    @property
    def m(self) -> int:
        """Symbols materialized so far in the shared cache."""
        return self.encoder.m

    # -- serving ------------------------------------------------------------
    def window(self, lo: int, hi: int) -> CodedSymbols:
        """Zero-copy view of stream symbols [lo, hi); extends on demand.

        Requires ``0 ≤ lo ≤ hi``; the cache grows to ``hi`` if needed.
        The view aliases the shared cache *as of this call* — consume it
        immediately (see the module docstring on view lifetime).
        """
        return self.encoder.window(lo, hi)

    def frames(self, lo: int, hi: int) -> bytes:
        """Wire frame (paper §6 encoding) for stream symbols [lo, hi).

        The frame is self-describing (:func:`repro_torch.core.wire.encode_frames`
        with this stream's ``start=lo`` and set size), so a receiver needs
        no side channel to place it in the stream.
        """
        return encode_frames(self.window(lo, hi), start=lo,
                             n_items=self.n_items)

    # -- set mutation (updates the universal cache in place) ----------------
    def add_items(self, items) -> None:
        """Add items to the set; the cached symbol prefix is updated in
        place by linearity (§4.1), so open sessions keep pulling a
        consistent stream of the *new* set."""
        self.encoder.add_items(items)

    def remove_items(self, items) -> None:
        """Remove present items; same in-place linear update as
        :meth:`add_items`."""
        self.encoder.remove_items(items)

    # -- convenience --------------------------------------------------------
    def session(self, local=None, **kwargs):
        """A new :class:`~repro_torch.protocol.session.Session` against this
        stream's geometry (nbytes/key inherited when ``local`` is None)."""
        from .session import Session
        if local is None:
            kwargs.setdefault("nbytes", self.nbytes)
            kwargs.setdefault("key", self.key)
        return Session(local=local, **kwargs)
