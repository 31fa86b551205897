"""Sharded SymbolStream serving — fan-out reconciliation over S shards.

Port of ``repro/protocol/sharded.py``.

* the key space is hash-partitioned into ``S`` shards by a **stable SipHash
  shard-of-key** (:func:`shard_of`) — the high word of the mapping seed
  that :func:`repro_torch.core.mapping.map_seeds` already computes, so both
  ends of a session (and the reference) agree on the partition by
  construction;
* a :class:`ShardedStream` keeps one universal symbol cache *per shard*
  (S independent :class:`~repro_torch.protocol.stream.SymbolStream`\\ s)
  and serves **merged windows**: one wire payload interleaving per-shard
  columnar frames behind a shard-id'd header extension
  (:func:`repro_torch.core.wire.encode_shard_frames`);
* a :class:`ShardedSession` is the S-unit wrapper over the engine's
  :class:`~repro_torch.protocol.engine.PeerState`: one incremental decoder
  per shard, every grow step decoded in **one batched device call**
  (:func:`repro_torch.kernels.ops.decode_device_batched` — the shards laid
  end to end on the symbol axis, one wave loop for all);
* pacing is **per shard**: each shard pulls by its own progress, so a hot
  shard keeps growing its window while settled shards — each terminated
  by its own ρ(0)=1 signal — stop requesting.

A shard whose device decode overflows ``max_diff`` falls back to the exact
host peel *alone*, is counted in ``host_fallbacks``, and stays pinned to
the host from then on.

Shard invariance: for any S, the union of per-shard symmetric differences
is exactly the unsharded symmetric difference (items never cross shards —
the partition function depends only on the item and the key).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.hashing import DEFAULT_KEY, bytes_to_words
from repro_torch.core.mapping import map_seeds
from repro_torch.core.wire import encode_shard_frames

from .engine import (PeerState, ProtocolError, execute_round, ingest_payload,
                     offer_round)
from .pacing import Exponential, Pacing
from .reports import (ShardReport, ShardedReport, build_sharded_report)
from .stream import SymbolStream

__all__ = ["ShardReport", "ShardedReport", "ShardedSession", "ShardedStream",
           "run_sharded_session", "shard_of"]


def _coerce_words(items, nbytes: int) -> np.ndarray:
    """Items as (n, L) uint32 little-endian words (accepts bytes rows)."""
    if isinstance(items, np.ndarray) and items.dtype == np.uint32:
        return items
    return bytes_to_words(items, nbytes)


def shard_of(items, n_shards: int, key=DEFAULT_KEY,
             nbytes: int | None = None) -> np.ndarray:
    """Stable shard assignment of each item under a session key.

    Parameters
    ----------
    items: ``(n, L)`` uint32 word rows, ``(n, nbytes)`` uint8 rows, or a
        list of ``bytes`` — same coercions as the encoders.
    n_shards: the partition size S ≥ 1.
    key, nbytes: session geometry; ``nbytes`` defaults to ``4·L`` for word
        input and is required for byte input.

    Returns an ``(n,)`` int64 array of shard ids in ``[0, S)``.

    The id is the high half of the item's mapping-PRNG seed — the SipHash
    of the item under the tweaked session key that the encoder computes
    anyway (:func:`repro_torch.core.mapping.map_seeds`) — reduced mod S,
    exactly as the reference computes it.  The *high*
    word is used because the seed's low bit is forced odd for the
    xorshift64 state, which would empty every even shard.  Invariants:
    deterministic in (item, key, S); independent of insertion order and of
    which peer evaluates it — both ends of a session compute the identical
    partition.
    """
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    words = _coerce_words(items, nbytes)
    if nbytes is None:
        nbytes = 4 * words.shape[1]
    seeds = map_seeds(words, key, nbytes)
    return ((seeds >> np.uint64(32)) % np.uint64(n_shards)).astype(np.int64)


class ShardedStream:
    """S universal symbol caches over a hash-partitioned key space.

    One :class:`~repro_torch.protocol.stream.SymbolStream` per shard; windows of
    several shards merge into a single wire payload (:meth:`payload`).
    Like the unsharded stream, serving never re-encodes: each shard's
    prefix cache extends at most once per request and is shared by every
    peer syncing against this stream.

    Construct with :meth:`from_items`; mutate with :meth:`add_items` /
    :meth:`remove_items`, which route every item to its stable shard.
    """

    def __init__(self, shards: list[SymbolStream], key=DEFAULT_KEY):
        if not shards:
            raise ValueError("need at least one shard")
        self.shards = shards
        self.key = key

    @classmethod
    def from_items(cls, items, nbytes: int, n_shards: int = 8,
                   key=DEFAULT_KEY) -> "ShardedStream":
        """Partition ``items`` into ``n_shards`` streams of ``nbytes``-byte
        items under ``key`` (see :func:`shard_of` for accepted layouts)."""
        words = _coerce_words(items, nbytes) if len(items) else \
            np.zeros((0, (nbytes + 3) // 4), np.uint32)
        ids = shard_of(words, n_shards, key, nbytes)
        shards = [SymbolStream.from_items(words[ids == s], nbytes, key)
                  for s in range(n_shards)]
        return cls(shards, key)

    # -- geometry -----------------------------------------------------------
    @property
    def n_shards(self) -> int:
        return len(self.shards)

    @property
    def nbytes(self) -> int:
        return self.shards[0].nbytes

    @property
    def n_items(self) -> int:
        """Total set size across shards."""
        return sum(s.n_items for s in self.shards)

    @property
    def m(self) -> int:
        """Total symbols materialized across all shard caches."""
        return sum(s.m for s in self.shards)

    # -- set mutation (routed to the owning shard) --------------------------
    def _route(self, items) -> list[np.ndarray]:
        words = _coerce_words(items, self.nbytes)
        ids = shard_of(words, self.n_shards, self.key, self.nbytes)
        return [words[ids == s] for s in range(self.n_shards)]

    def add_items(self, items) -> None:
        for shard, part in zip(self.shards, self._route(items)):
            if len(part):
                shard.add_items(part)

    def remove_items(self, items) -> None:
        for shard, part in zip(self.shards, self._route(items)):
            if len(part):
                shard.remove_items(part)

    # -- serving ------------------------------------------------------------
    def window(self, shard: int, lo: int, hi: int):
        """Zero-copy view of shard ``shard``'s stream symbols [lo, hi)."""
        return self.shards[shard].window(lo, hi)

    def payload(self, requests) -> bytes:
        """One merged wire payload answering per-shard window requests.

        ``requests`` is an iterable of ``(shard, lo, hi)``; the result
        interleaves one self-describing columnar frame per request behind
        shard-id'd extension headers — settled shards simply don't appear.
        """
        frames = [(s, self.shards[s].frames(lo, hi)) for s, lo, hi in requests]
        return encode_shard_frames(frames, self.n_shards)

    # -- convenience --------------------------------------------------------
    def session(self, local: "ShardedStream | None" = None,
                **kwargs) -> "ShardedSession":
        """A :class:`ShardedSession` against this stream's geometry
        (n_shards/nbytes/key inherited when ``local`` is None)."""
        if local is None:
            kwargs.setdefault("n_shards", self.n_shards)
            kwargs.setdefault("nbytes", self.nbytes)
            kwargs.setdefault("key", self.key)
        return ShardedSession(local=local, **kwargs)


class ShardedSession:
    """Incremental reconciliation of a sharded local set against a
    :class:`ShardedStream`, one decoder per shard, one batched device
    decode per grow step.

    A thin S-unit wrapper over the engine's
    :class:`~repro_torch.protocol.engine.PeerState` — validation, absorb,
    shape-bucketed batched dispatch, per-unit overflow fallback and
    termination all live in :mod:`repro_torch.protocol.engine`.

    Parameters
    ----------
    local: the local side as a :class:`ShardedStream` (each shard's encoder
        is subtracted from the matching remote shard), or None to decode S
        raw shard streams (recovers the remote sets themselves).
    n_shards, nbytes, key: partition geometry — inferred from ``local``
        when given.  Both ends must agree on all three (the wire payload
        carries ``n_shards`` and each frame carries ``nbytes``; mismatches
        raise :class:`~repro_torch.protocol.engine.ProtocolError`).
    pacing: per-shard window schedule.  Policies are stateless (a pure
        function of that shard's progress), so one instance drives all
        shards independently; default is the session-standard doubling
        schedule.
    max_m: abort bound on any single shard's stream consumption.
    backend: "device" | "host" | "auto".  "device" (the default) decodes
        all shards that received symbols in ONE
        :func:`repro_torch.kernels.ops.decode_device_batched` call per grow
        step on ``device``; a shard whose ``max_diff`` overflows falls back
        to the exact host peel for that shard only (counted in
        :attr:`host_fallbacks`), and stays **pinned to the host**
        afterwards — a later ``set_backend("device")`` will not re-dispatch
        a residual already known to exceed the device buffers.
    max_diff: per-shard bound on the device decoder's fixed recovered-item
        buffers (sharding divides the difference ~uniformly, so this can be
        ~d/S plus slack rather than d).
    device: where the device engine runs — "cuda" (the default; raises
        without CUDA) or "cpu" (the kernels' plain torch versions).

    Invariants: windows must arrive in order per shard (overlap with
    already-consumed symbols is trimmed, gaps raise); each shard terminates
    on its own ρ(0)=1 signal; ``decoded`` is the conjunction over shards.
    """

    def __init__(self, local: ShardedStream | None = None,
                 n_shards: int | None = None, nbytes: int | None = None,
                 pacing: Pacing | None = None, key=None,
                 max_m: int = 1 << 22, backend: str = "device",
                 max_diff: int | None = None, device="cuda"):
        if local is not None:
            n_shards = local.n_shards if n_shards is None else n_shards
            nbytes = local.nbytes if nbytes is None else nbytes
            key = local.key if key is None else key
            if n_shards != local.n_shards:
                raise ValueError(f"n_shards={n_shards} but local partition "
                                 f"has {local.n_shards}")
        if n_shards is None or nbytes is None:
            raise ValueError("need n_shards and nbytes (or a local "
                             "ShardedStream to infer them from)")
        key = DEFAULT_KEY if key is None else key
        self.n_shards = n_shards
        self.nbytes = nbytes
        self.key = key
        # the ENGINE owns the device path so all units (here: shards)
        # batch into one dispatch
        self._peer = PeerState(
            nbytes=nbytes, key=key,
            locals_=[local.shards[s].encoder if local else None
                     for s in range(n_shards)],
            pacing=pacing or Exponential(block=8, growth=2.0),
            max_m=max_m, backend=backend, max_diff=max_diff, sharded=True,
            device=device)
        self._shards = self._peer.units

    # -- state --------------------------------------------------------------
    @property
    def backend(self) -> str:
        return self._peer.backend

    def set_backend(self, backend: str) -> None:
        """Switch the decode engine; safe between grow steps (both engines
        maintain identical per-shard decoder state).  Shards that already
        overflowed the device buffers stay pinned to the host."""
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
    def max_diff(self) -> int | None:
        return self._peer.max_diff

    @property
    def bytes_received(self) -> int:
        return self._peer.bytes_received

    @property
    def host_fallbacks(self) -> int:
        """Shard windows peeled on the host although the backend is
        "device" (``max_diff`` overflows and pinned shards)."""
        return self._peer.host_fallbacks

    @property
    def grow_steps(self) -> int:
        return self._peer.grow_steps

    @property
    def decoded(self) -> bool:
        """True once every shard has hit its ρ(0)=1 termination signal."""
        return self._peer.decoded

    @property
    def symbols_received(self) -> int:
        return self._peer.symbols_received

    # -- pull protocol ------------------------------------------------------
    def requests(self) -> list[tuple[int, int, int]]:
        """Next window [lo, hi) per still-undecoded shard; [] when done.

        Each shard's window size comes from the shared pacing policy
        applied to *that shard's* progress — settled shards drop out of the
        list, hot shards keep growing.  Raises ``RuntimeError`` if any
        shard exceeds ``max_m`` without decoding.
        """
        return self._peer.requests()

    def offer_payload(self, data: bytes) -> bool:
        """Consume one merged wire payload (all shards' frames), then run
        ONE batched decode over every shard that received symbols.
        Returns ``decoded``."""
        execute_round(ingest_payload(self._peer, data))
        return self.decoded

    def offer_windows(self, windows) -> bool:
        """Feed ``(shard, symbols, start)`` windows (the in-process peer of
        :meth:`offer_payload`), absorbing every window first and then
        decoding all touched shards in one batched step.  Validation is
        all-or-nothing: every window is checked (shard id, order,
        geometry) before ANY state mutates, so a rejected round can be
        corrected and retried without losing symbols.  Returns
        ``decoded``."""
        return offer_round(self._peer, windows)

    # -- outcome ------------------------------------------------------------
    def result(self):
        """(only_remote, only_local) uint32 word arrays, shards merged."""
        rem = [u.decoder.result()[0] for u in self._shards]
        loc = [u.decoder.result()[1] for u in self._shards]
        return np.concatenate(rem), np.concatenate(loc)

    def report(self) -> ShardedReport:
        return build_sharded_report(self._peer)


def run_sharded_session(stream: ShardedStream, session: ShardedSession,
                        wire: bool = True,
                        backend: str | None = None) -> ShardedReport:
    """Drive ``session`` to completion against a :class:`ShardedStream`.

    Each round trip gathers every undecoded shard's window request, answers
    all of them with one merged payload (``wire=True``, the native sharded
    mode — exactly the bytes two networked peers exchange) or with
    in-process zero-copy windows (``wire=False``), and hands them to the
    session, which decodes all touched shards in one batched step — a
    single-peer, non-pipelined
    :class:`~repro_torch.protocol.engine.ReconcileEngine` loop.
    ``backend`` switches the session's engine first, like
    :meth:`ShardedSession.set_backend`, and persists afterwards.

    Both ends must run the identical partition: mixed shard counts would
    silently mis-reconcile in-process (the wire path carries S in the
    payload header), so this function rejects them up front.
    """
    from .engine import serve
    if stream.n_shards != session.n_shards:
        raise ProtocolError(f"partition mismatch: stream has "
                            f"{stream.n_shards} shards, session "
                            f"{session.n_shards}")
    return serve([(stream, session)], wire=wire, backend=backend,
                 pipeline=False)[0]
