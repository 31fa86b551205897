"""Incremental stream decoding (paper §4.1 protocol).

Port of ``repro/core/stream.py``.

Alice streams coded symbols; Bob subtracts his own (locally generated)
symbols index-wise and peels as symbols arrive, terminating as soon as
symbol 0 empties (ρ(0)=1 ⇒ it is decoded last).  Already-recovered items are
XOR-ed out of newly arriving symbols by extending their mapping chains — the
decoder mirror of the encoder's incrementality.

With ``backend="device"`` (the default) the per-window peel runs through
the :mod:`repro_torch.kernels.peel` wave decoder on ``device`` instead of
the numpy loop: the
residual prefix goes to the device, recovered items and the peeled residual
come back, and the host keeps only the chain bookkeeping that extends
recovered items into future windows.  Both engines maintain the identical
``work``/recovered state, so the backend can be switched between windows.
A device decode that overflows ``max_diff`` peels the window on the host
instead and counts it in ``host_fallbacks``.
"""
from __future__ import annotations

import numpy as np

import torch

from .decoder import resolve_backend, resolve_device
from .encoder import Encoder, _xor_accumulate
from .hashing import DEFAULT_KEY, siphash24
from .mapping import map_seeds, walk_chains
from .symbols import CodedSymbols


class StreamDecoder:
    """Decodes A △ B from an incrementally received prefix of A's stream.

    ``local`` is Bob's encoder for his set B (its prefix is extended in lock
    step and subtracted).  Pass ``local=None`` to decode a raw set stream.
    ``backend``: "device" | "host" | "auto" peel engine, the device one on
    ``device`` (``"cuda"`` unless the caller passes ``"cpu"``; a missing
    CUDA device raises here); ``max_diff`` bounds the device decoder's
    recovered-item buffers (the default — the prefix length — cannot
    overflow; see :func:`repro_torch.kernels.ops.decode_device`).
    ``host_fallbacks`` counts the windows a device decoder peeled on the
    host because a device decode overflowed ``max_diff``.
    """

    def __init__(self, nbytes: int, local: Encoder | None = None,
                 key=DEFAULT_KEY, backend: str = "device",
                 max_diff: int | None = None, device="cuda"):
        self.nbytes = nbytes
        self.key = key
        self.local = local
        self.backend = resolve_backend(backend)
        self.device = resolve_device(device) if self.backend == "device" \
            else torch.device(device)
        self.max_diff = max_diff
        self.host_fallbacks = 0
        self.work = CodedSymbols.zeros(0, nbytes)
        self.rec_items = np.zeros((0, (nbytes + 3) // 4), np.uint32)
        self.rec_hashes = np.zeros(0, np.uint64)
        self.rec_sides = np.zeros(0, np.int8)
        # chain positions of recovered items at index == self.work.m
        self._rnext = np.zeros(0, np.int64)
        self._rstate = np.zeros(0, np.uint64)
        self.symbols_received = 0
        self.decoded_at: int | None = None  # symbols used at first decode

    # ------------------------------------------------------------------
    @property
    def decoded(self) -> bool:
        if self.work.m == 0:
            return False
        return bool(self.work.is_empty()[0])

    def receive(self, sym: CodedSymbols) -> bool:
        """Feed symbols [m, m+sym.m) of A's stream.  Returns `decoded`."""
        old, m = self.absorb(sym)
        if self.backend == "device":
            self._peel_device(old, m)
        else:
            self.peel_window(old, m)
        return self.mark_decoded()

    def absorb(self, sym: CodedSymbols) -> tuple[int, int]:
        """Ingest a window without peeling: subtract the local symbols,
        append to the residual ``work`` prefix, and extend every already-
        recovered item's chain through the new rows.

        Returns ``(old, new)`` — the prefix length before and after —
        for a later :meth:`peel_window` / batched device decode.  Splitting
        ingest from peel is what lets a sharded session absorb every
        shard's frame first and then decode all shards in one batched
        device call (not ported yet); plain sessions use :meth:`receive`,
        which is ``absorb`` + peel + :meth:`mark_decoded`.
        """
        old = self.work.m
        if self.local is not None:
            loc = self.local.window(old, old + sym.m)
            sym = sym.subtract(loc)
        self.work = self.work.concat(sym.copy())
        self.symbols_received = self.work.m
        m = self.work.m
        # extend recovered items' chains through the new rows
        self._walk(self.rec_items, self.rec_hashes, self.rec_sides,
                   self._rnext, self._rstate, m)
        return old, m

    def peel_window(self, old: int, m: int) -> None:
        """Host-peel rows [old, m) of the residual (plus whatever their
        removals touch) — the exact engine, also the per-shard overflow
        fallback of the batched device path."""
        self._peel(np.arange(old, m, dtype=np.int64))

    def mark_decoded(self, at: int | None = None) -> bool:
        """Record the ρ(0)=1 termination point once; returns ``decoded``.

        ``at`` pins the recorded prefix length to the decode that actually
        produced the signal — a pipelined engine absorbs the next window
        *before* the previous decode's result lands, so at that moment
        ``symbols_received`` already includes speculative overshoot that
        the termination did not need.
        """
        done = self.decoded
        if done and self.decoded_at is None:
            self.decoded_at = self.symbols_received if at is None \
                else min(at, self.symbols_received)
        return done

    # ------------------------------------------------------------------
    def _walk(self, items, hashes, sides, nxt, state, hi):
        def remove(live, idx):
            _xor_accumulate(self.work.sums, self.work.checks,
                            self.work.counts, idx, items[live], hashes[live],
                            -sides[live].astype(np.int64))

        return walk_chains(nxt, state, hi, remove)

    def _peel(self, cand: np.ndarray) -> None:
        m = self.work.m
        while cand.size:
            cand = np.unique(cand)
            h = siphash24(self.work.sums[cand], self.key, self.nbytes)
            pure = cand[(h == self.work.checks[cand]) &
                        (self.work.counts[cand] != 0)]
            if pure.size == 0:
                return
            items = self.work.sums[pure]
            hashes = self.work.checks[pure]
            sides = np.sign(self.work.counts[pure]).astype(np.int8)
            _, first = np.unique(hashes, return_index=True)
            items, hashes, sides = items[first], hashes[first], sides[first]
            fresh = ~np.isin(hashes, self.rec_hashes)
            items, hashes, sides = items[fresh], hashes[fresh], sides[fresh]
            if items.shape[0] == 0:
                return
            n = items.shape[0]
            nxt = np.zeros(n, np.int64)
            state = map_seeds(items, self.key, self.nbytes).copy()
            cand = self._walk(items, hashes, sides, nxt, state, m)
            self.rec_items = np.concatenate([self.rec_items, items])
            self.rec_hashes = np.concatenate([self.rec_hashes, hashes])
            self.rec_sides = np.concatenate([self.rec_sides, sides])
            self._rnext = np.concatenate([self._rnext, nxt])
            self._rstate = np.concatenate([self._rstate, state])

    def _peel_device(self, old: int, m: int) -> None:
        """Wave-peel the whole residual prefix on device and merge.

        ``self.work`` already has previously recovered items removed, so
        the device decoder starts from a clean residual; it returns the
        newly recovered items plus the peeled residual, and the host walks
        each new item's chain to its first index ≥ m so later windows keep
        extending it (`_walk`).  A ``max_diff`` overflow falls back to the
        exact host peel for this window.
        """
        from repro_torch.kernels.ops import (decode_device,
                                             host_symbols_to_device)
        res = decode_device(*host_symbols_to_device(self.work, self.device),
                            nbytes=self.nbytes, key=self.key,
                            max_diff=self.max_diff, device=self.device)
        if res.overflow:
            self.host_fallbacks += 1
            self.peel_window(old, m)
            return
        self.merge_device_result(res)

    def merge_device_result(self, res) -> None:
        """Fold a successful :func:`repro_torch.kernels.ops.decode_device`
        outcome into host state: adopt
        the peeled residual as ``work`` and register each newly recovered
        item with its chain advanced to the first index ≥ the prefix length
        (so later windows keep extending it).  ``res.overflow`` must be
        False — overflowed decodes leave state untouched and the caller
        falls back to :meth:`peel_window`.

        Tail-aware: the decode may cover only a *prefix* of the current
        ``work`` (``res.residual.m ≤ work.m``) — a pipelined engine absorbs
        the next window while the device result is still in flight.  The
        rows absorbed after the dispatch are kept and each newly recovered
        item is removed from them by walking its chain through the tail,
        exactly as :meth:`absorb` does for previously recovered items.
        """
        assert not res.overflow
        if res.items.shape[0] == 0:
            return
        m0 = res.residual.m
        assert m0 <= self.work.m
        if m0 < self.work.m:
            self.work = res.residual.concat(self.work.window(m0))
        else:
            self.work = res.residual
        nxt = np.zeros(res.items.shape[0], np.int64)
        state = map_seeds(res.items, self.key, self.nbytes).copy()
        walk_chains(nxt, state, m0)  # position each chain at first idx >= m0
        # remove the new items from any tail rows and leave every chain
        # parked at the first index >= work.m for future windows
        self._walk(res.items, res.hashes, res.sides, nxt, state, self.work.m)
        self.rec_items = np.concatenate([self.rec_items, res.items])
        self.rec_hashes = np.concatenate([self.rec_hashes, res.hashes])
        self.rec_sides = np.concatenate([self.rec_sides, res.sides])
        self._rnext = np.concatenate([self._rnext, nxt])
        self._rstate = np.concatenate([self._rstate, state])

    # ------------------------------------------------------------------
    def result(self):
        """(items_exclusive_to_A, items_exclusive_to_B) as uint32 words."""
        a = self.rec_items[self.rec_sides > 0]
        b = self.rec_items[self.rec_sides < 0]
        return a, b
