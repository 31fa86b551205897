"""Closed-loop rounds: one serving node brings a batch of replicas in sync.

A round is one ``repro_torch`` :class:`ReconcileEngine` (pipelined) with
one :class:`Session` a replica, each registered against the node's single
:class:`SymbolStream` with ``wire=True``, run until every session has
decoded.  The next round starts when the last one ends.

At set-up the node's stream is encoded to the stream length the cell can
request, and every replica's encoder is the node's, copied, with the
replica's stale records swapped in (``remove_items``/``add_items``: the
cached prefix is updated by linearity, as a node keeps it in a
deployment).  So a round reads warm caches only, and nothing is encoded
from scratch inside the window.
"""
from __future__ import annotations

import copy
import dataclasses
import time

from portbench import generator


@dataclasses.dataclass
class Report:
    """What one session reported, as the program gave it."""
    replica: int
    only_remote: object      # (r, L) uint32 words
    only_local: object       # (s, L) uint32 words
    symbols_used: int
    bytes_received: int
    host_fallbacks: int


@dataclasses.dataclass
class Round:
    start_ns: int
    end_ns: int
    replicas: list
    reports: list            # [Report] or [] when the round raised
    ticks: int
    dispatches: int
    host_reads: int
    error: str | None = None

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


class Driver:
    """The system under test for one cell, built from the generated sets."""

    def __init__(self, config: dict, traffic: dict,
                 data: generator.CellData, seed: int, device: str):
        from repro_torch.core.encoder import Encoder
        from repro_torch.kernels import peel
        from repro_torch.protocol import (Exponential, ReconcileEngine,
                                          Session, SymbolStream)
        from repro_torch.protocol import engine
        self._engine_mod, self._peel = engine, peel
        self._Engine, self._Session = ReconcileEngine, Session
        self.traffic, self.seed, self.device = traffic, seed, device
        self.max_m = generator.stream_length(config, traffic)
        self.pacing = Exponential(**config["pacing"])
        key = tuple(int(k, 16) for k in config["session_key"])
        node = Encoder(int(config["record_bytes"]), key)
        node.add_items(data.node)
        node.extend(self.max_m)
        self.stream = SymbolStream(node)
        self.locals = []
        for rep in data.replicas:
            local = copy.deepcopy(node)
            if rep.rows.size:
                local.remove_items(data.node[rep.rows])
                local.add_items(rep.stale)
            self.locals.append(local)

    # -- one round --------------------------------------------------------
    def round(self, replicas: list) -> Round:
        t0 = time.perf_counter_ns()
        engine = self._Engine(pipeline=True)
        sessions = []
        for i in replicas:
            sess = self._Session(local=self.locals[i], pacing=self.pacing,
                                 max_m=self.max_m, backend="device",
                                 device=self.device)
            engine.register(self.stream, sess, wire=True)
            sessions.append(sess)
        reads = self._peel.read_back.count
        error, reports = None, []
        try:
            done = engine.run()
        except RuntimeError as exc:      # a session that never decoded
            error = f"{type(exc).__name__}: {exc}"
        else:
            reports = [Report(i, r.only_remote, r.only_local, r.symbols_used,
                              r.bytes_received, s.host_fallbacks)
                       for i, r, s in zip(replicas, done, sessions)]
        return Round(t0, time.perf_counter_ns(), list(replicas), reports,
                     engine.ticks, engine.dispatches,
                     self._peel.read_back.count - reads, error)

    def warm(self) -> None:
        """``warmup_rounds`` rounds, drawn apart from the window's: the
        kernels loaded, the wave loop's CUDA graphs captured for the
        shapes those rounds use, the allocators grown."""
        draws = generator.rounds(self.traffic, self.seed, "warmup")
        for _ in range(int(self.traffic["warmup_rounds"])):
            self.round(next(draws))

    def window(self, seconds: float) -> list:
        """Rounds back to back until ``seconds`` have passed; the cycle
        under way then runs to its end and counts, so the window holds
        every replica of the pool equally often."""
        draws = generator.rounds(self.traffic, self.seed)
        cycle = int(self.traffic["replicas"]) // \
            int(self.traffic["peers_per_round"])
        out = []
        deadline = time.perf_counter_ns() + int(seconds * 1e9)
        while not out or out[-1].end_ns < deadline or len(out) % cycle:
            out.append(self.round(next(draws)))
        return out

    # -- tracing ------------------------------------------------------------
    def span_targets(self) -> list:
        """(owner, attribute, label, counter) of the calls the traced run
        times: serving a window as wire frames (counting its symbols),
        ingesting a frame, dispatching a tick's decode, polling it, and
        waiting for its results."""
        eng = self._engine_mod
        return [
            (self.stream, "frames", "serve", lambda a, k: a[1] - a[0]),
            (eng, "ingest_frames", "ingest", None),
            (eng, "execute_round", "dispatch", None),
            (eng.PendingRound, "poll", "poll", None),
            (eng.PendingRound, "finish", "wait", None),
        ]

    def close(self) -> None:
        """Drop the program's host state: the stream and the encoders."""
        self.stream = self.locals = None
