"""Pacing policies: how much more of the universal stream a session pulls.

Port of ``repro/protocol/pacing.py``: plain Python, unchanged.

The stream is infinite and any prefix decodes once it is long enough
(paper §4.1), so pacing only trades *overshoot* (symbols received past the
minimal decodable prefix) against *round trips*.  The three policies here
cover the shapes the repo's former hand-rolled grow-loops used, plus the
paper's §6 deployment model:

* :class:`FixedBlock` — constant window; overshoot ≤ block − 1, most round
  trips.  What ``examples/multi_peer_sync.py`` hand-rolled.
* :class:`Exponential` — window grows with the amount already sent;
  O(log d) round trips, overshoot ≤ (growth − 1)·m.  ``growth=2`` is the
  old ``reconcile_sets`` loop (take = max(block, m)); ``growth=1.5`` is the
  old ``sync_from_peer`` loop (step = max(block, m // 2)).
* :class:`LineRate` — the paper's §6 schedule: the sender streams symbols
  continuously at line rate and the receiver ACKs termination, so one
  bandwidth-delay product of symbols is always in flight.  Pull-model
  equivalent: every window is ⌈BDP⌉ symbols; overshoot is bounded by the
  BDP regardless of the difference size.

Policies are **stateless**: :meth:`Pacing.next_take` is a pure function of
the symbols already pulled, so one instance can drive any number of
sessions — or every (peer, shard) decode unit of a multi-peer
:class:`~repro_torch.protocol.engine.ReconcileEngine`, where it is applied to
each unit's own progress independently.  Statelessness is also what lets
the engine's double-buffered tick loop compute the *next* round's
requests while the previous round's decode is still in flight: the
request depends only on the unit's stream position, never on the decode
outcome.
"""
from __future__ import annotations

import math


class Pacing:
    """Policy interface: next window size given symbols already pulled.

    Subclasses implement :meth:`next_take` as a pure (stateless) function;
    sessions call it with their current stream position before every
    request and pull exactly that many further symbols.
    """

    def next_take(self, m_sent: int) -> int:
        """Symbols to request next, given ``m_sent`` already pulled.

        Must return ≥ 1 (a session that is not decoded always needs more
        of the stream).
        """
        raise NotImplementedError

    def next_window(self, lo: int, max_m: int) -> tuple[int, int]:
        """The next stream window ``[lo, hi)`` for a unit at position
        ``lo``, clamped to the ``max_m`` consumption bound — the one
        request shape sessions and the engine both speak.

        >>> FixedBlock(8).next_window(16, 20)
        (16, 20)
        """
        return lo, min(lo + self.next_take(lo), max_m)


class FixedBlock(Pacing):
    """Constant ``block``-symbol windows.

    Minimal overshoot (≤ block − 1 symbols past the decodable prefix), one
    round trip per block — the most chatty and the most byte-frugal
    schedule.

    >>> [FixedBlock(5).next_take(m) for m in (0, 5, 80)]
    [5, 5, 5]
    """

    def __init__(self, block: int = 8):
        assert block >= 1
        self.block = block

    def next_take(self, m_sent: int) -> int:
        return self.block

    def __repr__(self):
        return f"FixedBlock({self.block})"


class Exponential(Pacing):
    """Windows growing ∝ the prefix already pulled.

    ``next_take(m) = max(block, ⌊m·(growth − 1)⌋)``: O(log d) round trips
    at the price of up to (growth − 1)·m overshoot.

    >>> exp = Exponential(block=8, growth=2.0)    # the doubling schedule
    >>> [exp.next_take(m) for m in (0, 8, 16, 100)]
    [8, 8, 16, 100]
    >>> Exponential(block=16, growth=1.5).next_take(64)
    32
    """

    def __init__(self, block: int = 8, growth: float = 2.0):
        assert block >= 1 and growth > 1.0
        self.block = block
        self.growth = growth

    def next_take(self, m_sent: int) -> int:
        return max(self.block, int(m_sent * (self.growth - 1.0)))

    def __repr__(self):
        return f"Exponential(block={self.block}, growth={self.growth})"


class LineRate(Pacing):
    """Paper §6: continuous streaming with a termination ACK one RTT away.

    ``bandwidth`` is in symbols/second (divide link bytes/s by the wire
    size ℓ + 8 + ~1 of one symbol); the in-flight window is
    ``bandwidth · rtt`` symbols, so overshoot is bounded by the BDP
    regardless of the difference size.

    >>> LineRate(bandwidth=1000, rtt=0.05).next_take(0)
    50
    """

    def __init__(self, bandwidth: float, rtt: float):
        assert bandwidth > 0 and rtt > 0
        self.bdp = max(1, math.ceil(bandwidth * rtt))

    def next_take(self, m_sent: int) -> int:
        return self.bdp

    def __repr__(self):
        return f"LineRate(bdp={self.bdp})"
