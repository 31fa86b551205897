"""The traffic generator: the serving node's set and its stale replicas.

Everything comes from ``--seed`` through named, independent streams of
numpy's generator (no module-level state), so a seed gives the same sets
whatever else the run draws, in whatever order.

A configuration fixes the record layout and the node's set size; a
traffic file fixes the replica pool: how many replicas, how many records
each holds stale, and how many of them a round reconciles.  The sizes of
the pool are the same for every seed (quantiles of the traffic's law);
the seed decides which records change, their new bytes, which replica
gets which size, and which replicas each round draws.  A stale record
keeps its key and holds older value bytes, so one changed record is one
record the node alone holds and one the replica alone holds: d = 2k.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math

import numpy as np

from portbench.reference import window_ends


def rng(seed: int, stream: str) -> np.random.Generator:
    """An independent generator for ``stream`` under ``seed`` (any int)."""
    tag = int.from_bytes(hashlib.blake2b(stream.encode(),
                                         digest_size=8).digest(), "little")
    return np.random.default_rng(np.random.SeedSequence(
        [abs(int(seed)), int(seed < 0), tag]))


def records(gen: np.random.Generator, n: int, nbytes: int) -> np.ndarray:
    """(n, nbytes) uniformly random record bytes."""
    return np.frombuffer(gen.bytes(n * nbytes), np.uint8).reshape(n, nbytes)


def pool_sizes(law: dict, replicas: int) -> list[int]:
    """The stale-record count of each replica, before shuffling.

    ``law``: ``{"values": [...]}`` for a fixed list (repeated to the pool
    size), or ``{"law": "uniform" | "log_uniform", "lo", "hi"}`` for the
    midpoint quantiles of that law over the replicas, with an optional
    ``zero_share`` of replicas that are in sync.
    """
    if "values" in law:
        vals = list(law["values"])
        return [int(vals[i % len(vals)]) for i in range(replicas)]
    zeros = round(law.get("zero_share", 0.0) * replicas)
    rest = replicas - zeros
    q = (np.arange(rest) + 0.5) / max(rest, 1)
    lo, hi = float(law["lo"]), float(law["hi"])
    if law["law"] == "uniform":
        vals = lo + q * (hi + 1 - lo)
        sizes = np.floor(vals)
    elif law["law"] == "log_uniform":
        sizes = np.rint(np.exp(math.log(lo) + q * (math.log(hi) -
                                                   math.log(lo))))
    else:
        raise ValueError(f"unknown law {law['law']!r}")
    return [0] * zeros + [int(s) for s in sizes]


@dataclasses.dataclass
class Replica:
    """One stale replica: ``rows`` of the node's set are held in the
    older version ``stale`` (same key bytes, other value bytes)."""
    rows: np.ndarray     # (k,) int64 indices into the node's records
    stale: np.ndarray    # (k, nbytes) uint8

    @property
    def d(self) -> int:
        return 2 * self.rows.shape[0]


@dataclasses.dataclass
class CellData:
    node: np.ndarray          # (n, nbytes) uint8, the serving node's set
    replicas: list[Replica]


def make_cell(config: dict, traffic: dict, seed: int) -> CellData:
    """The node's set and the replica pool of one cell under ``seed``."""
    n, nbytes = int(config["records"]), int(config["record_bytes"])
    key_bytes = int(config["key_bytes"])
    node = records(rng(seed, "node"), n, nbytes)
    sizes = pool_sizes(traffic["stale_per_replica"], int(traffic["replicas"]))
    order = rng(seed, "pool").permutation(len(sizes))
    gen = rng(seed, "stale")
    pool = []
    for i in order:
        k = sizes[i]
        rows = np.sort(gen.choice(n, size=k, replace=False)).astype(np.int64)
        stale = node[rows].copy()
        stale[:, key_bytes:] = records(gen, k, nbytes - key_bytes)
        pool.append(Replica(rows, stale))
    return CellData(node, pool)


def rounds(traffic: dict, seed: int, stream: str = "rounds"):
    """The replicas each round reconciles, forever, in cycles: each cycle
    is a drawn order of the whole pool cut into rounds of
    ``peers_per_round``, so every cycle does the same work (every size of
    the pool once) whatever the seed, and only the grouping differs."""
    gen = rng(seed, stream)
    pool, peers = int(traffic["replicas"]), int(traffic["peers_per_round"])
    if pool % peers:
        raise ValueError(f"a pool of {pool} does not cut into rounds of "
                         f"{peers}")
    while True:
        order = gen.permutation(pool)
        for i in range(0, pool, peers):
            yield [int(r) for r in order[i:i + peers]]


def difference(data: CellData, replica: Replica):
    """(node-only records, replica-only records) of one replica."""
    return data.node[replica.rows], replica.stale


# Room kept above the largest difference: a session decodes near 1.35 d
# symbols, so 2.5 d holds the slowest decode with a wide margin.
MARGIN = 2.5
# The shortest stream kept warm: below it every cell's prefix is cheap.
MIN_PREFIX = 256


def stream_length(config: dict, traffic: dict) -> int:
    """Symbols of the node's stream kept warm, and each session's
    ``max_m``: one window past the first window end that holds
    :data:`MARGIN` times the largest difference of the pool (at least
    :data:`MIN_PREFIX`), since a pipelined session takes one window more
    than it decodes at.  Every session of the cell then reads a warm
    prefix, and one that has not decoded by its end fails."""
    d_max = 2 * max(pool_sizes(traffic["stale_per_replica"],
                               int(traffic["replicas"])))
    pacing = config["pacing"]
    need = max(MIN_PREFIX, math.ceil(MARGIN * d_max))
    ends = window_ends(pacing["block"], pacing["growth"], 1 << 40)
    at = next(i for i, e in enumerate(ends) if e >= need)
    return ends[at + 1]
