"""The Rateless IBLT mapping (paper §4.1–4.2).

Port of ``repro/core/mapping.py``.  A source symbol maps to coded-symbol
index ``i`` with probability ``ρ(i) = 1/(1 + αi)``, α = 0.5; every symbol
maps to index 0.  Later indices come from *skip sampling*: from index ``i``
jump ``g = max(1, ⌈(1.5+i)·((1−r)^{−1/2} − 1)⌉)`` with ``r ∈ [0,1)`` the top
24 bits of an xorshift64 PRNG seeded by the symbol's keyed hash.

Determinism contract: the host (numpy) chain, the torch chain and the CUDA
kernel (``csrc/map_indices.cu``) produce identical index sequences.  The
real arithmetic is float32 with one op sequence on every path and no
fusable multiply-add, so IEEE-754 rounding gives bit-equal results.

The torch chain differs from the reference's jnp chain in one respect: it
walks the index in int64, so a jump past int32 (``m`` above ~5.2·10⁵) ends
the chain at ``m`` exactly as the host chain does, where the jnp chain
wraps negative.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .hashing import map_key, shr, siphash24

ALPHA = 0.5

_U64 = np.uint64


def rho(i):
    """Mapping probability ρ(i) = 1/(1 + αi)."""
    return 1.0 / (1.0 + ALPHA * np.asarray(i, dtype=np.float64))


def expected_degree(m: int) -> float:
    """E[#mapped indices among the first m] = Σ_{i<m} ρ(i)."""
    i = np.arange(m, dtype=np.float64)
    return float(np.sum(1.0 / (1.0 + ALPHA * i)))


def kmax(m: int) -> int:
    """Static bound on mapped-index count within the first m coded symbols
    (a Bernstein tail at μ + 8√μ + 10, μ ≈ 2·ln m; ≪ 1e-12)."""
    mu = 2.0 * math.log(m + 2.0)
    return int(math.ceil(mu + 8.0 * math.sqrt(mu) + 10.0))


# ---------------------------------------------------------------------------
# Host path: numpy, identical to the reference.
# ---------------------------------------------------------------------------
def _xs64_np(s: np.ndarray) -> np.ndarray:
    s = s ^ (s << _U64(13))
    s = s ^ (s >> _U64(7))
    s = s ^ (s << _U64(17))
    return s


def map_seeds(words: np.ndarray, key, nbytes: int | None = None) -> np.ndarray:
    """Per-item mapping-PRNG seed (uint64, nonzero) from the session key."""
    s = siphash24(words, map_key(key), nbytes)
    return s | _U64(1)


def _jump_np(idx: np.ndarray, state: np.ndarray):
    """One skip-sampling step (vectorized).  idx int64, state uint64."""
    state = _xs64_np(state)
    rbits = (state >> _U64(40)).astype(np.float32)        # top 24 bits
    r = rbits * np.float32(2.0 ** -24)                    # uniform [0,1)
    t = np.float32(1.0) / np.sqrt(np.float32(1.0) - r)    # (1-r)^(-1/2)
    u = t - np.float32(1.0)
    f = np.float32(1.5) + idx.astype(np.float32)
    g = np.ceil(f * u).astype(np.int64)
    g = np.maximum(g, 1)
    return idx + g, state


def advance_np(idx, state, limit):
    """Advance chains until every idx >= limit.  Yields (active_sel, idx)
    batches for the encoder.  idx/state are modified in place."""
    while True:
        active = np.flatnonzero(idx < limit)
        if active.size == 0:
            return
        yield active, idx[active]
        nidx, nstate = _jump_np(idx[active], state[active])
        idx[active] = nidx
        state[active] = nstate


def walk_chains(nxt, state, hi, visit=None):
    """Advance every chain position in place until ``nxt >= hi``.

    ``visit(live, idx)`` is called per round with the still-walking row
    selector and their current mapped indices.  Returns the concatenation
    of all visited indices — the rows a decoder must re-test for purity.
    """
    touched = []
    while True:
        live = np.flatnonzero(nxt < hi)
        if live.size == 0:
            break
        idx = nxt[live]
        touched.append(idx.copy())
        if visit is not None:
            visit(live, idx)
        nn, ns = _jump_np(idx, state[live])
        nxt[live] = nn
        state[live] = ns
    return np.concatenate(touched) if touched else np.zeros(0, np.int64)


def item_indices_np(seed: int, m: int) -> np.ndarray:
    """All mapped indices < m for one item (exact chain).  int64 array."""
    out = []
    idx = np.zeros(1, dtype=np.int64)
    state = np.array([seed], dtype=np.uint64)
    while idx[0] < m:
        out.append(int(idx[0]))
        idx, state = _jump_np(idx, state)
    return np.asarray(out, dtype=np.int64)


def indices_matrix_np(seeds: np.ndarray, m: int, K: int | None = None) -> np.ndarray:
    """(n,) seeds -> (n, K) mapped indices < m, padded with m (vectorized)."""
    if K is None:
        K = kmax(m)
    n = seeds.shape[0]
    out = np.full((n, K), m, dtype=np.int64)
    idx = np.zeros(n, dtype=np.int64)
    state = seeds.astype(np.uint64).copy()
    for k in range(K):
        live = idx < m
        out[live, k] = idx[live]
        if not live.any():
            break
        idx, state = _jump_np(idx, state)
    return out


# ---------------------------------------------------------------------------
# Torch path: the same chain on u64 bits held in int64, on any device.
# ---------------------------------------------------------------------------
def _xs64_t(s: torch.Tensor) -> torch.Tensor:
    s = s ^ (s << 13)
    s = s ^ shr(s, 7)
    s = s ^ (s << 17)
    return s


def _jump_t(idx: torch.Tensor, state: torch.Tensor):
    """Twin of the reference's ``_jump_j``: one skip-sampling step.

    idx int64 (no overflow at any m below 2**31), state u64 bits in int64.
    """
    state = _xs64_t(state)
    one = torch.ones((), dtype=torch.float32, device=idx.device)
    rbits = shr(state, 40).to(torch.float32)              # top 24 bits
    r = rbits * (2.0 ** -24)
    t = torch.div(one, torch.sqrt(one - r))               # IEEE div, sqrt
    u = t - one
    f = idx.to(torch.float32) + 1.5
    g = torch.ceil(f * u).to(torch.int64).clamp_min(1)
    return idx + g, state


def indices_matrix_t(seeds: torch.Tensor, m: int, K: int | None = None) -> torch.Tensor:
    """Twin of ``indices_matrix_j`` with ``indices_matrix_np``'s semantics:
    (n,) u64 seeds in int64 -> (n, K) int32 indices < m, pad = m."""
    if K is None:
        K = kmax(m)
    idx = torch.zeros(seeds.shape[0], dtype=torch.int64, device=seeds.device)
    state = seeds
    cols = []
    for _ in range(K):
        cols.append(idx)
        nidx, state = _jump_t(idx, state)
        idx = nidx.clamp_max(m)          # a chain past m stays at m
    return torch.stack(cols, dim=1).to(torch.int32)
