"""Peeling decoder (paper §3) — vectorized host path + device dispatch.

Port of ``repro/core/decoder.py``.  A coded symbol is *pure* when its
checksum equals the keyed hash of its sum; its sum is then a source symbol.
Peeling finds every pure symbol, dedupes recovered items by checksum, XORs
each item out of its whole mapped-index chain, and repeats.  Success ⇔ all
symbols end empty.

``backend`` selects the peel engine: ``"device"`` (the default — the
:mod:`repro_torch.kernels.peel` wave decoder on ``device``, ``"cuda"``
unless the caller passes ``device="cpu"``, which runs the kernels' plain
torch versions), ``"host"`` (the reference's exact numpy engine), or
``"auto"`` (device iff ``torch.cuda.is_available()``).  A device decode
that overflows its ``max_diff`` buffers falls back to the host engine and
says so in ``PeelResult.host_fallbacks``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .encoder import _xor_accumulate
from .hashing import DEFAULT_KEY, siphash24
from .mapping import map_seeds, walk_chains
from .symbols import CodedSymbols

BACKENDS = ("host", "device", "auto")


def resolve_backend(backend: str) -> str:
    """Map "auto" to "device" when CUDA is available, "host" elsewhere."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if backend != "auto":
        return backend
    return "device" if torch.cuda.is_available() else "host"


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises if it is CUDA and no CUDA
    device is present (the port never drops to the CPU on its own)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "the kernels' plain torch versions")
    return device


@dataclasses.dataclass
class PeelResult:
    items: np.ndarray    # (r, L) uint32 recovered source symbols
    sides: np.ndarray    # (r,) int8 — +1 exclusive to A, −1 exclusive to B
    success: bool        # all source symbols recovered (symbols all empty)
    rounds: int
    host_fallbacks: int = 0  # 1 when a device decode overflowed max_diff


def peel(sym: CodedSymbols, key=DEFAULT_KEY, max_rounds: int = 10_000,
         backend: str = "device", max_diff: int | None = None,
         device="cuda") -> PeelResult:
    if resolve_backend(backend) == "device":
        res = _peel_device(sym, key, max_rounds, max_diff, device)
        if res is not None:
            return res
        # max_diff overflow — redecode exactly on the host, counted
        res = _peel_host(sym, key, max_rounds)
        res.host_fallbacks = 1
        return res
    return _peel_host(sym, key, max_rounds)


def _peel_device(sym, key, max_rounds, max_diff, device) -> PeelResult | None:
    """Device wave decode; None when the max_diff bound overflowed."""
    from repro_torch.kernels.ops import decode_device, host_symbols_to_device
    res = decode_device(*host_symbols_to_device(sym, device),
                        nbytes=sym.nbytes, key=key, max_diff=max_diff,
                        max_rounds=max_rounds, device=device)
    if res.overflow:
        return None
    return PeelResult(res.items, res.sides, res.success, res.rounds)


def _peel_host(sym: CodedSymbols, key, max_rounds: int) -> PeelResult:
    sym = sym.copy()
    m = sym.m
    rec_items = []
    rec_sides = []
    rec_hashes = np.zeros(0, np.uint64)
    rounds = 0
    # candidate indices to re-test for purity (all, initially)
    cand = np.arange(m, dtype=np.int64)
    while rounds < max_rounds and cand.size:
        rounds += 1
        h = siphash24(sym.sums[cand], key, sym.nbytes)
        pure = cand[(h == sym.checks[cand]) & (sym.counts[cand] != 0)]
        if pure.size == 0:
            break
        items = sym.sums[pure]
        hashes = sym.checks[pure]
        sides = np.sign(sym.counts[pure]).astype(np.int8)
        # dedupe: one item may be pure at several indices simultaneously,
        # and must not re-enter once recovered in an earlier wave
        _, first = np.unique(hashes, return_index=True)
        items, hashes, sides = items[first], hashes[first], sides[first]
        fresh = ~np.isin(hashes, rec_hashes)
        items, hashes, sides = items[fresh], hashes[fresh], sides[fresh]
        if items.shape[0] == 0:
            break
        rec_hashes = np.concatenate([rec_hashes, hashes])
        rec_items.append(items)
        rec_sides.append(sides)
        # XOR every recovered item out of its whole chain
        seeds = map_seeds(items, key, sym.nbytes)
        touched = _remove_chains(sym, items, hashes, sides, seeds, key)
        cand = np.unique(touched)
    items = np.concatenate(rec_items) if rec_items else np.zeros((0, sym.L), np.uint32)
    sides = np.concatenate(rec_sides) if rec_sides else np.zeros(0, np.int8)
    success = bool(sym.is_empty().all())
    return PeelResult(items, sides, success, rounds)


def _remove_chains(sym: CodedSymbols, items, hashes, sides, seeds, key):
    """XOR items out of all their mapped indices < m.  Returns touched rows."""
    nxt = np.zeros(items.shape[0], np.int64)
    state = seeds.astype(np.uint64).copy()

    def remove(live, idx):
        _xor_accumulate(sym.sums, sym.checks, sym.counts, idx, items[live],
                        hashes[live], -sides[live].astype(np.int64))

    return walk_chains(nxt, state, sym.m, remove)


def reconcile(sym_a: CodedSymbols, sym_b: CodedSymbols, key=DEFAULT_KEY,
              backend: str = "device", max_diff: int | None = None,
              device="cuda") -> PeelResult:
    """Decode A △ B from equal-length symbol prefixes of A and B."""
    return peel(sym_a.subtract(sym_b), key, backend=backend,
                max_diff=max_diff, device=device)
