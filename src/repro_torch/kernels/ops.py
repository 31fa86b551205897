"""Public device API: the decoder pipeline around the kernels.

Port of the decode half of ``repro/kernels/ops.py``.  ``decode_device``
(pad → wave peeling, :mod:`.peel`) is the device counterpart of
``repro_torch.core.peel`` and recovers the identical difference.  It runs on
``device`` — ``"cuda"`` by default, where every wave launches the CUDA
kernels — and raises when that device is absent; ``device="cpu"`` runs the
same waves on the kernels' plain torch versions (what the tests use).

The device layout is the reference's: sums ``(m, L)`` 32-bit words,
checks ``(m, 2)`` (hi, lo) halves, counts int32; words travel as int32 bit
patterns.  The device encoder (``encode_device``, kernel ``iblt_encode``)
and the batched decode are not ported yet.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.decoder import resolve_device
from repro_torch.core.hashing import DEFAULT_KEY
from repro_torch.core.mapping import kmax
from repro_torch.core.symbols import CodedSymbols

from .peel import peel_waves


def _as_i32(x, device: torch.device) -> torch.Tensor:
    """numpy (32-bit words or counts) or torch -> int32 tensor on device."""
    if isinstance(x, np.ndarray):
        if x.dtype == np.uint32:
            x = x.view(np.int32)
        x = torch.from_numpy(np.ascontiguousarray(x, dtype=np.int32))
    return x.to(device=device, dtype=torch.int32).contiguous()


def _as_u32_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    return np.asarray(x).astype(np.int32, copy=False).view(np.uint32)


def device_symbols_to_host(sums, checks, counts, nbytes: int) -> CodedSymbols:
    """Device layout (torch or numpy) -> host :class:`CodedSymbols`."""
    sums = _as_u32_np(sums).copy()
    checks = _as_u32_np(checks)
    counts = counts.cpu().numpy() if isinstance(counts, torch.Tensor) \
        else np.asarray(counts)
    c64 = (checks[:, 0].astype(np.uint64) << np.uint64(32)) | \
        checks[:, 1].astype(np.uint64)
    return CodedSymbols(sums, c64, counts.reshape(-1).astype(np.int64), nbytes)


def host_symbols_to_device(sym: CodedSymbols, device="cuda"):
    """CodedSymbols -> (sums (m, L), checks (m, 2), counts (m,)) int32
    tensors on ``device``; inverse of :func:`device_symbols_to_host`."""
    device = resolve_device(device)
    checks = np.empty((sym.m, 2), np.uint32)
    checks[:, 0] = (sym.checks >> np.uint64(32)).astype(np.uint32)
    checks[:, 1] = (sym.checks & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return (_as_i32(sym.sums, device), _as_i32(checks, device),
            _as_i32(sym.counts.astype(np.int32), device))


class DeviceDecodeResult(NamedTuple):
    """Host-materialized outcome of :func:`decode_device`."""
    items: np.ndarray     # (r, L) uint32 — recovered source symbols
    hashes: np.ndarray    # (r,) uint64   — their checksums
    sides: np.ndarray     # (r,) int8     — +1 remote-only, -1 local-only
    success: bool         # all symbols emptied (difference fully recovered)
    overflow: bool        # max_diff exceeded — decode stopped mid-peel
    rounds: int           # peel waves executed
    residual: CodedSymbols  # symbols after all removals


def decode_device(sums, checks, counts, *, nbytes: int, key=DEFAULT_KEY,
                  max_diff: int | None = None, max_rounds: int = 10_000,
                  K: int | None = None, block_n: int = 256,
                  block_m: int = 256, device="cuda") -> DeviceDecodeResult:
    """Wave-peel difference symbols on ``device`` (paper §3 decode).

    Inputs are device-layout difference symbols — sums (m, L), checks
    (m, 2), counts (m,), as numpy arrays or tensors (e.g. from
    :func:`host_symbols_to_device`).

    As in the reference, the prefix is padded to ``mp``, a multiple of
    ``block_m``; ``K`` defaults to ``kmax(mp)`` (chains truncated there,
    < 1e-12 probability) and ``max_diff`` to ``mp``, which cannot overflow:
    each recovery empties the symbol it was pure at.  A tighter bound may
    end in ``overflow=True`` with the overflowing wave unapplied; the
    caller then falls back to the host decoder.
    """
    device = resolve_device(device)
    sums = _as_i32(sums, device)
    m, L = sums.shape
    if m == 0:
        return DeviceDecodeResult(
            np.zeros((0, L), np.uint32), np.zeros(0, np.uint64),
            np.zeros(0, np.int8), True, False, 0,
            CodedSymbols.zeros(0, nbytes))
    mp = ((m + block_m - 1) // block_m) * block_m
    if K is None:
        K = kmax(mp)
    D = mp if max_diff is None else max(int(max_diff), 1)

    def pad(x):
        out = torch.zeros((mp, x.shape[1]), dtype=torch.int32, device=device)
        out[:m] = x
        return out

    state, success = peel_waves(
        pad(sums), pad(_as_i32(checks, device)),
        pad(_as_i32(counts, device).reshape(m, 1)), m=m, nbytes=nbytes,
        key=key, max_diff=D, K=K, max_rounds=max_rounds, block_n=block_n)

    items = _as_u32_np(state.rec_items).copy()
    rchk = _as_u32_np(state.rec_checks)
    hashes = (rchk[:, 0].astype(np.uint64) << np.uint64(32)) | \
        rchk[:, 1].astype(np.uint64)
    sides = state.rec_sides.cpu().numpy().astype(np.int8)
    residual = device_symbols_to_host(state.sums[:m], state.checks[:m],
                                      state.counts[:m, 0], nbytes)
    return DeviceDecodeResult(items, hashes, sides, success, state.overflow,
                              state.rounds, residual)
