"""Public device API: the encoder and decoder pipelines around the kernels.

Port of ``repro/kernels/ops.py``.  ``encode_device`` (map_indices →
iblt_encode) is the device counterpart of ``repro_torch.core.encode`` and
produces bit-identical coded symbols; ``decode_device`` (pad → wave
peeling, :mod:`.peel`) is the counterpart of ``repro_torch.core.peel`` and
recovers the identical difference; ``decode_device_batched`` peels U
independent units — shards, or peer×shard pairs of the protocol engine —
in one wave loop.  Each runs on ``device`` — ``"cuda"`` by default, where
every step launches the CUDA kernels — and raises when that device is
absent; ``device="cpu"`` runs the same steps on the kernels' plain torch
versions (what the tests use).

The device layout is the reference's: sums ``(m, L)`` 32-bit words,
checks ``(m, 2)`` (hi, lo) halves, counts int32; words travel as int32 bit
patterns.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.decoder import resolve_device
from repro_torch.core.hashing import DEFAULT_KEY
from repro_torch.core.mapping import kmax
from repro_torch.core.symbols import CodedSymbols

from .iblt_encode import iblt_encode
from .map_indices import map_indices
from .peel import WaveLoop, upload


def _as_i32(x, device: torch.device) -> torch.Tensor:
    """numpy (32-bit words or counts) or torch -> int32 tensor on device;
    numpy arrays reach the card without a host wait."""
    if isinstance(x, np.ndarray):
        if x.dtype == np.uint32:
            x = x.view(np.int32)
        x = upload(np.ascontiguousarray(x, dtype=np.int32), device)
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


def encode_device(items, *, m: int, nbytes: int | None = None,
                  key=DEFAULT_KEY, K: int | None = None, block_n: int = 256,
                  block_m: int = 256, device="cuda"):
    """items (n, L) 32-bit words (numpy uint32 or an int32 tensor) ->
    (sums (m, L), checks (m, 2), counts (m,)) int32 tensors on ``device``.

    Kernel A maps every item, kernel D accumulates; chains are truncated at
    ``K`` (default ``kmax(m)``, truncation probability < 1e-12), so at the
    default the symbols equal the host ``encode``'s bit for bit.  There are
    no pad rows — the kernels take any n — so ``block_n`` and ``block_m``
    change nothing and stay for the reference's signature; its
    ``interpret`` and ``mapping`` switches have no meaning here.
    """
    device = resolve_device(device)
    items = _as_i32(items, device)
    L = items.shape[1]
    nbytes = 4 * L if nbytes is None else nbytes
    K = kmax(m) if K is None else K
    idxs, chks = map_indices(items, K=K, m=m, nbytes=nbytes, key=key)
    sums, checks, counts = iblt_encode(items, idxs, chks, m=m)
    return sums, checks, counts[:, 0]


class DeviceDecodeResult(NamedTuple):
    """Host-materialized outcome of :func:`decode_device`."""
    items: np.ndarray     # (r, L) uint32 — recovered source symbols
    hashes: np.ndarray    # (r,) uint64   — their checksums
    sides: np.ndarray     # (r,) int8     — +1 remote-only, -1 local-only
    success: bool         # all symbols emptied (difference fully recovered)
    overflow: bool        # max_diff exceeded — decode stopped mid-peel
    rounds: int           # peel waves executed
    residual: CodedSymbols  # symbols after all removals


def _empty_result(L: int, nbytes: int) -> DeviceDecodeResult:
    return DeviceDecodeResult(
        np.zeros((0, L), np.uint32), np.zeros(0, np.uint64),
        np.zeros(0, np.int8), True, False, 0, CodedSymbols.zeros(0, nbytes))


def _results(out: dict, ms, mp: int, nbytes: int) -> list:
    """One :class:`DeviceDecodeResult` per prefix length in ``ms`` from a
    :meth:`WaveLoop.finish` outcome (units past ``len(ms)`` are padding
    and never read)."""
    items = out["rec_items"].view(np.uint32)
    rchk = out["rec_checks"].view(np.uint32)
    hashes = (rchk[:, 0].astype(np.uint64) << np.uint64(32)) | \
        rchk[:, 1].astype(np.uint64)
    sides = out["rec_sides"].astype(np.int8)
    starts = np.concatenate([[0], np.cumsum(out["n_rec"])])
    res = []
    for u, m in enumerate(ms):
        mine = slice(starts[u], starts[u + 1])     # in recovery order
        rows = slice(u * mp, u * mp + m)
        residual = device_symbols_to_host(out["sums"][rows],
                                          out["checks"][rows],
                                          out["counts"][rows, 0], nbytes)
        res.append(DeviceDecodeResult(
            items[mine], hashes[mine], sides[mine], bool(out["success"][u]),
            bool(out["overflow"][u]), int(out["rounds"]), residual))
    return res


def _tile(m: int, block_m: int) -> int:
    return ((m + block_m - 1) // block_m) * block_m


def decode_device(sums, checks, counts, *, nbytes: int, key=DEFAULT_KEY,
                  max_diff: int | None = None, max_rounds: int = 10_000,
                  K: int | None = None, block_n: int = 256,
                  block_m: int = 256, device="cuda") -> DeviceDecodeResult:
    """Wave-peel difference symbols on ``device`` (paper §3 decode).

    Inputs are device-layout difference symbols — sums (m, L), checks
    (m, 2), counts (m,), as numpy arrays or tensors (e.g. from
    :func:`host_symbols_to_device` or an :func:`encode_device`
    subtraction).

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
        return _empty_result(L, nbytes)
    mp = _tile(m, block_m)
    K = kmax(mp) if K is None else K
    D = mp if max_diff is None else max(int(max_diff), 1)

    def pad(x):
        out = torch.zeros((mp, x.shape[1]), dtype=torch.int32, device=device)
        out[:m] = x
        return out

    loop = WaveLoop(
        pad(sums), pad(_as_i32(checks, device)),
        pad(_as_i32(counts, device).reshape(m, 1)), m=[m], nbytes=nbytes,
        key=key, max_diff=D, K=K, max_rounds=max_rounds, block_n=block_n)
    return PendingBatchedDecode(loop, [m], nbytes).wait()[0]


class PendingBatchedDecode:
    """A :func:`decode_device_batched_start` dispatch, before its results
    are read back to the host.

    The wave loop (:class:`~repro_torch.kernels.peel.WaveLoop`) keeps its
    state and its stop test on the device and enqueues each wave as one
    replay of a CUDA graph.  The dispatch enqueues its first
    ``WAVES_PER_CHUNK`` waves and records a CUDA event; nothing is read
    back, so the dispatch returns while the card runs them.  ``ready()``
    is non-blocking: while the event has not fired it returns False; once
    it has, it reads the stop flag, and if the loop goes on it enqueues as
    many waves again as it has enqueued so far (the caller goes on with
    other work, so waves past the loop's end cost only the card's idle
    time) and returns False.  It returns True once the flag says done.
    ``wait()`` drives the loop to its end a chunk at a time and
    materializes one :class:`DeviceDecodeResult` per unit, in input order.
    ``host_reads`` counts the dispatch's waits for the card: one per flag
    read, and one for the results, so at most
    ceil(waves / WAVES_PER_CHUNK) + 1.

    On the CPU the same loop runs on the kernels' plain versions; nothing
    runs there while the host does other work, so the dispatch drives the
    loop to its end and ``ready()`` is True at once, as for the reference
    on the CPU.
    """

    __slots__ = ("_loop", "_ms", "_nbytes", "_event", "_results")

    def __init__(self, loop, ms, nbytes: int, results=None):
        self._loop = loop
        self._ms = ms
        self._nbytes = nbytes
        self._event = None
        self._results = results
        if loop is None:
            return
        if loop.state.sums.device.type == "cuda":
            self._enqueue()
        else:
            loop.run()

    def _enqueue(self, waves: int | None = None) -> None:
        """Enqueue the loop's next ``waves`` waves (default a chunk) on the
        card and an event after them."""
        self._loop.step(waves)
        self._event = torch.cuda.Event()
        self._event.record(torch.cuda.current_stream(
            self._loop.state.sums.device))

    @property
    def host_reads(self) -> int:
        return self._loop.reads if self._loop is not None else 0

    def ready(self) -> bool:
        """True once the results can be read without stalling."""
        if self._results is not None or self._loop.done:
            return True
        if self._event is not None and not self._event.query():
            return False
        if self._loop.running():
            # the caller goes on with other work: keep the card busy as
            # long again as the decode has run so far
            self._enqueue(max(self._loop.enqueued, 1))
            return False
        return True

    def wait(self) -> list[DeviceDecodeResult]:
        """Materialize (blocking) — one result per input unit, in order."""
        if self._results is None:
            loop = self._loop
            while loop.running():
                self._enqueue()
            self._results = _results(loop.finish(), self._ms, loop.mp,
                                     self._nbytes)
            self._event = loop.state = None
        return self._results


def decode_device_batched_start(units, *, nbytes: int, key=DEFAULT_KEY,
                                max_diff: int | None = None,
                                max_rounds: int = 10_000, K: int | None = None,
                                block_m: int = 256,
                                pad_units: int | None = None,
                                device="cuda") -> PendingBatchedDecode:
    """Dispatch the wave decode of U units at once; read back later.

    ``units`` is a sequence of host :class:`CodedSymbols`, one residual
    prefix per unit (a shard of one session or, through the protocol
    engine, any peer×shard pair in this shape bucket).  Every unit is
    padded to the shared tile bucket ``mp = ceil(max_u m_u / block_m) ·
    block_m`` and the units lie end to end on the symbol axis (see
    :mod:`.peel`); each keeps its own prefix length.

    ``max_diff`` bounds each unit's recovered items *individually*; a unit
    that trips it freezes alone and comes back with ``overflow=True`` while
    its neighbours finish — the caller falls back to the host decoder for
    exactly those units.  The default (``mp``) cannot overflow.

    ``pad_units`` pads the unit axis with empty (m = 0) units, which find
    nothing to peel; the reference quantizes U this way to re-use one
    compiled program, and the port keeps the contract.
    """
    device = resolve_device(device)
    U = len(units)
    ms = [sym.m for sym in units]
    if U == 0 or max(ms) == 0:
        L = units[0].L if U else 0
        return PendingBatchedDecode(None, ms, nbytes, results=[
            _empty_result(L, nbytes) for _ in units])
    L = units[0].L
    if any(sym.L != L or sym.nbytes != units[0].nbytes for sym in units):
        raise ValueError("units must share one item geometry")
    Up = max(U, pad_units or 0)
    mp = _tile(max(ms), block_m)
    K = kmax(mp) if K is None else K
    D = mp if max_diff is None else max(int(max_diff), 1)
    sums = np.zeros((Up, mp, L), np.uint32)
    checks = np.zeros((Up, mp, 2), np.uint32)
    counts = np.zeros((Up, mp, 1), np.int32)
    for u, sym in enumerate(units):
        sums[u, :sym.m] = sym.sums
        checks[u, :sym.m, 0] = (sym.checks >> np.uint64(32)).astype(np.uint32)
        checks[u, :sym.m, 1] = (sym.checks &
                                np.uint64(0xFFFFFFFF)).astype(np.uint32)
        counts[u, :sym.m, 0] = sym.counts
    loop = WaveLoop(
        _as_i32(sums.reshape(Up * mp, L), device),
        _as_i32(checks.reshape(Up * mp, 2), device),
        _as_i32(counts.reshape(Up * mp, 1), device),
        m=ms + [0] * (Up - U), nbytes=nbytes, key=key, max_diff=D, K=K,
        max_rounds=max_rounds)
    return PendingBatchedDecode(loop, ms, nbytes)


def decode_device_batched(units, *, nbytes: int, key=DEFAULT_KEY,
                          max_diff: int | None = None,
                          max_rounds: int = 10_000, K: int | None = None,
                          block_m: int = 256, pad_units: int | None = None,
                          device="cuda") -> list[DeviceDecodeResult]:
    """Wave-peel U units' difference symbols in one batched decode: the
    synchronous form of :func:`decode_device_batched_start` (dispatch,
    then ``wait()``)."""
    return decode_device_batched_start(
        units, nbytes=nbytes, key=key, max_diff=max_diff,
        max_rounds=max_rounds, K=K, block_m=block_m, pad_units=pad_units,
        device=device).wait()
