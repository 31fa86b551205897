#!/usr/bin/env python3
"""Smoke-test the PyTorch/CUDA port of the reconciliation system on one GPU.

Builds the port's CUDA kernels from ``src/repro_torch/csrc``, holds each
against its plain torch version on the card, and drives the port's main
path — a ``SymbolStream`` served as wire frames to a ``Session`` whose
``StreamDecoder`` wave-peels on the card — at the paper's Ethereum
state-sync geometry (92-byte records: 20 B key + 72 B value).

    python3 chip_smoke.py [--seed N]

Phases, one line each:
  1. build the kernels, one nvcc per source, all at once
  2. each kernel against its plain version on the card, bit for bit
  3. one-shot decode of d = 100,000 items at m = 160,000
  4. the slice end to end: |A| = 1,000,000 records, d = 10,000, a wire
     session with backend="device" (the main path: launch counts are read
     around this phase only)
  5. max_diff overflow: the host fallback fires, is counted, stays exact
  6. the kernels at the phase-3 shapes: card time, plain time, bound
Then the card's name and power limit, the kernels JSON line and the result
line.  Exits nonzero without CUDA, outside the repository, or on any
failed check.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

SRC = Path(__file__).resolve().parent / "src"
NBYTES = 92                 # Ethereum state record: 20 B key + 72 B value
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate
PEAK_OPS_PER_S = 67e12      # H100 SXM float32 peak outside the tensor cores;
#                             integer ALUs issue no faster, so this bounds
#                             the integer work from below
DEVICE = "cuda"
# sizes: phase 2 kernel checks, phase 3 one-shot decode, phase 4 session,
# phase 5 overflow session
N_MAP, M_MAPS, M_PURITY, N_APPLY, M_APPLY = (65_536, (1_000, 160_000,
                                            2_097_152), 160_000, 20_000,
                                            100_003)
D_ONE_SHOT, M_ONE_SHOT = 100_000, 160_000
N_SESSION, D_SESSION = 1_000_000, 10_000
N_OVERFLOW, D_OVERFLOW = 20_000, 500
KERNELS = {  # name -> (source, the TPU kernel it replaces)
    "map_indices": ("src/repro_torch/csrc/map_indices.cu",
                    "src/repro/kernels/map_indices.py:41"),
    "purity_scan": ("src/repro_torch/csrc/purity_scan.cu",
                    "src/repro/kernels/peel.py:78"),
    "iblt_apply": ("src/repro_torch/csrc/iblt_apply.cu",
                   "src/repro/kernels/peel.py:133"),
}


def say(line: str) -> None:
    print(line, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    check(a.shape == b.shape, f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    if a.numel() == 0:
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def _events_ms(fn, reps: int, backlog_cycles: int = 0) -> float:
    torch.cuda.synchronize()
    if backlog_cycles:
        torch.cuda._sleep(backlog_cycles)   # the card spins meanwhile
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> tuple[float, float]:
    """(device ms, call ms) per call of ``fn``, from CUDA events.

    Call ms times back-to-back calls as the wave loop makes them, so the
    wrapper's host overhead counts whenever it exceeds the kernel.  Device
    ms first parks the card in a spin kernel long enough for the host to
    enqueue every call, so the events see only device work (a call that
    synchronises inside still pays its host time).
    """
    for _ in range(warmup):
        fn()
    call = _events_ms(fn, reps)
    cycles = int(min(call * 1e-3 * reps * 2e9 * 1.5 + 1e6, 4e10))
    return _events_ms(fn, reps, backlog_cycles=cycles), call


def random_records(rng, n: int, nbytes: int = NBYTES) -> np.ndarray:
    """n distinct random records: the first 4 bytes are the row number."""
    raw = rng.integers(0, 256, size=(n, nbytes), dtype=np.uint8)
    raw[:, :4] = np.arange(n, dtype=np.uint32).view(np.uint8).reshape(n, 4)
    return raw


def rand_i32(rng, shape) -> torch.Tensor:
    """Random 32-bit words as an int32 tensor on DEVICE."""
    w = rng.integers(0, 2**32, size=shape, dtype=np.uint32)
    return torch.from_numpy(w.view(np.int32)).to(DEVICE)


def outputs(x) -> tuple:
    return x if isinstance(x, tuple) else (x,)


def as_set(words: np.ndarray, sides=None) -> set:
    if sides is None:
        return {r.tobytes() for r in words}
    return {(r.tobytes(), int(s)) for r, s in zip(words, sides)}


def reset_launches(mods) -> None:
    for fn in mods:
        fn.launches = 0


def timed(fn, seconds: list):
    """``fn`` that appends its wall seconds to ``seconds`` on each call."""
    def call(*args, **kw):
        t = time.perf_counter()
        out = fn(*args, **kw)
        seconds.append(time.perf_counter() - t)
        return out
    return call


# ---------------------------------------------------------------------------
def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    secs = _build.build()
    wall = time.perf_counter() - t0
    regs = []
    for name in _build.SOURCES:
        log = _build.library_path(name).with_suffix(".log")
        used = [ln.split("Used", 1)[1].strip() for ln in
                log.read_text().splitlines() if "Used" in ln] \
            if log.exists() else []
        regs.append(f"{name}: {used[0] if used else 'cached'}")
    say(f"phase 1 build: {wall:.1f} s wall ("
        + ", ".join(f"{k} {v:.1f} s" for k, v in secs.items())
        + "); ptxas " + "; ".join(regs))


def phase_kernels(rng, errs: dict) -> None:
    from repro_torch.core.hashing import DEFAULT_KEY, siphash24_pair
    from repro_torch.core.mapping import kmax
    from repro_torch.kernels.map_indices import map_indices
    from repro_torch.kernels.peel import iblt_apply, purity_scan
    from repro_torch.kernels.ref import (iblt_apply_ref, map_indices_ref,
                                         purity_ref)
    key = DEFAULT_KEY
    cases = 0
    # A: N_MAP items, L in {1, 8, 23}, three prefix lengths
    for L, nbytes in ((1, 3), (8, 32), (23, 92)):
        items = rand_i32(rng, (N_MAP, L))
        if nbytes % 4:
            items[:, -1] &= (1 << (8 * (nbytes % 4))) - 1
        for m in M_MAPS:
            K = kmax(m)
            got = map_indices(items, K=K, m=m, nbytes=nbytes, key=key)
            want = map_indices_ref(items, K=K, m=m, nbytes=nbytes, key=key)
            for g, w in zip(got, want):
                e = max_abs_err(g, w)
                check(e == 0, f"map_indices L={L} m={m}: max |err| {e}")
                errs["map_indices"] = max(errs["map_indices"], e)
            cases += 1
    # B: random symbols, then planted pure ones (both signs)
    mp, L = M_PURITY, 23
    sums, checks = rand_i32(rng, (mp, L)), rand_i32(rng, (mp, 2))
    counts = torch.from_numpy(rng.integers(-3, 4, size=(mp, 1),
                                           dtype=np.int32)).to(DEVICE)
    for planted in (False, True):
        if planted:
            rows = torch.from_numpy(rng.permutation(mp)[:mp // 5]).to(DEVICE)
            hi, lo = siphash24_pair(sums[rows], key, NBYTES)
            checks[rows] = torch.stack([hi, lo], dim=1)
            counts[rows] = torch.where(rows % 2 == 0, 1, -1).to(
                torch.int32)[:, None]
        got = purity_scan(sums, checks, counts, key=key, nbytes=NBYTES)
        want = purity_ref(sums, checks, counts, key=key, nbytes=NBYTES)
        e = max_abs_err(got, want)
        check(e == 0, f"purity_scan planted={planted}: max |err| {e}")
        errs["purity_scan"] = max(errs["purity_scan"], e)
        if planted:
            check(bool((got[rows] != 0).all()), "planted pure rows missed")
        cases += 1
    # C: m not a multiple of 256, rows [m, mp) zero, sides in {-1, 0, 1}
    m = M_APPLY
    mp = ((m + 255) // 256) * 256
    items = rand_i32(rng, (N_APPLY, L))
    idx, chk = map_indices(items, K=kmax(mp), m=m, nbytes=NBYTES, key=key)
    sides = torch.from_numpy(rng.integers(-1, 2, size=N_APPLY,
                                          dtype=np.int32)).to(DEVICE)
    got = iblt_apply(items, idx, chk, sides, m=m, m_out=mp)
    want = iblt_apply_ref(items, idx, chk, sides, m=m, m_out=mp)
    for gg, w in zip(got, want):
        e = max_abs_err(gg, w)
        check(e == 0, f"iblt_apply: max |err| {e}")
        errs["iblt_apply"] = max(errs["iblt_apply"], e)
        check(bool((gg[m:] == 0).all()), "iblt_apply wrote rows >= m")
    cases += 1
    say(f"phase 2 kernels vs plain: {cases} cases bit-equal "
        f"(max |err| {errs})")


def phase_one_shot(rng, kernels):
    from repro_torch.core import encode
    from repro_torch.core.hashing import bytes_to_words
    from repro_torch.kernels.ops import decode_device, host_symbols_to_device
    d, m = D_ONE_SHOT, M_ONE_SHOT
    recs = random_records(rng, d)
    a, b = recs[: d // 2], recs[d // 2:]
    t0 = time.perf_counter()
    diff = encode(a, NBYTES, m).subtract(encode(b, NBYTES, m))
    enc_s = time.perf_counter() - t0
    args = host_symbols_to_device(diff, DEVICE)
    reset_launches(kernels)
    t0 = time.perf_counter()
    res = decode_device(*args, nbytes=NBYTES, device=DEVICE)
    dec_s = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in kernels}
    want = as_set(bytes_to_words(a, NBYTES), np.ones(len(a))) | \
        as_set(bytes_to_words(b, NBYTES), -np.ones(len(b)))
    check(res.success and not res.overflow, "one-shot decode failed")
    check(as_set(res.items, res.sides) == want, "one-shot: wrong difference")
    # the card against the plain torch twins on a small input
    small = encode(a[:250], NBYTES, 1100).subtract(encode(b[:250], NBYTES,
                                                          1100))
    on_card = decode_device(*host_symbols_to_device(small, DEVICE),
                            nbytes=NBYTES, device=DEVICE)
    on_cpu = decode_device(*host_symbols_to_device(small, "cpu"),
                           nbytes=NBYTES, device="cpu")
    check(on_card.success and on_card.items.shape[0] == 500,
          "small decode failed")
    for f in ("items", "hashes", "sides"):
        check(np.array_equal(getattr(on_card, f), getattr(on_cpu, f)),
              f"card and plain decode differ in {f}")
    check((on_card.rounds, on_card.success) == (on_cpu.rounds, on_cpu.success)
          and all(np.array_equal(getattr(on_card.residual, f),
                                 getattr(on_cpu.residual, f))
                  for f in ("sums", "checks", "counts")),
          "card and plain decode differ in rounds or residual")
    say(f"phase 3 one-shot decode: d={d} m={m} waves={res.rounds} "
        f"decode {dec_s:.3f} s (host encode {enc_s:.1f} s); exact, "
        f"no overflow; launches {launches}; card == plain decode at d=500")
    return diff


def phase_session(rng, kernels) -> dict:
    from repro_torch.core import Encoder
    from repro_torch.core.hashing import bytes_to_words
    from repro_torch.kernels import ops
    from repro_torch.protocol import Session, SymbolStream, run_session
    n, d = N_SESSION, D_SESSION
    recs = random_records(rng, n + d // 2)
    alice = recs[:n]                                   # fresh replica
    bob = np.concatenate([recs[: n - d // 2], recs[n:]])   # stale replica
    t0 = time.perf_counter()
    stream = SymbolStream.from_items(alice, NBYTES)
    local = Encoder(NBYTES)
    local.add_items(bob)
    setup_s = time.perf_counter() - t0
    session = Session(local=local, backend="device", device=DEVICE)
    # where the session's time goes: serving frames (Alice's encoder),
    # absorbing them (Bob's encoder, subtraction, chain walks), decoding
    serve_s, absorb_s, decode_s = [], [], []
    stream.frames = timed(stream.frames, serve_s)
    session.decoder.absorb = timed(session.decoder.absorb, absorb_s)
    real = ops.decode_device
    ops.decode_device = timed(real, decode_s)
    reset_launches(kernels)
    t0 = time.perf_counter()
    try:
        rep = run_session(stream, session, wire=True)
    finally:
        ops.decode_device = real
    session_s = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in kernels}
    check(as_set(rep.only_remote) ==
          as_set(bytes_to_words(recs[n - d // 2: n], NBYTES)),
          "session: wrong remote-only records")
    check(as_set(rep.only_local) == as_set(bytes_to_words(recs[n:], NBYTES)),
          "session: wrong local-only records")
    check(session.host_fallbacks == 0, "session fell back to the host")
    check(all(v > 0 for v in launches.values()),
          f"a kernel never launched on the main path: {launches}")
    say(f"phase 4 session: |A|={n} d={d} symbols_used={rep.symbols_used} "
        f"overhead={rep.overhead(d):.3f} bytes_on_wire={rep.bytes_received} "
        f"session {session_s:.2f} s = serve {sum(serve_s):.2f} s + absorb "
        f"{sum(absorb_s):.2f} s + device decode {sum(decode_s):.3f} s over "
        f"{len(decode_s)} windows + rest (set-up {setup_s:.1f} s); "
        f"host_fallbacks=0; launches {launches}")
    return launches


def phase_overflow(rng) -> None:
    from repro_torch.core import Encoder
    from repro_torch.core.hashing import bytes_to_words
    from repro_torch.protocol import Session, SymbolStream, run_session
    n, d = N_OVERFLOW, D_OVERFLOW
    recs = random_records(rng, n + d // 2)
    alice = recs[:n]
    bob = np.concatenate([recs[: n - d // 2], recs[n:]])
    local = Encoder(NBYTES)
    local.add_items(bob)
    session = Session(local=local, backend="device", max_diff=64,
                      device=DEVICE)
    rep = run_session(SymbolStream.from_items(alice, NBYTES), session,
                      wire=True)
    check(session.host_fallbacks >= 1, "max_diff overflow did not fall back")
    check(rep.only_remote.shape[0] == d // 2 and
          rep.only_local.shape[0] == d - d // 2,
          "overflow session: wrong difference size")
    check(as_set(rep.only_remote) ==
          as_set(bytes_to_words(recs[n - d // 2: n], NBYTES)),
          "overflow session: wrong records")
    say(f"phase 5 max_diff overflow: d={d} max_diff=64 host_fallbacks="
        f"{session.host_fallbacks}, exact")


def _hash_ops(L: int) -> int:
    """32-bit integer operations of one SipHash-2-4 over L words."""
    siprounds = 2 * (L // 2) + 2 + 4
    return siprounds * 14 * 2 + 8      # 14 u64 ops a round, 2 int32 each


def _bound(nbytes: float, ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def phase_times(diff, launches: dict, errs: dict) -> list:
    from repro_torch.core.hashing import DEFAULT_KEY
    from repro_torch.core.mapping import kmax
    from repro_torch.kernels.map_indices import map_indices
    from repro_torch.kernels.ops import host_symbols_to_device
    from repro_torch.kernels.peel import (PeelState, _stage1, iblt_apply,
                                          purity_scan)
    from repro_torch.kernels.ref import (iblt_apply_ref, map_indices_ref,
                                         purity_ref)
    key = DEFAULT_KEY
    sums, checks, counts = host_symbols_to_device(diff, DEVICE)
    m, L = sums.shape
    mp = ((m + 255) // 256) * 256
    K = kmax(mp)

    def pad(x):
        out = torch.zeros((mp, x.shape[1]), dtype=torch.int32, device=DEVICE)
        out[:m] = x
        return out

    def empty(*shape):
        return torch.zeros(shape, dtype=torch.int32, device=DEVICE)

    state = PeelState(pad(sums), pad(checks), pad(counts.reshape(m, 1)),
                      empty(0, L), empty(0, 2), empty(0), 0, True, False, 0)
    # the first wave of the phase-3 decode: the largest map / apply inputs
    rows, side, n_new, _ = _stage1(state, cap=mp, max_diff=mp, key=key,
                                   nbytes=NBYTES)
    items, chks = state.sums[rows], state.checks[rows]
    idx, _ = map_indices(items, K=K, m=m, nbytes=NBYTES, key=key)
    valid = int(((idx >= 0) & (idx < m)).sum())
    nonempty = int((state.counts != 0).sum())

    runs = {
        "purity_scan": (
            lambda: purity_scan(*state[:3], key=key, nbytes=NBYTES),
            lambda: purity_ref(*state[:3], key=key, nbytes=NBYTES),
            _bound(mp * (L + 3) * 4 + mp * 4, nonempty * (_hash_ops(L) + 4)),
            f"mp={mp} L={L}"),
        "map_indices": (
            lambda: map_indices(items, K=K, m=m, nbytes=NBYTES, key=key),
            lambda: map_indices_ref(items, K=K, m=m, nbytes=NBYTES, key=key),
            _bound(n_new * (L + K + 2) * 4,
                   n_new * 2 * _hash_ops(L) + valid * 28),
            f"n={n_new} L={L} K={K} m={m}"),
        "iblt_apply": (
            lambda: iblt_apply(items, idx, chks, side, m=m, m_out=mp),
            lambda: iblt_apply_ref(items, idx, chks, side, m=m, m_out=mp),
            _bound(n_new * (L + K + 3) * 4 + mp * (L + 3) * 4,
                   valid * (L + 3)),
            f"n={n_new} K={K} m={m} valid slots={valid}"),
    }
    out = []
    for name, (kern, plain, (bound_ms, bound_by), shape) in runs.items():
        for g, w in zip(outputs(kern()), outputs(plain())):
            errs[name] = max(errs[name], max_abs_err(g, w))
        check(errs[name] == 0, f"{name} disagrees at phase-3 shapes")
        (ms, call_ms), (plain_ms, _) = cuda_ms(kern), cuda_ms(plain, 5, 1)
        source, replaces = KERNELS[name]
        out.append({"name": name, "route": "cuda", "source": source,
                    "replaces": replaces, "launches": launches[name],
                    "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "library_ms": None})
        say(f"phase 6 {name} [{shape}]: {ms:.4f} ms on the card "
            f"({call_ms:.4f} ms a call from Python), plain {plain_ms:.3f} "
            f"ms, bound {bound_ms:.4f} ms ({bound_by}), {launches[name]} "
            f"launches on the main path")
    return out


# ---------------------------------------------------------------------------
def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from the "
              "repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels.map_indices import map_indices
    from repro_torch.kernels.peel import iblt_apply, purity_scan
    kernels = (map_indices, purity_scan, iblt_apply)
    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    errs = dict.fromkeys(KERNELS, 0)

    phase_build()
    phase_kernels(rng, errs)
    diff = phase_one_shot(rng, kernels)
    launches = phase_session(rng, kernels)
    phase_overflow(rng)
    rows = phase_times(diff, launches, errs)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    say(f"total {time.perf_counter() - t0:.1f} s")
    say(smi)
    say(json.dumps({"kernels": rows}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
