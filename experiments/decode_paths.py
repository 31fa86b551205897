#!/usr/bin/env python3
"""Time the port's device decode on the main paths' traffic, for the port
in any source tree, on one GPU.

    python3 experiments/decode_paths.py [--src DIR] [--seed N] [--reps R]

``DIR`` is the ``src`` directory of a checkout (default: this one's), so
two commits can be timed in one call on one card: unpack the other commit
into a directory that git ignores and run parent, change, change, parent.
The inputs come from ``chip_smoke.py``'s sizes and the seed, the same for
every tree.  Prints one line of seconds, each the median of ``R`` runs,
cold and warm: cold runs start with no wave graph kept from an earlier
decode (``peel._programs``, where the tree has it), warm ones keep them:

1. ``one-shot``: ``decode_device`` of phase 3 (d = 100,000 at m =
   160,000);
2. ``session``: phase 4's session, its 12 decodes replayed (each
   window's residual as it reached ``decode_device``), summed;
3. ``ckpt``: the same for a session with the checkpoint repair's traffic
   (phase 8: 30,833 records of 16 B, 3,096 replaced, the pacing of
   ``sync_from_peer``), on random records instead of a store;
4. ``sharded``: phase 7's serving (8 shards, 3 replicas) by a serial
   engine, the seconds inside its decode calls (dispatch, polls,
   read-back): its first run (cold) and its second (warm).

Then the card's name and power limit.  Exits nonzero without CUDA.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

CKPT_RECORDS, CKPT_NBYTES = 30_833, 16


def timed(fn, seconds: list):
    def call(*args, **kw):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kw)
        finally:
            seconds.append(time.perf_counter() - t0)
    return call


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--src", default=str(ROOT / "src"))
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--reps", type=int, default=5)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("decode_paths: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.core import Encoder, Sketch, encode
    from repro_torch.kernels import _build, ops, peel
    from repro_torch.protocol import (Exponential, ReconcileEngine, Session,
                                      ShardedStream, SymbolStream,
                                      run_session)
    _build.build()
    rng = np.random.default_rng(args.seed)
    d, m = cs.D_ONE_SHOT, cs.M_ONE_SHOT
    recs = cs.random_records(rng, d)
    diff = encode(recs[: d // 2], cs.NBYTES, m).subtract(
        encode(recs[d // 2:], cs.NBYTES, m))

    windows = {"session": [], "ckpt": []}
    real = ops.decode_device

    def recorder(name):
        def record(*a, **kw):
            windows[name].append(([x.clone() for x in a], kw))
            return real(*a, **kw)
        return record

    n, dd = cs.N_SESSION, cs.D_SESSION
    recs = cs.random_records(rng, n + dd // 2)
    local = Encoder(cs.NBYTES)
    local.add_items(np.concatenate([recs[: n - dd // 2], recs[n:]]))
    ops.decode_device = recorder("session")
    run_session(SymbolStream.from_items(recs[:n], cs.NBYTES),
                Session(local=local, backend="device"), wire=True)
    c_recs = cs.random_records(rng, CKPT_RECORDS + cs.CKPT_DIFF, CKPT_NBYTES)
    peer = SymbolStream.from_items(c_recs[:CKPT_RECORDS], CKPT_NBYTES)
    stale = Session(
        local=Sketch.from_items(np.concatenate(
            [c_recs[: CKPT_RECORDS - cs.CKPT_DIFF], c_recs[CKPT_RECORDS:]]),
            CKPT_NBYTES),
        pacing=Exponential(block=16, growth=1.5), max_m=1 << 20)
    ops.decode_device = recorder("ckpt")
    while (win := stale.request()) is not None:
        stale.offer_bytes(peer.frames(*win))
    ops.decode_device = real
    assert len(stale.report().only_remote) == cs.CKPT_DIFF

    def forget() -> None:
        for kept in getattr(peel, "_programs", {}).values():
            kept._free.clear()

    def one_shot():
        a = ops.host_symbols_to_device(diff, "cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = ops.decode_device(*a, nbytes=cs.NBYTES)
        assert res.success and len(res.items) == d
        return time.perf_counter() - t0

    def replay(name):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for a, kw in windows[name]:
            ops.decode_device(*a, **kw)
        return time.perf_counter() - t0

    paths = {"one-shot": one_shot, "session": lambda: replay("session"),
             "ckpt": lambda: replay("ckpt")}
    secs = {(k, mode): [] for k in paths for mode in ("cold", "warm")}
    for _ in range(args.reps):
        for k, run in paths.items():
            forget()
            secs[k, "cold"].append(run())
            secs[k, "warm"].append(run())

    # phase 7's serving by a serial engine: the seconds in decode calls
    n, d = cs.N_SHARDED, cs.D_SHARDED
    half, step = d // 2, d // 4
    recs = cs.random_records(rng, n + half + step * (cs.REPLICAS - 1))
    stream = ShardedStream.from_items(recs[:n], cs.NBYTES, n_shards=cs.SHARDS)
    replicas = []
    for r in range(cs.REPLICAS):
        lost = slice(n - half - r * step, n - r * step)
        added = slice(n + r * step, n + r * step + half)
        replicas.append(ShardedStream.from_items(
            np.concatenate([recs[: lost.start], recs[lost.stop: n],
                            recs[added]]), cs.NBYTES, n_shards=cs.SHARDS))
    Pending = ops.PendingBatchedDecode
    saved = (ops.decode_device_batched_start, Pending.ready, Pending.wait)
    for mode in ("cold", "warm"):
        calls = []
        ops.decode_device_batched_start = timed(saved[0], calls)
        Pending.ready, Pending.wait = timed(saved[1], calls), timed(saved[2],
                                                                    calls)
        engine = ReconcileEngine(pipeline=False)
        for local in replicas:
            engine.register(stream, stream.session(local=local), wire=True)
        reports = engine.run()
        ops.decode_device_batched_start = saved[0]
        Pending.ready, Pending.wait = saved[1], saved[2]
        assert all(len(r.only_remote) == half for r in reports)
        secs["sharded", mode] = [sum(calls)]

    med = {k: sorted(v)[len(v) // 2] for k, v in secs.items()}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    print(f"{args.src}: " + "; ".join(
        f"{k} cold {med[k, 'cold']:.4f} s, warm {med[k, 'warm']:.4f} s"
        for k in ("one-shot", "session", "ckpt", "sharded")) +
        f" (the session {len(windows['session'])} decodes, the ckpt "
        f"{len(windows['ckpt'])}, the sharded engine {len(calls)} decode "
        f"calls; medians of {args.reps}, sharded one run each); {card}",
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
