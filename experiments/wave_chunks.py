#!/usr/bin/env python3
"""Time the device wave loop at several chunk sizes on one GPU, with each
wave enqueued op by op and replayed as a CUDA graph.

    python3 experiments/wave_chunks.py [--seed N]

The wave loop (``repro_torch.kernels.peel.WaveLoop``) reads its stop flag
once every k waves (``WAVES_PER_CHUNK``).  A larger k gives the card more
work to run while the host ingests and reads the card fewer times; every
wave past the loop's end still runs on the card.  On the card the loop
captures its wave as a CUDA graph once a shape and replays it; the op by
op form (a loop whose ``_next_wave`` enqueues the wave's ops one by one)
is the loop as the host would enqueue it without the graph.  For each form and k in 1, 2, 4 and 8 this prints,
from ``chip_smoke.py``'s inputs:

1. the one-shot decode of phase 3 (d = 100,000 at m = 160,000, 13 waves):
   median seconds of ``decode_device`` over three calls, and host reads;
2. the decodes of phase 4's session, replayed (each window's residual as
   it reached ``decode_device``): their summed seconds and host reads;
3. the same for a session with the checkpoint repair's traffic (phase 8:
   30,833 records of 16 B, 3,096 replaced, the pacing of
   ``sync_from_peer``), on random records instead of a store.

Then it runs phase 7 (the 8-shard, 3-replica pipelined engine, graphs on)
at k = 1, 2 and 4, each printing its own line: decode seconds, host reads
per dispatch and the share of the card's decode time hidden behind
ingest.  Ends with the card's name and power limit.  Exits nonzero
without CUDA.
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
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

CHUNKS = (1, 2, 4, 8)
CKPT_RECORDS, CKPT_NBYTES = 30_833, 16


def session_windows(ops, run) -> list:
    """Each window's ``decode_device`` arguments, recorded while ``run()``
    drives a session on the card."""
    windows, real = [], ops.decode_device

    def record(*a, **kw):
        windows.append(([x.clone() for x in a], kw))
        return real(*a, **kw)

    ops.decode_device = record
    try:
        run()
    finally:
        ops.decode_device = real
    return windows


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("wave_chunks: CUDA is not available", file=sys.stderr)
        return 1
    from repro_torch.core import Encoder, Sketch, encode
    from repro_torch.kernels import _build, ops, peel
    from repro_torch.kernels.map_indices import map_indices
    from repro_torch.protocol import (Exponential, Session, SymbolStream,
                                      run_session)
    _build.build()
    rng = np.random.default_rng(args.seed)
    d, m = cs.D_ONE_SHOT, cs.M_ONE_SHOT
    recs = cs.random_records(rng, d)
    diff = encode(recs[: d // 2], cs.NBYTES, m).subtract(
        encode(recs[d // 2:], cs.NBYTES, m))
    # the decodes of two sessions, recorded once
    n, dd = cs.N_SESSION, cs.D_SESSION
    recs = cs.random_records(rng, n + dd // 2)
    local = Encoder(cs.NBYTES)
    local.add_items(np.concatenate([recs[: n - dd // 2], recs[n:]]))
    session = session_windows(ops, lambda: run_session(
        SymbolStream.from_items(recs[:n], cs.NBYTES),
        Session(local=local, backend="device"), wire=True))
    c_recs = cs.random_records(rng, CKPT_RECORDS + cs.CKPT_DIFF, CKPT_NBYTES)
    peer = SymbolStream.from_items(c_recs[:CKPT_RECORDS], CKPT_NBYTES)
    stale = Session(
        local=Sketch.from_items(np.concatenate(
            [c_recs[: CKPT_RECORDS - cs.CKPT_DIFF], c_recs[CKPT_RECORDS:]]),
            CKPT_NBYTES),
        pacing=Exponential(block=16, growth=1.5), max_m=1 << 20)

    def repair():
        while (win := stale.request()) is not None:
            stale.offer_bytes(peer.frames(*win))
        assert len(stale.report().only_remote) == cs.CKPT_DIFF

    ckpt = session_windows(ops, repair)
    real_loop = ops.WaveLoop

    class OpByOp(real_loop):
        def _next_wave(self):
            self._wave()

    for graph in (False, True):
        ops.WaveLoop = real_loop if graph else OpByOp
        form = "graph" if graph else "op by op"
        for k in CHUNKS:
            peel.WAVES_PER_CHUNK = k
            secs = []
            for _ in range(3):
                args_ = ops.host_symbols_to_device(diff, "cuda")
                peel.read_back.count = 0
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = ops.decode_device(*args_, nbytes=cs.NBYTES)
                secs.append(time.perf_counter() - t0)
            line = (f"{form} k={k}: one-shot decode {sorted(secs)[1]:.4f} s, "
                    f"{res.rounds} waves, {peel.read_back.count} host reads")
            for name, windows in (("session", session), ("ckpt", ckpt)):
                peel.read_back.count = 0
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for a, kw in windows:
                    ops.decode_device(*a, **kw)
                line += (f"; the {name}'s {len(windows)} decodes "
                         f"{time.perf_counter() - t0:.4f} s, "
                         f"{peel.read_back.count} host reads")
            print(line, flush=True)
    ops.WaveLoop = real_loop
    decode = (map_indices, peel.purity_scan, peel.iblt_apply)
    for k in (1, 2, 4):
        peel.WAVES_PER_CHUNK = k
        print(f"graph k={k}:", flush=True)
        cs.phase_sharded(np.random.default_rng(args.seed + 1), decode)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
