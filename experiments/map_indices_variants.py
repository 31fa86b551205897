#!/usr/bin/env python3
"""Time the designs tried for the map_indices kernel on one GPU.

    python3 experiments/map_indices_variants.py [--seed N]

Builds ``experiments/map_indices_variants.cu`` with the package's nvcc
flags into ``build/experiments/`` and times, with CUDA events as
``chip_smoke.cuda_ms`` does, at three main-path shapes: the first wave of
``chip_smoke.py``'s one-shot decode (phase 3: ~25,000 items, K = 74,
m = 160,000), a sharded-serving wave (6,948 random items, K = 57,
m = 2,048: the shape of phase 7's largest wave) and one encode of phase 6
(10^6 records, K = 66, m = 20,480), and at three more waves of K = 57
(12,000, 2,000 and 500 items: a wave between the launch rule's
thresholds and the later, smaller waves of a decode), all of 92-byte
records (L = 23):

1. the form the kernel had before ``csrc/map_indices.cuh`` (step 1; at
   the three main-path shapes): (a) as is, (b) its index stores made
   coalesced (the same bytes, column-major), (c) the chain only, no
   SipHash, (d) SipHash only, no chain;
2. the shipped kernel through the package's wrapper (the launch shape of
   ``launch_shape``), and the shipped body at other launch shapes (items
   a block, lanes an item);
3. at the three main-path shapes, the experiment's copy of the shipped
   body at the shipped settings and with one knob changed: a one-lane
   item's two SipHashes as two calls instead of ``siphash24_x2``, 8 lanes, the items staged in shared
   memory, no checksum, other ring depths.  Each knob is to be read
   against the wrapper timed in the same call; the copy at the shipped
   settings shows what the copying alone moves.

The form before and every shipped variant must equal the wrapper's output
bit for bit, and the wrapper its plain twin.  Prints one line a timing and
the card's name and power limit, and writes
``build/experiments/map_indices_variants.json``.  Exits nonzero without
CUDA.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

BUILD = ROOT / "build" / "experiments"
L = 23
PRIOR = {0: "(a) as is", 1: "(b) coalesced index stores",
         2: "(c) chain only, no SipHash", 3: "(d) SipHash only, no chain"}


def build_library():
    from repro_torch.kernels import _build
    BUILD.mkdir(parents=True, exist_ok=True)
    so = BUILD / "map_indices_variants.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
           str(Path(__file__).with_suffix(".cu"))]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}\n{proc.stderr}")
    (BUILD / "map_indices_variants.log").write_text(proc.stdout + proc.stderr)
    lib = ctypes.CDLL(str(so))
    P, I, LL, U64 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                     ctypes.c_uint64)
    lib.mv_prior.argtypes = [I, P, LL, I, I, I, LL, U64, U64, U64, U64, P,
                             P, P]
    lib.mv_launch.argtypes = [I, P, LL, I, I, I, LL, U64, U64, U64, U64, P,
                              P, I, LL, P]
    lib.mv_body.argtypes = [I, I, I, I, I, P, LL, I, I, I, LL, U64, U64,
                            U64, U64, P, P, I, LL, P]
    lib.mv_prior.restype = lib.mv_launch.restype = lib.mv_body.restype = I
    return lib


def checked(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: launch failed, cudaError {rc}")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("map_indices_variants: CUDA is not available", file=sys.stderr)
        return 1
    from repro_torch.core import encode
    from repro_torch.core.hashing import DEFAULT_KEY, map_key
    from repro_torch.core.mapping import kmax
    from repro_torch.kernels import map_indices as mi
    lib = build_library()
    key, mk = DEFAULT_KEY, map_key(DEFAULT_KEY)
    sms, optin = mi._card(torch.cuda.current_device())
    rng = np.random.default_rng(args.seed)
    results = {"sms": sms, "smem_optin": optin}
    stream = torch.cuda.current_stream().cuda_stream

    def time_it(tag: str, fn, want=None) -> None:
        got = fn()
        torch.cuda.synchronize()
        if want is not None and not all(
                torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"{tag}: differs from the shipped kernel")
        ms, call_ms = cs.cuda_ms(fn)
        results[tag] = {"ms": ms, "call_ms": call_ms,
                        "equal": None if want is None else True}
        print(f"{tag:64s} {ms:9.4f} ms  (call {call_ms:8.4f})", flush=True)

    def outputs(n, K):
        return (torch.empty((n, K), dtype=torch.int32, device="cuda"),
                torch.empty((n, 2), dtype=torch.int32, device="cuda"))

    def prior(items, K, m, variant):
        n = items.shape[0]

        def run():
            idx, chk = outputs(n, K)
            checked(lib.mv_prior(variant, items.data_ptr(), n, L, 4 * L,
                                 K, m, *key, *mk, idx.data_ptr(),
                                 chk.data_ptr(), stream), "prior")
            return idx, chk
        return run

    def launch(items, K, m, *, bn, lanes):
        n = items.shape[0]
        smem = 4 * (3 + bn * K)

        def run():
            idx, chk = outputs(n, K)
            checked(lib.mv_launch(lanes, items.data_ptr(), n, L, 4 * L, K, m,
                                  *key, *mk, idx.data_ptr(), chk.data_ptr(),
                                  bn, smem, stream), "shipped body")
            return idx, chk
        return run

    def body(items, K, m, *, bn, lanes, stage=False, depth=4,
             checksum=True, pair=True):
        n = items.shape[0]
        smem = 4 * max(3 + bn * K, bn * L if stage else 0)

        def run():
            idx, chk = outputs(n, K)
            checked(lib.mv_body(lanes, depth, int(stage), int(checksum),
                                int(pair), items.data_ptr(), n, L, 4 * L, K,
                                m, *key, *mk, idx.data_ptr(),
                                chk.data_ptr() if checksum else None, bn,
                                smem, stream), "variant body")
            return (idx, chk) if checksum else (idx,)
        return run

    def shape(name, items, K, m, *, main=True):
        n = items.shape[0]
        rule = mi.launch_shape(n, K, sms=sms, smem_optin=optin)
        bn, lanes, _ = rule
        print(f"{name}: n={n} K={K} m={m} rule (bn, lanes, smem)={rule}",
              flush=True)
        results[f"{name}/rule"] = rule
        want = mi.map_indices(items, K=K, m=m, nbytes=4 * L, key=key)
        plain = mi.map_indices_ref(items, K=K, m=m, nbytes=4 * L, key=key)
        if not all(torch.equal(g, w) for g, w in zip(want, plain)):
            raise AssertionError(f"{name}: shipped differs from its twin")
        valid = int((want[0] < m).sum())
        results[f"{name}/valid_slots"] = valid
        print(f"{name}: valid slots {valid} of {n * K}", flush=True)
        if main:
            time_it(f"{name}/prior {PRIOR[0]}", prior(items, K, m, 0), want)
            for v in (1, 2, 3):
                time_it(f"{name}/prior {PRIOR[v]}", prior(items, K, m, v))
        wrapper = lambda: mi.map_indices(items, K=K, m=m, nbytes=4 * L,
                                         key=key)
        time_it(f"{name}/shipped (wrapper)", wrapper, want)
        for b, g in ((128, 1), (64, 1), (32, 1), (64, 2), (32, 2), (32, 4),
                     (16, 4)):
            if g <= mi.MAX_LANES:
                time_it(f"{name}/shipped bn={b} lanes={g}",
                        launch(items, K, m, bn=b, lanes=g), want)
            else:  # a lane count the shipped body no longer has
                time_it(f"{name}/copy bn={b} lanes={g}",
                        body(items, K, m, bn=b, lanes=g), want)
        if main:
            time_it(f"{name}/copy at the shipped settings",
                    body(items, K, m, bn=bn, lanes=lanes), want)
            time_it(f"{name}/copy bn=128 lanes=1, two siphash24 calls",
                    body(items, K, m, bn=128, lanes=1, pair=False), want)
            time_it(f"{name}/copy bn=16 lanes=8",
                    body(items, K, m, bn=16, lanes=8), want)
            time_it(f"{name}/copy, items staged",
                    body(items, K, m, bn=bn, lanes=lanes, stage=True), want)
            for b, g in ((bn, lanes), (128, 1)):
                time_it(f"{name}/copy bn={b} lanes={g}, no checksum",
                        body(items, K, m, bn=b, lanes=g, checksum=False),
                        want[:1])
            for depth in (1, 2, 8):
                time_it(f"{name}/copy, ring depth {depth}",
                        body(items, K, m, bn=bn, lanes=lanes, depth=depth),
                        want)
        time_it(f"{name}/shipped (wrapper), again", wrapper, want)
        if main:
            time_it(f"{name}/prior {PRIOR[0]}, again", prior(items, K, m, 0),
                    want)

    # -- the first wave of the phase-3 one-shot decode -----------------------
    d, m = cs.D_ONE_SHOT, cs.M_ONE_SHOT
    recs = cs.random_records(rng, d)
    diff = encode(recs[: d // 2], cs.NBYTES, m).subtract(
        encode(recs[d // 2:], cs.NBYTES, m))
    loop, state, wave = cs.first_wave(diff)
    mp, rows = loop.mp, wave.rows[:int(wave.count)]
    shape("first wave", state.sums[rows], kmax(mp), mp)

    # -- a sharded-serving wave and one encode of phase 6 --------------------
    wn, wmp = 6_948, 2_048
    shape("wave", cs.rand_i32(rng, (wn, L)), kmax(wmp), wmp)
    for n in (12_000, 2_000, 500):
        shape(f"wave n={n}", cs.rand_i32(rng, (n, L)), kmax(wmp), wmp,
              main=False)
    shape("encode", cs.words_on_card(cs.random_records(rng, cs.N_ENCODE)),
          kmax(cs.M_ENCODE), cs.M_ENCODE)

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    results["card"] = card
    print(f"SMs {sms}, opt-in shared memory {optin} B")
    print(card)
    (BUILD / "map_indices_variants.json").write_text(
        json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
