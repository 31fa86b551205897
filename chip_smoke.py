#!/usr/bin/env python3
"""Smoke-test the PyTorch/CUDA port of the reconciliation system on one GPU.

Builds the port's CUDA kernels from ``src/repro_torch/csrc``, holds each
against its plain torch version on the card, and drives the port's three
main paths at the paper's Ethereum state-sync geometry (92-byte records:
20 B key + 72 B value): a ``SymbolStream`` served as wire frames to a
``Session`` whose ``StreamDecoder`` wave-peels on the card; the device
encoder's round trip; and a ``ShardedStream`` serving several replicas
through one pipelined ``ReconcileEngine`` with batched decodes.  A fourth
main path repairs a checkpoint store the size of Qwen3-4B's (16-byte
manifest records), and ``reconcile_sets`` runs once on the card.  Last,
the model stack serves Qwen3-4B, Qwen3-30B-A3B, RWKV-6 1.6B,
RecurrentGemma-2B and Whisper-base at full width and depth in bf16, and
the training stack trains Qwen3-4B at full width and depth, then the
training driver crashes and repairs its checkpoint from a peer through
the decode kernels (a fifth main path).  Then the same training and
MoE serving run again on a device mesh over every card (DTensors placed
by the reference's specs), held against the plain paths, and the dry
run of every model cell runs on the production meshes' fake ranks.

    python3 chip_smoke.py [--seed N]

Phases, one line each:
  1. build the kernels, one nvcc per source, all at once
  2. each kernel against its plain version on the card, bit for bit
     (iblt_apply over one unit and over many; the scatter kernels, apply
     and encode, also at prefixes below, at and above their shared-memory
     table, sorted and random units, n = 1, and items too wide for one
     row of that table; map_indices also at the launch shapes its design
     branches on: n = 1, ragged blocks, K = 1, all-pad tails, short items,
     saturation past int32, several lanes an item and one, a tile that
     leaves a block few items; A, B and C also at the checkpoint records'
     width, L = 4; A and C with the live count read on the card)
  3. one-shot decode of d = 100,000 items at m = 160,000, with its host
     reads (the wave loop reads its stop flag once a chunk of waves); a
     small decode on the card twice (the second on the first's kept wave
     graph) against the plain decode
  4. main path 1: |A| = 1,000,000 records, d = 10,000, a wire session
     with backend="device"; host reads a decode
  5. max_diff overflow: the host fallback fires, is counted, stays exact
  6. main path 2: the device encoder's round trip — encode A and B
     (1,000,000 records each, d = 10,000) at m = 20,480 on the card,
     subtract there, decode; A's symbols equal the host encoder's
  7. main path 3: one 8-shard ShardedStream of the same 10⁶ records
     serving 3 replicas (d = 10,000 each, partly shared) through one
     pipelined ReconcileEngine; each dispatch runs under the sync debug
     mode "error"; host reads per dispatch and whether ready() was False
     at the first poll; the hidden share: of the card's time in the waves
     (an event pair around each replay), the part after the decode call
     that enqueued the wave returned; a rerun under torch.profiler gives
     the card's busy time, its largest items, and the part outside every
     decode call; a serial rerun uses the same symbols
  8. main path 4: a bf16 state_dict of Qwen3-4B's shapes (4.0·10⁹
     parameters, 30,833 chunks of 256 KiB) saved by a stale replica at
     step 100; the peer re-draws layers 32-35 and saves step 110;
     ``sync_from_peer`` repairs the stale store on the card, fetching
     exactly the 3,096 differing chunks (both stores in a temporary
     directory, removed at the end); the host's one-thread blake2b rate
     over the embedding's chunks says how much of a save is hashing
  9. ``reconcile_sets`` of two 10⁶-item Sketches of 32-byte items, d = 1,000
 10. the kernels at the phase-3 and phase-6 shapes, map_indices and
     iblt_apply again at phase 7's largest wave, map_indices again at the
     phase-6 encode shape, and A, B, C at phase 8's largest wave: card
     time, plain time, bound; A and C at the first wave and phase 7's
     wave also over every slot without the live count; each kernel also
     by the profiler's own timing of it (``profiler_ms``); one wave of the
     loop op by op and as a CUDA graph: host and card time
 11. the model stack: ``get_config("qwen3-4b")`` unchanged (bf16, 36
     layers, full width), random weights from the seed on the card; 4
     prompts of 1,024 tokens, prefill, 32 greedy decode steps at a 1,056
     context, the decode against a teacher-forced forward, the card
     against the CPU in fp32 at full width and 2 layers
 12. the other families, ``get_config`` unchanged, full width and depth
     in bf16, one at a time: qwen3-moe-30b-a3b (30,079,131,648
     parameters; EP prefill and decode with each call's dropped pairs;
     the decodes against a teacher-forced forward in the dropless TP
     mode, held in fp32 at full width and 4 layers since bf16 routing
     flips decorrelate the 48-layer comparison), rwkv6-1.6b,
     recurrentgemma-2b and whisper-base (stub frames of 1,500 × 512):
     prefill, greedy decode, the decode against a teacher-forced forward
     (held in fp32 at full depth, bf16 reported), the card against the
     CPU in fp32 at a few layers
 13. training: (a) ``get_config("qwen3-4b")`` unchanged (bf16, remat,
     AdamW with fp32 state; 4,057,526,400 parameters) for 6 steps of
     ``make_train_step`` at B = 2, S = 4,096 (train_4k's length, its
     global batch cut to one card): seconds a step over steps 2-5,
     tokens/s, the model FLOP share, host syncs in steps 2-5, step 6's
     busy share under the profiler, peak memory; finite losses and grad
     norms, the optimizer at step 6, every leaf moved; (b) one step at
     Qwen3-4B's width and vocabulary, 1 layer, fp32, B = 1, S = 256, on
     the card against the CPU: the loss, every gradient leaf and every
     update; (c) one step of every family at its smoke config, card
     (remat) against CPU: MoE in EP and TP, microbatches, int8 error
     feedback over 2 steps, kimi-k2's Adafactor settings; (d) the driver
     (``python -m repro_torch.launch.train``, smoke starcoder2-3b) exits
     17 after its step-5 checkpoint; 2 chunks overwritten are repaired
     in-process by ``launch.train.recover`` from a copy through the
     decode kernels (their launches counted: main path 5), then the driver,
     rerun with ``--peer-dir``, repairs, resumes from step 5 and
     finishes
 14. the device mesh over every card the process sees, one NCCL rank a
     card, (1, N) over ("data", "model"), each plain path run again
     beside its mesh path with deterministic algorithms on (the plain
     training step and EP combine are not bit-reproducible otherwise):
     (a) 13a's training for 3 steps, plain, then through the mesh
     (parameters and AdamW state DTensors), each loss and each leaf's
     update held against the plain path's at 13b's tolerances, whether
     they are bit-equal, seconds a step, busy share and peak beside the
     plain path's and 13a's; (b) Qwen3-30B-A3B in EP, plain, then on the
     mesh (its all_to_all_singles on the model group): phase 12's
     prompts prefilled and 8 decode steps fed phase 12's tokens, the
     logits, greedy tokens and dropped pairs held against the plain
     path's; (c) ``python -m repro_torch.launch.dryrun`` in subprocesses
     at nice 19, started first: every cell on the pod mesh, and qwen3-4b
     train_4k and kimi-k2 decode_32k on the multi-pod mesh, a line a
     cell (argument bytes, FLOPs, collective bytes by kind)
Launch counts are set to 0 just before each main path and read just after
it; each main path runs under torch.profiler (CUDA activity only), which
must trace exactly the counted launches of each kernel, op by op or in a
wave graph's replays, and their device times are summed per kernel and
path (``path_ms``).  Then the card's name and
power limit, the kernels JSON line and the result line.  Exits nonzero
without CUDA, outside the repository, or on any failed check.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import json
import shutil
import subprocess
import sys
import tempfile
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
# phase 5 overflow session, phase 6 encode round trip, phase 7 sharded
# serving
N_MAP, M_MAPS, M_PURITY, N_APPLY, M_APPLY = (65_536, (1_000, 160_000,
                                            2_097_152), 160_000, 20_000,
                                            100_003)
M_ENCODES, U_BATCH = (20_480, 2_097_152), 24
D_ONE_SHOT, M_ONE_SHOT = 100_000, 160_000
N_SESSION, D_SESSION = 1_000_000, 10_000
N_OVERFLOW, D_OVERFLOW = 20_000, 500
N_ENCODE, D_ENCODE, M_ENCODE = 1_000_000, 10_000, 20_480
N_SHARDED, D_SHARDED, SHARDS, REPLICAS = 1_000_000, 10_000, 8, 3
# phase 8: Qwen3-4B (src/repro/configs/qwen3_4b.py, written out here since
# the script imports nothing of the JAX package); word embeddings tied as
# in the public Qwen/Qwen3-4B config, whose checkpoint has no
# lm_head.weight (the repo's ModelConfig leaves tie_embeddings False)
QWEN3_4B = dict(layers=36, d_model=2560, heads=32, kv_heads=8, head_dim=128,
                d_ff=9728, vocab=151_936)
TUNED_LAYERS = range(32, 36)
CKPT_PARAMS, CKPT_CHUNKS, CKPT_DIFF = 4_022_468_096, 30_833, 3_096
N_SETS, D_SETS, SET_BYTES = 1_000_000, 1_000, 32
# phase 11: the model stack serving get_config("qwen3-4b") unchanged
SERVE_B, SERVE_PROMPT, SERVE_CTX, SERVE_STEPS = 4, 1_024, 1_056, 32
SERVE_TOL = 0.25            # bf16: decode logits vs the teacher-forced pass
CARD_CPU_LAYERS, CARD_CPU_S, CARD_CPU_TOL = 2, 128, 1e-3   # fp32
# phase 12: the other families, get_config(arch) unchanged.  Qwen3-30B-A3B
# serves SERVE_B prompts of SERVE_PROMPT tokens and SERVE_STEPS steps; its
# parameter count is the reference init's (jax.eval_shape), written out
MOE_ARCH, MOE_PARAMS, MOE_CARD_CPU_LAYERS = "qwen3-moe-30b-a3b", \
    30_079_131_648, 1
MOE_TOL = 0.5   # bf16, 48 layers: first set as the bound of the EP and TP
#                 decodes against the dropless forward; routing flips
#                 broke it on the H100 (6.57), so it now only sorts the
#                 positions reported (phase_serve_moe)
MOE_FP32_LAYERS, MOE_FP32_TOL = 4, 1e-3   # the held check, fp32
FAMILY_FP32_TOL = 1e-3   # fp32, full depth: decode vs forward
# the weights the reference's init keeps in fp32 whatever the config's
# dtype: the MoE router, RWKV-6's decay base, bonus and token-shift mixes,
# RG-LRU's decay parameter
FP32_WEIGHTS = {"router", "w_base", "u", "mu", "lam"}
FAMILIES = {  # arch -> (prompt tokens, greedy steps, bf16 decode-vs-forward
    #                    tolerance, first held, now only reported against,
    #                    fp32 card-vs-CPU layers)
    "rwkv6-1.6b": (1_024, 64, 0.25, 2),     # 1,088 forced = 17 chunks of 64
    "recurrentgemma-2b": (1_024, 32, 0.25, 3),   # rglru, rglru, local
    "whisper-base": (416, 32, 0.1, 2),       # 448: the decoder's context
}
# phase 13: training.  13a trains get_config("qwen3-4b") unchanged (bf16,
# remat, AdamW with fp32 state) on batches of train_4k's length, its global
# batch of 256 cut to what one card holds; the schedule warms up in one
# step to TRAIN_LR, since under the default 100-step warm-up the first
# updates (<= 1.8e-5) are below half a bf16 step of every weight above
# ~0.005 and of the norms' 1.0s, and round away (no fp32 master copy, as
# in the reference)
TRAIN_ARCH, TRAIN_PARAMS, TRAIN_B, TRAIN_S, TRAIN_STEPS, TRAIN_LR = \
    "qwen3-4b", 4_057_526_400, 2, 4_096, 6, 3e-3
PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor-core peak
# 13b: card against CPU at full width, 1 layer, fp32, one step
HELD_B, HELD_S = 1, 256
HELD_LOSS_TOL = 1e-4       # |loss_card - loss_cpu|
HELD_GRAD_TOL = 1e-4       # per leaf ||g_card - g_cpu|| / ||g_cpu||
HELD_UPDATE_TOL = 1e-2     # per leaf, of p1 - p0: AdamW's first update is
#                            ~lr·sign(g), and a component of g within float
#                            noise of 0 may take either sign
# 13c: every family at smoke width, card (remat on) against CPU (remat
# off), batches of SMOKE_B x SMOKE_S: (arch, config edit, microbatches,
# int8 error feedback, steps, optimizer settings of another arch, update
# tolerance)
SMOKE_B, SMOKE_S = 2, 32
SMOKE_LOSS_TOL, SMOKE_GNORM_TOL = 1e-4, 1e-4   # absolute; relative
TRAIN_CASES = [
    ("qwen3-4b", {}, 1, False, 1, None, 1e-2),
    ("starcoder2-3b", {}, 1, False, 1, None, 1e-2),
    ("qwen3-moe-30b-a3b", {}, 1, False, 1, None, 1e-2),
    ("qwen3-moe-30b-a3b", {"moe_mode": "tp"}, 1, False, 1, None, 1e-2),
    ("rwkv6-1.6b", {}, 1, False, 1, None, 1e-2),
    ("recurrentgemma-2b", {}, 1, False, 1, None, 1e-2),
    ("whisper-base", {}, 1, False, 1, None, 1e-2),
    ("internvl2-76b", {}, 1, False, 1, None, 1e-2),
    ("qwen3-4b", {}, 2, False, 1, None, 1e-2),
    ("qwen3-4b", {}, 1, True, 2, None, 1e-2),
    # Adafactor, bf16 state, no momentum, bf16 accumulation: a gradient
    # rounded to bf16 may land one bf16 step apart
    ("kimi-k2-1t-a32b", {}, 2, False, 1, "kimi-k2-1t-a32b", 5e-2),
]
# 13d: the driver's crash and repair on the card
DRIVER_ARGS = ["--arch", "starcoder2-3b", "--smoke", "--steps", "10",
               "--batch", "2", "--seq", "32", "--ckpt-every", "5"]
TRAIN_CORRUPT = 2
# phase 14: the mesh path.  14a trains as 13a for MESH_STEPS steps and 14b
# serves MESH_SERVE_STEPS decode steps of phase 12's, held against them;
# the dry run's pod cells run DRYRUN_JOBS at a time (the kimi-k2 train
# cell, ~3 minutes of one core, sets the pace), all within DRYRUN_TIMEOUT
# seconds of running (the time it is held stopped, :func:`_dryrun_held`,
# not counted)
MESH_STEPS, MESH_SERVE_STEPS = 3, 8
MESH_SERVE_TOL = 1e-2      # bf16 logits, the mesh's against phase 12's
MULTIPOD_CELLS = [("qwen3-4b", "train_4k"), ("kimi-k2-1t-a32b", "decode_32k")]
DRYRUN_JOBS, DRYRUN_TIMEOUT = 6, 280
DRYRUN = {"groups": [], "held_s": 0.0}   # 14c's process groups, held time
KERNELS = {  # name -> (source, the TPU kernel it replaces)
    "map_indices": ("src/repro_torch/csrc/map_indices.cu",
                    "src/repro/kernels/map_indices.py:41"),
    "purity_scan": ("src/repro_torch/csrc/purity_scan.cu",
                    "src/repro/kernels/peel.py:78"),
    "iblt_apply": ("src/repro_torch/csrc/iblt_apply.cu",
                   "src/repro/kernels/peel.py:133"),
    "iblt_encode": ("src/repro_torch/csrc/iblt_encode.cu",
                    "src/repro/kernels/iblt_encode.py:69"),
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


def read_launches(mods) -> dict:
    return {fn.__name__: fn.launches for fn in mods}


# The name each kernel's __global__ function has in a trace of the card.
KERNEL_SYMBOLS = {"purity_scan": "purity_scan_kernel",
                  "map_indices": "map_kernel<",
                  "iblt_apply": "scatter_kernel<0>",
                  "iblt_encode": "scatter_kernel<1>"}


@contextlib.contextmanager
def launch_spans(names):
    """Trace the card while the block runs (``torch.profiler``, CUDA
    activity only) and collect the device time of every launch of the
    kernels ``names``, launched op by op or by a CUDA graph's replay alike.
    Yields {name: [device ms of each launch]}, filled when the block
    ends."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    spans = {name: [] for name in names}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.zeros(1, device=DEVICE).add_(1)    # the tracer is up
        torch.cuda.synchronize()
        time.sleep(0.05)
        yield spans
        torch.cuda.synchronize()
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        for name in names:
            if KERNEL_SYMBOLS[name] in e.name:
                spans[name].append(e.time_range.elapsed_us() * 1e-3)
    spans["_all"] = collections.Counter(
        e.name[:60] for e in prof.events() if e.device_type == DeviceType.CUDA)


@contextlib.contextmanager
def largest_wave():
    """The inputs of the wave that recovers the most items among every
    decode the block runs.  While the block runs, each wave loop the
    device decoders build (``ops.WaveLoop``) has its three input tensors
    copied on the card (the loop updates them in place); nothing is read
    back.  When the block ends, each recorded decode runs again op by op,
    its waves read one by one, and the dict the block got is filled with
    ``n`` and ``args`` = (loop, state, wave): the state as that wave's
    purity scan read it.  The kernels' ``.launches`` are left as the block
    left them."""
    from repro_torch.kernels import ops, peel
    made, real, out = [], ops.WaveLoop, {}

    def record(*args, **kw):
        made.append(([a.clone() for a in args[:3]] + list(args[3:]), kw))
        return real(*args, **kw)

    ops.WaveLoop = record
    try:
        yield out
    finally:
        ops.WaveLoop = real
    kernels = (peel.map_indices, peel.purity_scan, peel.iblt_apply)
    counted = [fn.launches for fn in kernels]
    for args, kw in made:
        loop = real(*args, **kw)
        while True:
            st = loop.state
            before = st._replace(sums=st.sums.clone(),
                                 checks=st.checks.clone(),
                                 counts=st.counts.clone())
            wave = loop._stage1(st)
            n = int(wave.count)
            if n > out.get("n", -1):
                out.update(n=n, args=(loop, before, wave))
            loop._stage2(st, wave)
            if not bool(st.live):
                break
    for fn, c in zip(kernels, counted):
        fn.launches = c


def make_loop(diff):
    """The wave loop of ``decode_device`` on host difference symbols
    ``diff``, on the card, before its first wave."""
    from repro_torch.core.hashing import DEFAULT_KEY
    from repro_torch.core.mapping import kmax
    from repro_torch.kernels.ops import host_symbols_to_device
    from repro_torch.kernels.peel import WaveLoop
    sums, checks, counts = host_symbols_to_device(diff, DEVICE)
    m, L = sums.shape
    mp = ((m + 255) // 256) * 256

    def pad(x):
        out = torch.zeros((mp, x.shape[1]), dtype=torch.int32, device=DEVICE)
        out[:m] = x
        return out

    return WaveLoop(pad(sums), pad(checks), pad(counts.reshape(m, 1)), [m],
                    nbytes=NBYTES, key=DEFAULT_KEY, max_diff=mp, K=kmax(mp))


def first_wave(diff):
    """(loop, state, wave) of the first wave of ``decode_device`` on host
    difference symbols ``diff``, on the card."""
    loop = make_loop(diff)
    return loop, loop.state, loop._stage1(loop.state)


def spans_ms(spans: dict, launches: dict) -> dict:
    """Each kernel's summed device ms; every counted launch was traced on
    the card, and no other."""
    traced = spans.pop("_all")
    for name, ms in spans.items():
        check(len(ms) == launches.get(name, 0),
              f"{name}: {len(ms)} launches traced on the card, "
              f"{launches.get(name)} counted; traced kernels "
              f"{traced.most_common(12)}")
    return {name: sum(ms) for name, ms in spans.items()}


def profiler_ms(name: str, fn, reps: int = 20, traces: int = 3) -> float:
    """Mean device ms of one launch of kernel ``name`` in a trace of
    ``reps`` calls of ``fn`` (torch.profiler's own timing of the kernel,
    without the launch gaps an event pair spans).  A trace this short
    can come back without the kernel's launches (seen once on the H100,
    on a host slower than usual), so it is taken again, ``traces`` times
    at most, until one holds them."""
    for _ in range(traces):
        with launch_spans([name]) as spans:
            for _ in range(reps):
                fn()
        if spans[name]:
            return sum(spans[name]) / len(spans[name])
    raise AssertionError(f"{name}: no launch traced in {traces} traces")


def words_on_card(records: np.ndarray) -> torch.Tensor:
    from repro_torch.core.hashing import bytes_to_words
    w = bytes_to_words(records, NBYTES)
    return torch.from_numpy(w.view(np.int32)).to(DEVICE)


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


def phase_kernels(rng, errs: dict, cases_rng) -> None:
    """Phase 2.  ``cases_rng`` draws the scatter kernels' design cases, so
    that ``rng`` reaches the main paths in the same state as before them."""
    from repro_torch.core.hashing import DEFAULT_KEY, siphash24_pair
    from repro_torch.core.mapping import kmax
    from repro_torch.kernels.iblt_encode import iblt_encode
    from repro_torch.kernels.map_indices import map_indices
    from repro_torch.kernels.peel import iblt_apply, purity_scan
    from repro_torch.kernels.ref import (iblt_apply_ref, iblt_encode_ref,
                                         map_indices_ref, purity_ref)
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
    one = (torch.zeros(N_APPLY, dtype=torch.int32, device=DEVICE),
           torch.tensor([m], dtype=torch.int32, device=DEVICE))
    got = iblt_apply(items, idx, chk, sides, *one, mp=mp)
    want = iblt_apply_ref(items, idx, chk, sides, *one, mp=mp)
    for gg, w in zip(got, want):
        e = max_abs_err(gg, w)
        check(e == 0, f"iblt_apply: max |err| {e}")
        errs["iblt_apply"] = max(errs["iblt_apply"], e)
        check(bool((gg[m:] == 0).all()), "iblt_apply wrote rows >= m")
    cases += 1
    # D: the encoder's accumulation, at the phase-6 prefix and at 2**21
    for m in M_ENCODES:
        idx, chk = map_indices(items, K=kmax(m), m=m, nbytes=NBYTES, key=key)
        got = iblt_encode(items, idx, chk, m=m)
        want = iblt_encode_ref(items, idx, chk, m=m)
        for gg, w in zip(got, want):
            e = max_abs_err(gg, w)
            check(e == 0, f"iblt_encode m={m}: max |err| {e}")
            errs["iblt_encode"] = max(errs["iblt_encode"], e)
        cases += 1
    # C over U units end to end, chains at the shared mp, ragged prefixes
    # (one empty), as the batched decode calls it
    U, mp = U_BATCH, ((M_APPLY + 255) // 256) * 256
    m_units = torch.from_numpy(rng.integers(0, mp + 1, size=U,
                                            dtype=np.int32)).to(DEVICE)
    m_units[0], m_units[1] = 0, mp
    unit = torch.from_numpy(rng.integers(0, U, size=N_APPLY,
                                         dtype=np.int32)).to(DEVICE)
    idx, chk = map_indices(items, K=kmax(mp), m=mp, nbytes=NBYTES, key=key)
    got = iblt_apply(items, idx, chk, sides, unit, m_units, mp=mp)
    want = iblt_apply_ref(items, idx, chk, sides, unit, m_units, mp=mp)
    for gg, w in zip(got, want):
        e = max_abs_err(gg, w)
        check(e == 0, f"iblt_apply over {U} units: max |err| {e}")
        errs["iblt_apply"] = max(errs["iblt_apply"], e)
        check(gg.shape[0] == U * mp and bool((gg[:mp] == 0).all()),
              "iblt_apply wrote into an empty unit")
    cases += 1
    cases += scatter_cases(cases_rng, errs)
    cases += map_cases(cases_rng, errs)
    cases += narrow_cases(cases_rng, errs)
    cases += count_cases(cases_rng, errs)
    say(f"phase 2 kernels vs plain: {cases} cases bit-equal "
        f"(max |err| {errs})")


def scatter_cases(rng, errs: dict) -> int:
    """C and D, which share ``csrc/scatter.cuh``, at the inputs its design
    branches on; returns the number of cases, each bit-equal to its plain
    twin.

    On a 132-SM card a launch of n <= 4,224 items gives each block at most
    32 items, so the sizing rule keeps H = 512 shared rows (fewer only
    where a unit or the card's shared memory has fewer): m = 511, 512 and
    513 fall below, at and above the table, and m = 100,003 or 20,480 past
    it.  L = 4,096 leaves room for 14 rows; the widest items fill more than
    an SM's shared memory with one row, so every slot goes global.  Units
    come sorted, as the decode passes them (a unit's items then straddle
    several blocks' stripes), and in random order.
    """
    from repro_torch.core.hashing import DEFAULT_KEY
    from repro_torch.core.mapping import kmax
    from repro_torch.kernels.iblt_encode import iblt_encode
    from repro_torch.kernels.map_indices import map_indices
    from repro_torch.kernels.peel import iblt_apply
    from repro_torch.kernels.ref import iblt_apply_ref, iblt_encode_ref

    def hold(name, got, want, what):
        for g, w in zip(got, want):
            e = max_abs_err(g, w)
            check(e == 0, f"{name} {what}: max |err| {e}")
            errs[name] = max(errs[name], e)

    def chains(items, m):
        return map_indices(items, K=kmax(m), m=m, nbytes=4 * items.shape[1],
                           key=DEFAULT_KEY)

    def sides(n):
        return torch.from_numpy(rng.integers(-1, 2, size=n, dtype=np.int32)
                                ).to(DEVICE)

    cases = 0
    wide = torch.cuda.get_device_properties(0) \
        .shared_memory_per_multiprocessor // 4
    for n, L, ms in ((4_000, 23, (511, 512, 513)), (4_000, 1, (512, 100_003)),
                     (1, 23, (1_000, 20_480)), (64, 4_096, (1_000,)),
                     (16, wide, (1_000,))):
        items = rand_i32(rng, (n, L))
        for m in ms:
            what = f"n={n} L={L} m={m}"
            mp = ((m + 255) // 256) * 256
            idx, chk = chains(items, mp)
            one = (torch.zeros(n, dtype=torch.int32, device=DEVICE),
                   torch.tensor([m], dtype=torch.int32, device=DEVICE))
            side = sides(n)
            hold("iblt_apply", iblt_apply(items, idx, chk, side, *one, mp=mp),
                 iblt_apply_ref(items, idx, chk, side, *one, mp=mp), what)
            idx, chk = chains(items, m)
            hold("iblt_encode", iblt_encode(items, idx, chk, m=m),
                 iblt_encode_ref(items, idx, chk, m=m), what)
            cases += 2
    # 32 units, ragged prefixes, unit 0 empty, unit 1 full
    n, U = 20_000, 32
    items = rand_i32(rng, (n, 23))
    for mp in (512, 2_048):
        m_units = rng.integers(0, mp + 1, size=U, dtype=np.int32)
        m_units[0], m_units[1] = 0, mp
        m_units = torch.from_numpy(m_units).to(DEVICE)
        idx, chk = chains(items, mp)
        side = sides(n)
        for order in ("sorted", "random"):
            unit = rng.integers(0, U, size=n, dtype=np.int32)
            if order == "sorted":
                unit.sort()
            unit = torch.from_numpy(unit).to(DEVICE)
            got = iblt_apply(items, idx, chk, side, unit, m_units, mp=mp)
            hold("iblt_apply", got,
                 iblt_apply_ref(items, idx, chk, side, unit, m_units, mp=mp),
                 f"over {U} {order} units at mp={mp}")
            check(all(bool((g[:mp] == 0).all()) for g in got),
                  "iblt_apply wrote into an empty unit")
            cases += 1
    return cases


def map_cases(rng, errs: dict) -> int:
    """A at the inputs its design branches on; returns the number of cases,
    each bit-equal to its plain twin.

    ``launch_shape`` gives an item more lanes while a wave has fewer than
    ``FILL`` threads an SM (on a 132-SM card: G = 1 from 16,896 items,
    G = 2 from 8,448, else G = 4) and a block 128 / G items, fewer where
    their (bn, K) index tile exceeds the shared memory.  The cases: n = 1;
    n = 4,097, a multiple of neither the block's items nor four, with an
    odd K, so block tiles start off 16-byte alignment; K = 1; K = 200, past
    every chain at m = 1,000 (all-pad tails); L = 1 with nbytes = 3 and
    L = 2 (no leftover word); m = 2,097,152 (jumps past int32 saturate);
    200,003 items at G = 1; K = 9,999, whose tile leaves a block 4 items.
    """
    from repro_torch.core.hashing import DEFAULT_KEY
    from repro_torch.core.mapping import kmax
    from repro_torch.kernels.map_indices import (_card, launch_shape,
                                                 map_indices)
    from repro_torch.kernels.ref import map_indices_ref
    sms, optin = _card(torch.cuda.current_device())
    lanes_seen, cases = set(), 0
    for n, L, nbytes, K, m in ((1, 23, 92, kmax(160_000), 160_000),
                               (4_097, 23, 92, kmax(2_048), 2_048),
                               (3_001, 23, 92, 1, 1_000),
                               (3_001, 23, 92, 200, 1_000),
                               (10_000, 1, 3, kmax(20_480), 20_480),
                               (10_000, 2, 8, kmax(20_480), 20_480),
                               (10_000, 23, 92, kmax(2_097_152), 2_097_152),
                               (200_003, 23, 92, kmax(20_480), 20_480),
                               (50, 23, 92, 9_999, 2 ** 30)):
        items = rand_i32(rng, (n, L))
        if nbytes % 4:
            items[:, -1] &= (1 << (8 * (nbytes % 4))) - 1
        bn, lanes, _ = launch_shape(n, K, sms=sms, smem_optin=optin)
        lanes_seen.add(lanes)
        got = map_indices(items, K=K, m=m, nbytes=nbytes, key=DEFAULT_KEY)
        want = map_indices_ref(items, K=K, m=m, nbytes=nbytes,
                               key=DEFAULT_KEY)
        for g, w in zip(got, want):
            e = max_abs_err(g, w)
            check(e == 0, f"map_indices n={n} L={L} K={K} m={m} (bn={bn}, "
                  f"G={lanes}): max |err| {e}")
            errs["map_indices"] = max(errs["map_indices"], e)
        cases += 1
    check({1, 2, 4} <= lanes_seen, f"lanes an item covered: {lanes_seen}")
    return cases


def narrow_cases(rng, errs: dict) -> int:
    """A, B and C at the checkpoint path's width: 16-byte records, L = 4
    words (the other main paths carry L = 23).  Returns the number of
    cases, each bit-equal to its plain twin.

    A at 6,192 items (4 lanes an item on a 132-SM card), 65,536 (1
    lane) and 10,000 past int32 at m = 2,097,152 (2 lanes); B over random
    symbols and with planted pure ones; C over one unit and over 8 sorted
    units with ragged prefixes.
    """
    from repro_torch.core.hashing import DEFAULT_KEY, siphash24_pair
    from repro_torch.core.mapping import kmax
    from repro_torch.kernels.map_indices import map_indices
    from repro_torch.kernels.peel import iblt_apply, purity_scan
    from repro_torch.kernels.ref import (iblt_apply_ref, map_indices_ref,
                                         purity_ref)
    key, L, nbytes = DEFAULT_KEY, 4, 16

    def hold(name, got, want, what):
        for g, w in zip(outputs(got), outputs(want)):
            e = max_abs_err(g, w)
            check(e == 0, f"{name} L=4 {what}: max |err| {e}")
            errs[name] = max(errs[name], e)

    cases = 0
    for n, m in ((6_192, 16_384), (65_536, 16_384), (10_000, 2_097_152)):
        items = rand_i32(rng, (n, L))
        kw = dict(K=kmax(m), m=m, nbytes=nbytes, key=key)
        hold("map_indices", map_indices(items, **kw),
             map_indices_ref(items, **kw), f"n={n} m={m}")
        cases += 1
    mp = 16_384
    sums, checks = rand_i32(rng, (mp, L)), rand_i32(rng, (mp, 2))
    counts = torch.from_numpy(rng.integers(-3, 4, size=(mp, 1),
                                           dtype=np.int32)).to(DEVICE)
    for planted in (False, True):
        if planted:
            rows = torch.from_numpy(rng.permutation(mp)[:mp // 3]).to(DEVICE)
            hi, lo = siphash24_pair(sums[rows], key, nbytes)
            checks[rows] = torch.stack([hi, lo], dim=1)
            counts[rows] = torch.where(rows % 2 == 0, 1, -1).to(
                torch.int32)[:, None]
        got = purity_scan(sums, checks, counts, key=key, nbytes=nbytes)
        hold("purity_scan", got,
             purity_ref(sums, checks, counts, key=key, nbytes=nbytes),
             f"mp={mp} planted={planted}")
        if planted:
            check(bool((got[rows] != 0).all()), "planted pure rows missed")
        cases += 1
    n, m = 6_192, 10_007
    mp = ((m + 255) // 256) * 256
    items = rand_i32(rng, (n, L))
    idx, chk = map_indices(items, K=kmax(mp), m=mp, nbytes=nbytes, key=key)
    sides = torch.from_numpy(rng.integers(-1, 2, size=n, dtype=np.int32)
                             ).to(DEVICE)
    U = 8
    m_units = torch.from_numpy(rng.integers(0, mp + 1, size=U,
                                            dtype=np.int32)).to(DEVICE)
    m_units[0] = m
    for unit, lim in ((torch.zeros(n, dtype=torch.int32, device=DEVICE),
                       m_units[:1]),
                      (torch.from_numpy(np.sort(rng.integers(
                          0, U, size=n, dtype=np.int32))).to(DEVICE),
                       m_units)):
        hold("iblt_apply", iblt_apply(items, idx, chk, sides, unit, lim,
                                      mp=mp),
             iblt_apply_ref(items, idx, chk, sides, unit, lim, mp=mp),
             f"n={n} over {lim.numel()} units at mp={mp}")
        cases += 1
    return cases


def count_cases(rng, errs: dict) -> int:
    """A and C with the live count read on the card (``count``, as the
    wave loop launches them over its fixed slots): counts of 0, 1, a block
    boundary, half, all and past the end; A's rows up to the count and C's
    whole delta bit-equal to the plain versions.  Returns the number of
    cases."""
    from repro_torch.core.hashing import DEFAULT_KEY
    from repro_torch.core.mapping import kmax
    from repro_torch.kernels.map_indices import map_indices
    from repro_torch.kernels.peel import iblt_apply
    from repro_torch.kernels.ref import iblt_apply_ref, map_indices_ref
    n, L, U, mp = 6_000, 23, 4, 2_048
    items = rand_i32(rng, (n, L))
    kw = dict(K=kmax(mp), m=mp, nbytes=NBYTES, key=DEFAULT_KEY)
    sides = torch.from_numpy(rng.integers(-1, 2, size=n, dtype=np.int32)
                             ).to(DEVICE)
    unit = torch.from_numpy(np.sort(rng.integers(0, U, size=n,
                                                 dtype=np.int32))).to(DEVICE)
    m_units = torch.tensor([mp, 1_000, 0, 2_000], dtype=torch.int32,
                           device=DEVICE)
    cases = 0
    for live in (0, 1, 128, n // 2, n, n + 7):
        count = torch.tensor([live], dtype=torch.int64, device=DEVICE)
        upto = min(live, n)
        got = map_indices(items, count=count, **kw)
        want = map_indices_ref(items, count=count, **kw)
        for g, w in zip(got, want):
            e = max_abs_err(g[:upto], w[:upto])
            check(e == 0, f"map_indices count={live}: max |err| {e}")
            errs["map_indices"] = max(errs["map_indices"], e)
        idx, chk = map_indices(items, **kw)
        got = iblt_apply(items, idx, chk, sides, unit, m_units, mp=mp,
                         count=count)
        want = iblt_apply_ref(items, idx, chk, sides, unit, m_units, mp=mp,
                              count=count)
        for g, w in zip(got, want):
            e = max_abs_err(g, w)
            check(e == 0, f"iblt_apply count={live}: max |err| {e}")
            errs["iblt_apply"] = max(errs["iblt_apply"], e)
        cases += 2
    return cases


def phase_one_shot(rng, kernels):
    from repro_torch.core import encode
    from repro_torch.core.hashing import bytes_to_words
    from repro_torch.kernels.ops import decode_device, host_symbols_to_device
    from repro_torch.kernels.peel import WAVES_PER_CHUNK, read_back
    d, m = D_ONE_SHOT, M_ONE_SHOT
    recs = random_records(rng, d)
    a, b = recs[: d // 2], recs[d // 2:]
    t0 = time.perf_counter()
    diff = encode(a, NBYTES, m).subtract(encode(b, NBYTES, m))
    enc_s = time.perf_counter() - t0
    args = host_symbols_to_device(diff, DEVICE)
    reset_launches(kernels)
    read_back.count = 0
    t0 = time.perf_counter()
    res = decode_device(*args, nbytes=NBYTES, device=DEVICE)
    dec_s = time.perf_counter() - t0
    launches, reads = read_launches(kernels), read_back.count
    check(reads <= -(-res.rounds // WAVES_PER_CHUNK) + 1,
          f"one-shot: {reads} host reads for {res.rounds} waves")
    want = as_set(bytes_to_words(a, NBYTES), np.ones(len(a))) | \
        as_set(bytes_to_words(b, NBYTES), -np.ones(len(b)))
    check(res.success and not res.overflow, "one-shot decode failed")
    check(as_set(res.items, res.sides) == want, "one-shot: wrong difference")
    # the card against the plain torch twins on a small input
    small = encode(a[:250], NBYTES, 1100).subtract(encode(b[:250], NBYTES,
                                                          1100))
    on_cpu = decode_device(*host_symbols_to_device(small, "cpu"),
                           nbytes=NBYTES, device="cpu")
    # twice on the card: the second decode runs on the first one's kept
    # wave graph and buffers
    for _ in range(2):
        on_card = decode_device(*host_symbols_to_device(small, DEVICE),
                                nbytes=NBYTES, device=DEVICE)
        check(on_card.success and on_card.items.shape[0] == 500,
              "small decode failed")
        for f in ("items", "hashes", "sides"):
            check(np.array_equal(getattr(on_card, f), getattr(on_cpu, f)),
                  f"card and plain decode differ in {f}")
        check((on_card.rounds, on_card.success) ==
              (on_cpu.rounds, on_cpu.success)
              and all(np.array_equal(getattr(on_card.residual, f),
                                     getattr(on_cpu.residual, f))
                      for f in ("sums", "checks", "counts")),
              "card and plain decode differ in rounds or residual")
    say(f"phase 3 one-shot decode: d={d} m={m} waves={res.rounds} "
        f"decode {dec_s:.3f} s (host encode {enc_s:.1f} s), {reads} host "
        f"reads at {WAVES_PER_CHUNK} waves a read; exact, "
        f"no overflow; launches {launches}; card == plain decode at d=500, "
        f"twice")
    return diff


def phase_session(rng, kernels) -> tuple[dict, dict]:
    from repro_torch.core import Encoder
    from repro_torch.core.hashing import bytes_to_words
    from repro_torch.kernels import ops
    from repro_torch.kernels.peel import read_back
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
    read_back.count = 0
    t0 = time.perf_counter()
    try:
        with launch_spans([fn.__name__ for fn in kernels]) as timed_launches:
            rep = run_session(stream, session, wire=True)
    finally:
        ops.decode_device = real
    session_s = time.perf_counter() - t0
    launches, reads = read_launches(kernels), read_back.count
    path_ms = spans_ms(timed_launches, launches)
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
        f"{len(decode_s)} windows ({reads / len(decode_s):.2f} host reads a "
        f"decode) + rest (set-up {setup_s:.1f} s); "
        f"host_fallbacks=0; launches {launches}; kernel ms {path_ms}")
    return launches, path_ms


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


def phase_encode(rng, kernels) -> tuple[dict, dict, torch.Tensor]:
    """Main path 2: device encode → subtract on the card → device decode."""
    from repro_torch.core import encode, kmax
    from repro_torch.core.hashing import bytes_to_words
    from repro_torch.kernels.ops import (decode_device, device_symbols_to_host,
                                         encode_device)
    n, d, m = N_ENCODE, D_ENCODE, M_ENCODE
    recs = random_records(rng, n + d // 2)
    a = recs[:n]
    b = np.concatenate([recs[: n - d // 2], recs[n:]])
    ta, tb = words_on_card(a), words_on_card(b)
    reset_launches(kernels)
    torch.cuda.synchronize()
    with launch_spans([fn.__name__ for fn in kernels]) as timed_launches:
        t0 = time.perf_counter()
        sa, ca, na = encode_device(ta, m=m, nbytes=NBYTES, device=DEVICE)
        sb, cb, nb = encode_device(tb, m=m, nbytes=NBYTES, device=DEVICE)
        torch.cuda.synchronize()
        enc_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = decode_device(sa ^ sb, ca ^ cb, na - nb, nbytes=NBYTES,
                            device=DEVICE)
        dec_s = time.perf_counter() - t0
    launches = read_launches(kernels)
    path_ms = spans_ms(timed_launches, launches)
    check(all(v > 0 for v in launches.values()),
          f"a kernel never launched on the encode path: {launches}")
    t0 = time.perf_counter()
    host = encode(a, NBYTES, m)
    host_s = time.perf_counter() - t0
    dev = device_symbols_to_host(sa, ca, na, NBYTES)
    for f in ("sums", "checks", "counts"):
        check(np.array_equal(getattr(dev, f), getattr(host, f)),
              f"device encoder differs from the host encoder in {f}")
    want = as_set(bytes_to_words(recs[n - d // 2: n], NBYTES),
                  np.ones(d // 2)) | \
        as_set(bytes_to_words(recs[n:], NBYTES), -np.ones(d - d // 2))
    check(res.success and not res.overflow, "encode round trip: decode failed")
    check(as_set(res.items, res.sides) == want,
          "encode round trip: wrong difference")
    say(f"phase 6 encode round trip: n={n} d={d} m={m} K={kmax(m)} "
        f"encode {enc_s:.3f} s for both sets on the card (host encoder "
        f"{host_s:.1f} s for one), decode {dec_s:.3f} s in {res.rounds} "
        f"waves; A's symbols == host encoder's, difference exact; "
        f"launches {launches}; kernel ms {path_ms}")
    return launches, path_ms, ta


def _merged(spans) -> list:
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def pipelined_overlap(run) -> tuple[float, float, float, list]:
    """Run ``run()`` (a pipelined engine run returning its seconds) under
    ``torch.profiler`` with every decode call (dispatch, poll, read-back)
    marked.  Returns (the share of the card's busy time that lies outside
    every decode call, the card's busy seconds, the run's seconds, the
    four names of device work with the most time and their ms)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.kernels import ops
    Pending = ops.PendingBatchedDecode
    real = (ops.decode_device_batched_start, Pending.ready, Pending.wait)

    def marked(fn):
        def call(*args, **kw):
            with record_function("decode call"):
                return fn(*args, **kw)
        return call

    ops.decode_device_batched_start = marked(real[0])
    Pending.ready, Pending.wait = marked(real[1]), marked(real[2])
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run_s = run()
            torch.cuda.synchronize()
    finally:
        ops.decode_device_batched_start = real[0]
        Pending.ready, Pending.wait = real[1], real[2]
    # the card's own work: the profiler also mirrors each "decode call"
    # range onto the card's timeline, and that span is not work
    events = prof.events()
    work = [e for e in events if e.device_type == DeviceType.CUDA
            and e.name != "decode call"]
    busy = _merged((e.time_range.start, e.time_range.end) for e in work)
    calls = _merged((e.time_range.start, e.time_range.end) for e in events
                    if e.name == "decode call"
                    and e.device_type == DeviceType.CPU)
    total = sum(b - a for a, b in busy)
    check(total > 0 and calls, "the profiler saw no decode on the card")
    by_name = collections.Counter()
    for e in work:
        by_name[e.name[:40]] += e.time_range.elapsed_us() * 1e-3
    top = [(name, round(ms, 3)) for name, ms in by_name.most_common(4)]
    inside, k = 0.0, 0
    for a, b in busy:
        while k < len(calls) and calls[k][1] <= a:
            k += 1
        j = k
        while j < len(calls) and calls[j][0] < b:
            inside += min(b, calls[j][1]) - max(a, calls[j][0])
            j += 1
    return 1 - inside / total, total * 1e-6, run_s, top


def phase_sharded(rng, kernels) -> tuple[dict, dict, dict]:
    """Main path 3: one ShardedStream, REPLICAS stale replicas, one
    pipelined engine with batched device decodes.  Also returns the
    inputs of the wave with the most items, for phase 10."""
    from repro_torch.core.hashing import bytes_to_words
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.peel import WAVES_PER_CHUNK, read_back
    from repro_torch.protocol import ReconcileEngine, ShardedStream
    n, d = N_SHARDED, D_SHARDED
    half, step = d // 2, d // 4       # consecutive replicas share half
    recs = random_records(rng, n + half + step * (REPLICAS - 1))
    alice = recs[:n]
    t0 = time.perf_counter()
    stream = ShardedStream.from_items(alice, NBYTES, n_shards=SHARDS)
    replicas = []
    for r in range(REPLICAS):
        lost = slice(n - half - r * step, n - r * step)
        added = slice(n + r * step, n + r * step + half)
        items = np.concatenate([recs[: lost.start], recs[lost.stop: n],
                                recs[added]])
        replicas.append((ShardedStream.from_items(items, NBYTES,
                                                  n_shards=SHARDS),
                         as_set(bytes_to_words(recs[lost], NBYTES)),
                         as_set(bytes_to_words(recs[added], NBYTES))))
    setup_s = time.perf_counter() - t0

    def run(pipeline: bool, timers=None):
        engine = ReconcileEngine(pipeline=pipeline)
        sessions = [stream.session(local=local, device=DEVICE)
                    for local, _, _ in replicas]
        for sess in sessions:
            if timers is not None:
                for u in sess._shards:
                    u.decoder.absorb = timed(u.decoder.absorb, timers[1])
            engine.register(stream, sess, wire=True)
        t0 = time.perf_counter()
        reports = engine.run()
        return engine, sessions, reports, time.perf_counter() - t0

    # where the time goes: serving payloads (Alice's shard encoders),
    # absorbing them (the replicas' encoders, subtraction, chain walks),
    # the device decode split into dispatch, polls and read-back.  Each
    # dispatch runs under the sync debug mode "error", so a hidden wait for
    # the card inside it raises.  Every wave (a replay of its loop's CUDA
    # graph) is timed on the card by an event pair, beside the host time
    # at which the decode call that enqueued it returned: the wave's card
    # time past that moment ran while the host was out of every decode
    # call, ingesting.
    serve_s, absorb_s, start_s, poll_s, wait_s, sizes = [], [], [], [], [], []
    pendings, first_poll, returns, waves_ev = [], {}, [], []
    real_payload, real_start = stream.payload, ops.decode_device_batched_start
    Pending = ops.PendingBatchedDecode
    real_wait, real_ready = Pending.wait, Pending.ready
    real_replay = _build.CountedGraph.replay

    def replay(self):
        pair = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        pair[0].record()
        real_replay(self)
        pair[1].record()
        waves_ev.append((*pair, len(returns)))

    def returned(fn):
        def call(*args, **kw):
            try:
                return fn(*args, **kw)
            finally:
                returns.append(time.perf_counter())
        return call

    def start(units, **kw):
        sizes.append(len(units))
        torch.cuda.set_sync_debug_mode("error")
        try:
            pending = real_start(units, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        pendings.append(pending)
        return pending

    def ready(self):
        out = real_ready(self)
        first_poll.setdefault(id(self), out)
        return out

    stream.payload = timed(real_payload, serve_s)
    ops.decode_device_batched_start = timed(returned(start), start_s)
    Pending.ready = timed(returned(ready), poll_s)
    Pending.wait = timed(returned(real_wait), wait_s)
    _build.CountedGraph.replay = replay
    reset_launches(kernels)
    read_back.count = 0
    torch.cuda.synchronize()
    clock = torch.cuda.Event(enable_timing=True)    # the two clocks paired:
    clock.record()                                  # the idle card runs it
    t_clock = time.perf_counter()                   # within microseconds
    clock.synchronize()
    try:
        with largest_wave() as wave, \
                launch_spans([fn.__name__ for fn in kernels]) as timed_launches:
            engine, sessions, reports, run_s = run(True, (serve_s, absorb_s))
    finally:
        stream.payload = real_payload
        ops.decode_device_batched_start = real_start
        Pending.wait, Pending.ready = real_wait, real_ready
        _build.CountedGraph.replay = real_replay
    launches = read_launches(kernels)
    path_ms = spans_ms(timed_launches, launches)
    for rep, sess, (_, remote_only, local_only) in zip(reports, sessions,
                                                       replicas):
        check(as_set(rep.only_remote) == remote_only,
              "sharded: wrong remote-only records")
        check(as_set(rep.only_local) == local_only,
              "sharded: wrong local-only records")
        check(sess.host_fallbacks == 0, "sharded: a shard fell back to host")
    check(engine.dispatches == engine.ticks > 0,
          f"dispatches {engine.dispatches} != ticks {engine.ticks}")
    check(all(v > 0 for v in launches.values()),
          f"a kernel never launched on the sharded path: {launches}")
    check(max(sizes) > 1 and wave, "no decode dispatch batched two units")
    reads, waves = [], []
    for pending in pendings:
        waves.append(pending.wait()[0].rounds)
        reads.append(pending.host_reads)
        check(reads[-1] <= -(-waves[-1] // WAVES_PER_CHUNK) + 1,
              f"a dispatch read the card {reads[-1]} times for "
              f"{waves[-1]} waves")
    check(sum(reads) == read_back.count,
          f"{read_back.count} host reads, {sum(reads)} counted by dispatches")
    not_ready = sum(not v for v in first_poll.values())
    wave_s = hidden_s = 0.0
    for a, b, call in waves_ev:
        t_a = t_clock + clock.elapsed_time(a) * 1e-3
        t_b = t_clock + clock.elapsed_time(b) * 1e-3
        wave_s += t_b - t_a
        hidden_s += max(0.0, t_b - max(t_a, returns[call]))
    check(waves_ev and wave_s > 0, "no wave was replayed on the card")
    decode_s = sum(start_s) + sum(poll_s) + sum(wait_s)
    # the same pipelined run again under the profiler: the card's busy
    # time (kernels and copies, merged) and the part of it that ran while
    # the host was outside every decode call, i.e. ingesting
    hidden, busy_s, prof_run_s, top = pipelined_overlap(
        lambda: run(True)[3])
    _, _, serial, serial_s = run(False)
    check([r.symbols_used for r in serial] ==
          [r.symbols_used for r in reports],
          "pipelined and serial runs used different symbols")
    used = [r.symbols_used for r in reports]
    say(f"phase 7 sharded serving: |A|={n} S={SHARDS} replicas={REPLICAS} "
        f"d={d} each ({half} shared with the next); exact per peer; "
        f"symbols_used={used} overhead="
        f"{[round(u / d, 3) for u in used]} bytes_on_wire="
        f"{[r.bytes_received for r in reports]}; ticks={engine.ticks} "
        f"dispatches={engine.dispatches} units/dispatch max {max(sizes)}; "
        f"pipelined run {run_s:.2f} s = serve {sum(serve_s):.2f} s + "
        f"absorb {sum(absorb_s):.2f} s + decode {decode_s:.3f} s "
        f"(dispatch {sum(start_s):.3f} s, polls {sum(poll_s):.3f} s over "
        f"{len(poll_s)}, read-back {sum(wait_s):.3f} s; waves per "
        f"dispatch {waves}, host reads per dispatch {reads} at "
        f"{WAVES_PER_CHUNK} waves a read; ready() False at the first poll "
        f"for {not_ready} of {len(first_poll)} polled dispatches; no sync "
        f"inside any dispatch; hidden share {hidden_s / wave_s:.4f}: of the "
        f"card's {wave_s * 1e3:.3f} ms over {len(waves_ev)} waves, "
        f"{hidden_s * 1e3:.3f} ms ran after the call that enqueued them "
        f"returned) + rest; profiled rerun {prof_run_s:.2f} s: "
        f"the card busy {busy_s:.4f} s (idle {1 - busy_s / prof_run_s:.4f};"
        f" by name {top}), {hidden:.4f} of it outside every decode call; "
        f"serial rerun "
        f"{serial_s:.2f} s "
        f"(caches warm), same symbols_used, bytes_on_wire="
        f"{[r.bytes_received for r in serial]}; host_fallbacks=0 (set-up "
        f"{setup_s:.1f} s); launches {launches}; kernel ms {path_ms}")
    return launches, path_ms, wave


def qwen3_4b_shapes() -> list:
    """(name, shape) of every tensor of the public Qwen/Qwen3-4B checkpoint,
    under its Hugging Face names: no biases, q/k norms of one head's width,
    no ``lm_head.weight`` (tied to the embedding)."""
    c = QWEN3_4B
    d, ff, hd = c["d_model"], c["d_ff"], c["head_dim"]
    q, kv = c["heads"] * hd, c["kv_heads"] * hd
    out = [("model.embed_tokens.weight", (c["vocab"], d))]
    for i in range(c["layers"]):
        p = f"model.layers.{i}."
        out += [(p + "input_layernorm.weight", (d,)),
                (p + "self_attn.q_proj.weight", (q, d)),
                (p + "self_attn.k_proj.weight", (kv, d)),
                (p + "self_attn.v_proj.weight", (kv, d)),
                (p + "self_attn.o_proj.weight", (d, q)),
                (p + "self_attn.q_norm.weight", (hd,)),
                (p + "self_attn.k_norm.weight", (hd,)),
                (p + "post_attention_layernorm.weight", (d,)),
                (p + "mlp.gate_proj.weight", (ff, d)),
                (p + "mlp.up_proj.weight", (ff, d)),
                (p + "mlp.down_proj.weight", (d, ff))]
    out.append(("model.norm.weight", (d,)))
    return out


def phase_checkpoint(seed: int, kernels) -> tuple[dict, dict, dict]:
    """Main path 4: repair a stale Qwen3-4B-sized checkpoint store from a
    peer that fine-tuned the top four layers.  Returns the path's launches,
    its kernels' device ms and its largest wave (for phase 10)."""
    from repro_torch.checkpoint import (CheckpointStore, PeerEndpoint,
                                        sync_from_peer)
    from repro_torch.checkpoint.manager import CHUNK_BYTES, _digest
    from repro_torch.kernels import ops
    shapes = qwen3_4b_shapes()
    params = sum(int(np.prod(sh)) for _, sh in shapes)
    chunks = {name: -(-int(np.prod(sh)) * 2 // CHUNK_BYTES)
              for name, sh in shapes}
    tuned = [name for name, _ in shapes
             if any(name.startswith(f"model.layers.{i}.")
                    for i in TUNED_LAYERS)]
    check(params == CKPT_PARAMS and sum(chunks.values()) == CKPT_CHUNKS
          and sum(chunks[n] for n in tuned) == CKPT_DIFF,
          f"Qwen3-4B shapes: {params} parameters, {sum(chunks.values())} "
          f"chunks, {sum(chunks[n] for n in tuned)} tuned")
    gen = torch.Generator(device=DEVICE).manual_seed(seed)

    def draw(shape):
        return torch.randn(shape, generator=gen, device=DEVICE,
                           dtype=torch.bfloat16)

    stale_sd = {name: draw(sh) for name, sh in shapes}
    fresh_sd = dict(stale_sd)
    fresh_sd.update({name: draw(stale_sd[name].shape) for name in tuned})
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_ckpt_"))
    try:
        free = shutil.disk_usage(root).free
        need = 2 * params * 2 + (64 << 20)
        say(f"phase 8 checkpoint: {free / 1e9:.1f} GB free at {root}, "
            f"{need / 1e9:.1f} GB needed")
        check(free >= need, f"disk: {free} bytes free, {need} needed")
        # the host's one-thread chunk hashing rate, over the embedding
        emb = stale_sd["model.embed_tokens.weight"].cpu().reshape(-1) \
            .view(torch.uint8).numpy()
        t0 = time.perf_counter()
        for i in range(0, len(emb), CHUNK_BYTES):
            _digest("rate", i, emb[i:i + CHUNK_BYTES])
        hash_rate = len(emb) / (time.perf_counter() - t0)
        del emb
        stale = CheckpointStore(str(root / "stale"))
        fresh = CheckpointStore(str(root / "fresh"))
        secs = {}
        t0 = time.perf_counter()
        stale.save(100, stale_sd)
        secs["save stale"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        fresh.save(110, fresh_sd)
        secs["save fresh"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        n_records = stale.records().shape[0]
        secs["records"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        peer = PeerEndpoint(fresh)
        secs["peer set-up"] = time.perf_counter() - t0
        before = stale.manifest()["chunks"]
        differing = sum(before.get(cid) != dig
                        for cid, dig in fresh.manifest()["chunks"].items())
        decode_s = []
        real = ops.decode_device
        ops.decode_device = timed(real, decode_s)
        reset_launches(kernels)
        t0 = time.perf_counter()
        try:
            with largest_wave() as wave, launch_spans(
                    [fn.__name__ for fn in kernels]) as timed_launches:
                rep = sync_from_peer(stale, peer, device=DEVICE)
        finally:
            ops.decode_device = real
        secs["sync"] = time.perf_counter() - t0
        launches = read_launches(kernels)
        path_ms = spans_ms(timed_launches, launches)
        t0 = time.perf_counter()
        bad = stale.verify()
        secs["verify"] = time.perf_counter() - t0
        check(n_records == CKPT_CHUNKS, f"{n_records} records")
        check(differing == CKPT_DIFF, f"{differing} chunks differ, "
              f"{CKPT_DIFF} expected")
        check(rep.chunks_fetched == differing,
              f"fetched {rep.chunks_fetched} chunks, {differing} differ")
        check(stale.manifest()["chunks"] == fresh.manifest()["chunks"],
              "manifests differ after the repair")
        check(bad == [], f"{len(bad)} chunks fail verify after the repair")
        check(rep.host_fallbacks == 0, "the repair fell back to the host")
        check(all(launches[fn.__name__] > 0 for fn in kernels
                  if fn.__name__ != "iblt_encode")
              and launches.get("iblt_encode", 0) == 0,
              f"checkpoint path launches: {launches}")
        t0 = time.perf_counter()
        got = stale.restore({name: torch.empty_like(fresh_sd[name],
                                                    device="meta")
                             for name in tuned}, device=DEVICE)
        secs["restore tuned"] = time.perf_counter() - t0
        check(all(got[n].device.type == torch.device(DEVICE).type and
                  torch.equal(
            got[n].view(torch.int16), fresh_sd[n].view(torch.int16))
            for n in tuned), "restored layers differ from the peer's")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    del stale_sd, fresh_sd, got
    torch.cuda.empty_cache()
    say(f"phase 8 checkpoint repair: Qwen3-4B bf16 state_dict, {params:,} "
        f"parameters, {len(shapes)} tensors, {n_records} records of 16 B; "
        f"layers {TUNED_LAYERS.start}-{TUNED_LAYERS.stop - 1} re-drawn: "
        f"{differing} chunks differ (d = {2 * differing} records); "
        f"symbols_used={rep.symbols_used} "
        f"({rep.symbols_used / (2 * differing):.3f} a record) "
        f"symbol_bytes={rep.symbol_bytes} chunks_fetched="
        f"{rep.chunks_fetched} chunk_bytes={rep.chunk_bytes} naive_bytes="
        f"{rep.naive_bytes} savings={rep.savings:.2f}x; manifests equal, "
        f"verify clean, layers bit-equal on the card, host_fallbacks=0; "
        f"seconds {({k: round(v, 2) for k, v in secs.items()})} (blake2b "
        f"{hash_rate / 1e9:.3f} GB/s on one thread, so "
        f"{2 * params / hash_rate:.1f} s of hashing in each save and "
        f"verify), device "
        f"decode {sum(decode_s):.3f} s over {len(decode_s)} windows; "
        f"launches {launches}; kernel ms {path_ms}")
    return launches, path_ms, wave


def phase_reconcile_sets(seed: int) -> None:
    """``reconcile_sets`` on the card: two 10⁶-item Sketches, d = 1,000."""
    from repro_torch.core import Sketch, reconcile_sets
    n, half = N_SETS, D_SETS // 2
    recs = random_records(np.random.default_rng([seed, 3]), n + half,
                          SET_BYTES)
    a, b = recs[:n], np.concatenate([recs[:n - half], recs[n:]])
    t0 = time.perf_counter()
    sa, sb = Sketch.from_items(a, SET_BYTES), Sketch.from_items(b, SET_BYTES)
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    only_a, only_b, used = reconcile_sets(sa, sb, device=DEVICE)
    run_s = time.perf_counter() - t0
    check(as_set(only_a) == as_set(recs[n - half:n]),
          "reconcile_sets: wrong A-only items")
    check(as_set(only_b) == as_set(recs[n:]),
          "reconcile_sets: wrong B-only items")
    say(f"phase 9 reconcile_sets: |A|={n} d={D_SETS} items of {SET_BYTES} B; "
        f"exact; symbols_used={used} ({used / D_SETS:.3f} an item); "
        f"{run_s:.2f} s (Sketches {setup_s:.1f} s)")


def _tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _tree_leaves(v)]
    return [tree]


def _pad_to_spec(states, spec):
    """Prefill states -> decode caches shaped as ``spec`` (the model's
    ``cache_spec`` meta tensors at the decode context): a K/V cache is
    zero-padded past the prompt along its position axis; recurrent
    states, rolled windows and cross-attention K/V already have their
    shapes.  A DTensor cache (the mesh path) has its block padded and
    keeps its placements: the position axis is split over no mesh
    axis."""
    from torch.distributed.tensor import DTensor
    if isinstance(states, dict):
        return {k: _pad_to_spec(v, spec[k]) for k, v in states.items()}
    if isinstance(states, (list, tuple)):
        return [_pad_to_spec(v, t) for v, t in zip(states, spec)]
    if tuple(states.shape) == tuple(spec.shape):
        return states
    extra = spec.shape[-3] - states.shape[-3]
    check(extra > 0 and states.shape[:-3] == spec.shape[:-3] and
          states.shape[-2:] == spec.shape[-2:],
          f"state {tuple(states.shape)} does not pad to {tuple(spec.shape)}")
    if not isinstance(states, DTensor):
        return torch.nn.functional.pad(states, (0, 0, 0, 0, 0, extra))
    check(not any(p.is_shard(states.dim() - 3) for p in states.placements),
          f"a cache placed as {states.placements} splits its positions")
    return DTensor.from_local(
        torch.nn.functional.pad(states.to_local(), (0, 0, 0, 0, 0, extra)),
        states.device_mesh, states.placements, run_check=False)


def step_busy(fn, around=contextlib.nullcontext
              ) -> tuple[float, float, list]:
    """(ms of kernels on the card, ms of wall time, the four kernels with
    the most summed time as (name, ms)) of one call of ``fn`` under
    ``torch.profiler``, the card idle before and synchronised after, the
    call inside the context ``around()`` (the trace's processing after
    it); kernel intervals are merged, so overlapping kernels count
    once."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof, around():
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy_us, reach = 0.0, float("-inf")
    for a, b in spans:
        busy_us += max(0.0, b - max(a, reach))
        reach = max(reach, b)
    check(busy_us > 0, "the profiler saw no kernel on the card")
    by_name = collections.Counter()
    for e in kernels:
        by_name[e.name[:48]] += e.time_range.elapsed_us() * 1e-3
    top = [(name, round(ms, 3)) for name, ms in by_name.most_common(4)]
    return busy_us * 1e-3, wall_ms, top


def host_syncs(fn) -> list:
    """Where one call of ``fn`` made the host wait for the card: the
    file:line of each of ``torch.cuda.set_sync_debug_mode("warn")``'s
    warnings."""
    import warnings
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    # the mode's own notice ("Synchronization debug mode is a prototype
    # feature ...") is no sync
    return [f"{'/'.join(Path(w.filename).parts[-2:])}:{w.lineno}"
            for w in seen if "synchroniz" in str(w.message)
            and "prototype feature" not in str(w.message)]


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_clone(v) for v in tree]
    return tree.clone()


def _init_on_card(cfg, seed: int):
    """(model, params, init seconds, parameter count, bytes) of ``cfg``
    built on the card, weights from the port's init and a generator
    there; each weight checked to be in the config's dtype, or in fp32
    where the reference keeps it so (FP32_WEIGHTS)."""
    from repro_torch.models import build_model
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, device=DEVICE)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=DEVICE).manual_seed(seed))[0]
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    dtype = getattr(torch, cfg.dtype)
    for path, t in torch.utils._pytree.tree_flatten_with_path(params)[0]:
        want = torch.float32 if path[-1].key in FP32_WEIGHTS else dtype
        check(t.dtype == want, f"weight {torch.utils._pytree.keystr(path)} "
              f"is {t.dtype}, not {want}")
    leaves = _tree_leaves(params)
    return (model, params, init_s, sum(t.numel() for t in leaves),
            sum(t.numel() * t.element_size() for t in leaves))


def _forward_logits(model, params, batch, lo: int, hi: int):
    """Logits at positions lo..hi-1 of one forward over ``batch``'s tokens
    (the decoder's, over the encoded frames, for an encoder-decoder)."""
    if hasattr(model, "encode"):
        from repro_torch.models.layers import embed_lookup, unembed
        enc = model.encode(params, batch["frames"])
        x, _ = model._dec_stack(
            params, embed_lookup(params["embed"], batch["tokens"]), enc)
        return model._mask(unembed(x[:, lo:hi], params["embed"]))
    h, _, _ = model._stack(params, model._embed_inputs(params, batch))
    return model.logits(params, h[:, lo:hi])


def _forced_decode(model, params, caches, ids, P: int):
    """Decode logits (B, steps, V) feeding ``ids[:, t]`` at position P + t
    from ``caches`` (updated in place)."""
    B, out = ids.shape[0], []
    for t in range(ids.shape[1]):
        lg, caches = model.decode_step(params, ids[:, t:t + 1], caches,
                                       torch.full((B,), P + t, device=DEVICE))
        out.append(lg[:, 0])
    return torch.stack(out, dim=1)


def _serve(model, params, cfg, batch, steps: int) -> dict:
    """Prefill ``batch`` (after a warm-up at the same shapes: a first call
    at a new shape costs ~1 s more), then ``steps`` greedy decode steps at
    a context of prompt + steps.  Returns the timings, the last prefill
    logits, the decode logits (B, steps, V), the ids fed (B, steps + 1)
    and the caches.  Checks finite logits and no padded-vocab id."""
    B, P = batch["tokens"].shape
    spec = model.cache_spec(B, P + steps)[0]
    _, warm = model.prefill(params, batch)
    model.decode_step(params, batch["tokens"][:, :1], _pad_to_spec(warm, spec),
                      torch.full((B,), P, device=DEVICE))
    del warm
    torch.cuda.synchronize()
    counting = getattr(model, "moe_drops", None) is not None
    drops = {"prefill": [], "decode": []}
    if counting:
        model.moe_drops = drops["prefill"]
    t0 = time.perf_counter()
    last, states = model.prefill(params, batch)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    if counting:
        model.moe_drops = drops["decode"]
    caches = _pad_to_spec(states, spec)
    del states
    tok = last[:, -1].argmax(dim=-1, keepdim=True)
    fed, step_logits = [tok], []
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for t in range(steps):
        pos = torch.full((B,), P + t, device=DEVICE)
        lg, caches = model.decode_step(params, tok, caches, pos)
        step_logits.append(lg[:, 0])
        tok = lg[:, 0].argmax(dim=-1, keepdim=True)
        fed.append(tok)
    end.record()
    end.synchronize()
    decoded = torch.stack(step_logits, dim=1)
    ids = torch.cat(fed, dim=1)
    check(bool(torch.isfinite(last).all()) and
          bool(torch.isfinite(decoded).all()), f"{cfg.name}: non-finite "
          "logits")
    check(int(ids.max()) < cfg.vocab, f"{cfg.name}: a padded-vocab id was "
          "chosen")
    return {"prefill_s": prefill_s, "step_ms": start.elapsed_time(end) / steps,
            "last": last, "decoded": decoded, "ids": ids, "caches": caches,
            "drops": {k: [int(c) for c in v] for k, v in drops.items()}}


def _card_vs_cpu(small, seed: int, rng, S: int) -> float:
    """Max |logits on the card - logits on the CPU| of one fp32 forward of
    ``small`` over S random tokens (and random frames for an
    encoder-decoder), the same weights drawn on the CPU."""
    from repro_torch.models import build_model
    cpu_model = build_model(small, device="cpu")
    cpu_params = cpu_model.init(torch.Generator().manual_seed(seed))[0]
    batch = {"tokens": torch.from_numpy(rng.integers(0, small.vocab,
                                                     size=(1, S)))}
    if small.frontend == "audio_stub":
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (1, small.encoder_frames, small.d_model), dtype=np.float32))
    outs = []
    with torch.inference_mode():
        for dev in ("cpu", DEVICE):
            m = build_model(small, device=dev)
            p = cpu_params if dev == "cpu" else \
                _tree_to(cpu_params, torch.device(dev))
            b = {k: v.to(dev) for k, v in batch.items()}
            outs.append(_forward_logits(m, p, b, 0, S).cpu())
            del m, p
    torch.cuda.empty_cache()
    return float((outs[0] - outs[1]).abs().max())


def _smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()


def phase_serve(seed: int) -> None:
    """Phase 11: the attention-family model stack serving Qwen3-4B at full
    width and depth in bf16 (``get_config("qwen3-4b")`` unchanged, weights
    from the port's init on the card): SERVE_B prompts of SERVE_PROMPT
    random tokens, ``prefill``, caches padded to SERVE_CTX, SERVE_STEPS
    greedy ``decode_step``s.  Checks: finite logits, no padded-vocab id,
    the decode's logits against one teacher-forced forward of prompt plus
    generated tokens (max |diff| <= SERVE_TOL), and the card against the
    CPU in fp32 at full width and CARD_CPU_LAYERS layers (max |diff| <=
    CARD_CPU_TOL)."""
    from repro_torch.configs import get_config
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("qwen3-4b")
    B, P, steps = SERVE_B, SERVE_PROMPT, SERVE_STEPS
    check(P + steps == SERVE_CTX, "SERVE_CTX is the prompt plus the steps")
    model, params, init_s, n_params, n_bytes = _init_on_card(cfg, seed)
    rng = np.random.default_rng([seed, 5])
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab, size=(B, P))) \
        .to(DEVICE)
    with torch.inference_mode():
        run = _serve(model, params, cfg, {"tokens": prompts}, steps)
        decoded, ids = run["decoded"], run["ids"]
        prefill_s, step_ms = run["prefill_s"], run["step_ms"]
        # teacher forcing: the prompt and the fed tokens in one forward
        seq = torch.cat([prompts, ids[:, :steps]], dim=1)
        forced = _forward_logits(model, params, {"tokens": seq}, P, P + steps)
        diff = float((forced - decoded).abs().max())
        agree = float((forced.argmax(-1) == decoded.argmax(-1)).float()
                      .mean())
        peak = torch.cuda.max_memory_allocated()
        # one more step (rewriting the last slot) under the profiler: the
        # card's kernel time against the step's wall time
        busy_ms, wall_ms, top = step_busy(lambda: model.decode_step(
            params, ids[:, -1:], run["caches"],
            torch.full((B,), P + steps - 1, device=DEVICE)))
    check(diff <= SERVE_TOL, f"decode vs teacher-forced forward: max |diff| "
          f"{diff} > {SERVE_TOL}")
    del params, run, forced, decoded, model
    torch.cuda.empty_cache()
    cpu_diff = _card_vs_cpu(cfg.scaled(n_layers=CARD_CPU_LAYERS,
                                       dtype="float32"), seed, rng,
                            CARD_CPU_S)
    check(cpu_diff <= CARD_CPU_TOL, f"card vs CPU fp32: max |diff| "
          f"{cpu_diff} > {CARD_CPU_TOL}")
    say(f"phase 11 serve Qwen3-4B: {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads} heads / {cfg.n_kv_heads} KV of "
        f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab} padded to "
        f"{cfg.padded_vocab}, bf16: {n_params:,} parameters, {n_bytes:,} "
        f"bytes (init {init_s:.2f} s); B={B} prompts of {P} tokens: prefill "
        f"{prefill_s:.3f} s = {B * P / prefill_s:,.0f} tokens/s; {steps} "
        f"greedy decode steps at S_ctx={SERVE_CTX}: {step_ms:.2f} ms a step "
        f"({B * 1e3 / step_ms:,.0f} tokens/s); logits finite, no padded id; "
        f"one step under the profiler: kernels {busy_ms:.2f} ms of "
        f"{wall_ms:.2f} ms wall (card idle {1 - busy_ms / wall_ms:.3f}), "
        f"largest {top}; "
        f"teacher-forced max |diff| {diff:.4f} (tol {SERVE_TOL}), argmax "
        f"agreement {agree:.4f}; card vs CPU fp32 at {CARD_CPU_LAYERS} "
        f"layers, S={CARD_CPU_S}: max |diff| {cpu_diff:.2e} (tol "
        f"{CARD_CPU_TOL}); max_memory_allocated {peak:,} bytes; {_smi()}")


def _moe_against_forward(model, params, prompts, ids) -> tuple[dict, list]:
    """The MoE decode against a teacher-forced forward of ``prompts`` plus
    ``ids`` in the dropless "tp" mode on the same weights.  From the TP
    prefill's caches, the TP decode and the EP decode, fed the same
    tokens; from the EP prefill's caches (its dropped pairs counted), the
    EP decode.  Returns ({comparison: |diff| of each decode position
    (B, steps), max over the vocabulary}, the EP prefill's drops per
    call)."""
    from repro_torch.models import build_model
    B, P = prompts.shape
    steps = ids.shape[1]
    tp = build_model(model.cfg.scaled(moe_mode="tp"), device=DEVICE)
    seq = torch.cat([prompts, ids], dim=1)
    forced = _forward_logits(tp, params, {"tokens": seq}, P, P + steps)
    spec = model.cache_spec(B, P + steps)[0]
    _, states = tp.prefill(params, {"tokens": prompts})
    caches = _pad_to_spec(states, spec)
    del states
    ep_tf = _forced_decode(model, params, _clone(caches), ids, P)
    tp_dec = _forced_decode(tp, params, caches, ids, P)
    del caches
    model.moe_drops = []
    _, states = model.prefill(params, {"tokens": prompts})
    drops = [int(c) for c in model.moe_drops]
    model.moe_drops = None
    ep_dec = _forced_decode(model, params, _pad_to_spec(states, spec), ids,
                            P)
    del states

    def gap(a, b):
        return (a - b).abs().amax(dim=-1)
    return ({"tp decode vs forward": gap(tp_dec, forced),
             "ep decode from tp caches vs forward": gap(ep_tf, forced),
             "ep decode vs forward": gap(ep_dec, forced),
             "ep decode vs tp decode": gap(ep_dec, tp_dec)}, drops)


def phase_serve_moe(seed: int) -> dict:
    """Phase 12a: Qwen3-30B-A3B (``get_config`` unchanged: bf16, 48 layers,
    128 experts, top-8, EP at capacity factor 1.25) at full width and
    depth, weights from the port's init on the card.  SERVE_B prompts of
    SERVE_PROMPT tokens, ``prefill``, SERVE_STEPS greedy EP decode steps,
    each EP call's dropped (token, expert) pairs counted.  Capacity
    depends on the call's tokens (cap 320 at the prefill's 4,096, 8 at a
    step's 4, where no pair can drop), so decodes are compared with a
    teacher-forced forward in the dropless "tp" mode on the same weights
    (``_moe_against_forward``).  In bf16 a router's top-8 flips wherever
    two experts' probabilities lie within the rounding that separates a
    decode step from the forward, and the flipped expert moves that
    token's logits by O(1) (max |diff| 6.57 at 48 layers on the H100), so
    the bf16 comparison is reported, per position, not held.  The check is
    the same comparison in fp32 at full width and MOE_FP32_LAYERS layers,
    where rounding (and so a flip) is ~10^5 times rarer: each decode within
    MOE_FP32_TOL of the forward, the EP decode from the EP prefill's
    caches only when that prefill dropped nothing.  Then the card against
    the CPU in fp32 at full width and MOE_CARD_CPU_LAYERS layers.
    Returns, for phase 14b, the prompts, the EP prefill's last logits, the
    first MESH_SERVE_STEPS decode steps' logits, the tokens fed and the
    dropped pairs of those calls."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.moe import capacity
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(MOE_ARCH)
    B, P, steps = SERVE_B, SERVE_PROMPT, SERVE_STEPS
    model, params, init_s, n_params, n_bytes = _init_on_card(cfg, seed)
    check(n_params == MOE_PARAMS, f"{n_params:,} parameters, the "
          f"reference's init has {MOE_PARAMS:,}")
    model.moe_drops = []
    rng = np.random.default_rng([seed, 12])
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab, size=(B, P))) \
        .to(DEVICE)
    k, E, cf = cfg.experts_per_token, cfg.n_experts, cfg.capacity_factor
    with torch.inference_mode():
        run = _serve(model, params, cfg, {"tokens": prompts}, steps)
        ids, drops = run["ids"][:, :steps], run["drops"]
        model.moe_drops = None
        busy_ms, wall_ms, top = step_busy(lambda: model.decode_step(
            params, ids[:, -1:], run["caches"],
            torch.full((B,), P + steps - 1, device=DEVICE)))
        del run["caches"]
        pre_busy, pre_wall, pre_top = step_busy(
            lambda: model.prefill(params, {"tokens": prompts}))
        caches = _pad_to_spec(model.prefill(params, {"tokens": prompts})[1],
                              model.cache_spec(B, P + steps)[0])
        syncs = host_syncs(lambda: model.decode_step(
            params, ids[:, :1], caches, torch.full((B,), P, device=DEVICE)))
        del caches
        tp = build_model(cfg.scaled(moe_mode="tp"), device=DEVICE)
        t0 = time.perf_counter()
        forced = _forward_logits(tp, params, {"tokens": torch.cat(
            [prompts, ids], dim=1)}, P, P + steps)
        torch.cuda.synchronize()
        forced_s = time.perf_counter() - t0
        bf16_gap = (run["decoded"] - forced).abs().amax(dim=-1)
        agree = float((forced.argmax(-1) == run["decoded"].argmax(-1))
                      .float().mean())
        del forced
        t0 = time.perf_counter()
        _, states = tp.prefill(params, {"tokens": prompts})
        tp_dec = _forced_decode(tp, params, _pad_to_spec(
            states, tp.cache_spec(B, P + steps)[0]), ids, P)
        torch.cuda.synchronize()
        tp_step_ms = (time.perf_counter() - t0) * 1e3 / steps
        ep_tp_gap = (run["decoded"] - tp_dec).abs().amax(dim=-1)
        del states, tp_dec
        peak = torch.cuda.max_memory_allocated()
    prefill_s, step_ms = run["prefill_s"], run["step_ms"]
    pre = drops["prefill"]
    served = {"prompts": prompts.cpu(), "last": run["last"].cpu(),
              "decoded": run["decoded"][:, :MESH_SERVE_STEPS].cpu(),
              "ids": run["ids"][:, :MESH_SERVE_STEPS + 1].cpu(),
              "drops": {"prefill": list(pre), "decode": drops["decode"][
                  :cfg.n_layers * MESH_SERVE_STEPS]}}
    del params, run, model, tp
    torch.cuda.empty_cache()
    # the check: fp32, full width, MOE_FP32_LAYERS layers, the same tokens
    small = cfg.scaled(n_layers=MOE_FP32_LAYERS, dtype="float32")
    model, params, _, _, _ = _init_on_card(small, seed)
    with torch.inference_mode():
        gaps, fp32_drops = _moe_against_forward(model, params, prompts, ids)
    held = ["tp decode vs forward", "ep decode from tp caches vs forward"]
    if sum(fp32_drops) == 0:
        held += ["ep decode vs forward", "ep decode vs tp decode"]
    fp32 = {w: float(g.max()) for w, g in gaps.items()}
    del params, model, gaps
    torch.cuda.empty_cache()
    cpu_diff = _card_vs_cpu(cfg.scaled(n_layers=MOE_CARD_CPU_LAYERS,
                                       dtype="float32"), seed, rng,
                            CARD_CPU_S)
    shown = {w: f"{d:.2e}" + ("" if w in held else " (not held: that EP "
                              "prefill dropped pairs)")
             for w, d in fp32.items()}
    say(f"phase 12 serve {MOE_ARCH}: {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads} heads / {cfg.n_kv_heads} KV of "
        f"{cfg.head_dim}, {E} experts of d_ff {cfg.d_ff}, top-{k}, "
        f"{cfg.moe_mode} at capacity factor {cf}, vocab {cfg.vocab}, bf16 "
        f"(router fp32): {n_params:,} parameters, {n_bytes:,} bytes (init "
        f"{init_s:.2f} s); B={B} prompts of {P} tokens: prefill "
        f"{prefill_s:.3f} s = {B * P / prefill_s:,.0f} tokens/s; {steps} "
        f"greedy EP decode steps: {step_ms:.2f} ms a step "
        f"({B * 1e3 / step_ms:,.0f} tokens/s); one step under the profiler: "
        f"kernels {busy_ms:.2f} ms of {wall_ms:.2f} ms wall (card idle "
        f"{1 - busy_ms / wall_ms:.3f}), largest {top}; a prefill under the "
        f"profiler: kernels {pre_busy:.1f} ms of {pre_wall:.1f} ms wall, "
        f"largest {pre_top}; host syncs in one EP decode step {syncs}; "
        f"TP decode {tp_step_ms:.2f} ms a step "
        f"(its prefill included); dropped pairs: prefill (cap "
        f"{capacity(B * P, k, E, cf)}) {sum(pre):,} of "
        f"{B * P * k * len(pre):,} in {sum(c > 0 for c in pre)} of "
        f"{len(pre)} calls, per call {pre}; decode (cap "
        f"{capacity(B, k, E, cf)}) {sum(drops['decode'])} in "
        f"{len(drops['decode'])} calls; the teacher-forced TP forward over "
        f"{P + steps} tokens {forced_s:.3f} s (EP there: cap "
        f"{capacity(B * (P + steps), k, E, cf)}); bf16 (reported, not held: "
        f"routing flips) EP decode vs the forward: max |diff| "
        f"{float(bf16_gap.max()):.4f}, median over the {bf16_gap.numel()} "
        f"positions {float(bf16_gap.median()):.4f}, positions within "
        f"{MOE_TOL}: {float((bf16_gap <= MOE_TOL).float().mean()):.3f}, "
        f"per step max {[round(float(x), 3) for x in bf16_gap.amax(0)]}, "
        f"argmax agreement {agree:.4f}; EP vs TP decode from their own "
        f"prefills max |diff| {float(ep_tp_gap.max()):.4f}; fp32 at "
        f"{MOE_FP32_LAYERS} layers, the same tokens: EP prefill dropped "
        f"{sum(fp32_drops)} pairs {fp32_drops}, max |diff| {shown} (tol "
        f"{MOE_FP32_TOL}); card vs CPU fp32 at {MOE_CARD_CPU_LAYERS} layer, "
        f"S={CARD_CPU_S}: max |diff| {cpu_diff:.2e} (tol {CARD_CPU_TOL}); "
        f"max_memory_allocated {peak:,} bytes; {_smi()}")
    check(len(pre) == cfg.n_layers and
          len(drops["decode"]) == cfg.n_layers * steps,
          "one drop count per EP call")
    check(sum(drops["decode"]) == 0, "a decode step dropped pairs")
    for what in held:
        check(fp32[what] <= MOE_FP32_TOL, f"{MOE_ARCH} fp32 {what}: max "
              f"|diff| {fp32[what]} > {MOE_FP32_TOL}")
    check(cpu_diff <= CARD_CPU_TOL, f"{MOE_ARCH} card vs CPU fp32: max "
          f"|diff| {cpu_diff} > {CARD_CPU_TOL}")
    return served


def phase_serve_family(arch: str, seed: int) -> None:
    """Phase 12b: ``get_config(arch)`` unchanged at full width and depth in
    bf16, weights from the port's init on the card: SERVE_B prompts of
    FAMILIES' length (and random stub frames of (B, 1500, 512) for
    whisper-base), ``prefill``, greedy ``decode_step``s, and the bf16
    decode against one teacher-forced forward, reported per position
    (on the H100 rwkv6-1.6b drifts by 0.48 in bf16, past the 0.25 first
    held; the same code in fp32 agrees to 2.2e-4).  The check is
    the same comparison in fp32 at full width and full depth (within
    FAMILY_FP32_TOL), then the card against the CPU in fp32 at a few
    layers."""
    from repro_torch.configs import get_config
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(arch)
    P, steps, tol, cpu_layers = FAMILIES[arch]
    B = SERVE_B
    model, params, init_s, n_params, n_bytes = _init_on_card(cfg, seed)
    rng = np.random.default_rng([seed, 12, len(arch)])
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab, size=(B, P))).to(DEVICE)}
    if cfg.frontend == "audio_stub":
        batch["frames"] = torch.randn(
            (B, cfg.encoder_frames, cfg.d_model), device=DEVICE,
            generator=torch.Generator(device=DEVICE).manual_seed(seed))
    with torch.inference_mode():
        run = _serve(model, params, cfg, batch, steps)
        ids = run["ids"][:, :steps]
        seq = dict(batch, tokens=torch.cat([batch["tokens"], ids], dim=1))
        forced = _forward_logits(model, params, seq, P, P + steps)
        gap = (forced - run["decoded"]).abs().amax(dim=-1)
        agree = float((forced.argmax(-1) == run["decoded"].argmax(-1))
                      .float().mean())
        busy_ms, wall_ms, top = step_busy(lambda: model.decode_step(
            params, ids[:, -1:], run["caches"],
            torch.full((B,), P + steps - 1, device=DEVICE)))
        peak = torch.cuda.max_memory_allocated()
    prefill_s, step_ms = run["prefill_s"], run["step_ms"]
    del params, run, forced, model
    # the check: the same prompts and fed tokens in fp32, full depth
    model, params, _, _, _ = _init_on_card(cfg.scaled(dtype="float32"), seed)
    with torch.inference_mode():
        _, states = model.prefill(params, batch)
        dec = _forced_decode(model, params, _pad_to_spec(
            states, model.cache_spec(B, P + steps)[0]), ids, P)
        del states
        fp32_diff = float((_forward_logits(model, params, seq, P, P + steps)
                           - dec).abs().max())
    del params, model, dec
    torch.cuda.empty_cache()
    small = cfg.scaled(n_layers=cpu_layers, dtype="float32")
    if cfg.family == "encdec":
        small = small.scaled(encoder_layers=cpu_layers)
    cpu_diff = _card_vs_cpu(small, seed, rng, CARD_CPU_S)
    say(f"phase 12 serve {arch}: {cfg.n_layers} layers "
        f"{list(cfg.block_pattern)}, d_model {cfg.d_model}, vocab "
        f"{cfg.vocab}, bf16: {n_params:,} parameters, {n_bytes:,} bytes "
        f"(init {init_s:.2f} s); B={B} prompts of {P} tokens"
        + (f" over {cfg.encoder_frames} stub frames" if "frames" in batch
           else "") +
        f": prefill {prefill_s:.3f} s = {B * P / prefill_s:,.0f} tokens/s; "
        f"{steps} greedy decode steps: {step_ms:.2f} ms a step "
        f"({B * 1e3 / step_ms:,.0f} tokens/s); one step under the profiler: "
        f"kernels {busy_ms:.2f} ms of {wall_ms:.2f} ms wall (card idle "
        f"{1 - busy_ms / wall_ms:.3f}), largest {top}; bf16 (reported) "
        f"decode vs the teacher-forced forward over {P + steps} tokens: max "
        f"|diff| {float(gap.max()):.4f}, median {float(gap.median()):.4f}, "
        f"positions within {tol}: {float((gap <= tol).float().mean()):.3f}, "
        f"argmax agreement {agree:.4f}; fp32 at full depth: max |diff| "
        f"{fp32_diff:.2e} (tol {FAMILY_FP32_TOL}); card vs CPU fp32 at "
        f"{cpu_layers} layers, S={CARD_CPU_S}: max |diff| {cpu_diff:.2e} "
        f"(tol {CARD_CPU_TOL}); max_memory_allocated {peak:,} bytes; "
        f"{_smi()}")
    check(fp32_diff <= FAMILY_FP32_TOL, f"{arch} fp32 decode vs "
          f"teacher-forced forward: max |diff| {fp32_diff} > "
          f"{FAMILY_FP32_TOL}")
    check(cpu_diff <= CARD_CPU_TOL, f"{arch} card vs CPU fp32: max |diff| "
          f"{cpu_diff} > {CARD_CPU_TOL}")


def _leaves_of(tree) -> list:
    return torch.utils._pytree.tree_flatten(tree)[0]


def _finite(values) -> bool:
    return all(bool(torch.isfinite(torch.as_tensor(v)).all())
               for v in values)


def _train_flops(cfg, n_params: int, B: int, S: int) -> float:
    """Model FLOPs of one training step: 6·N·T for the weights' matmuls
    (N every parameter, T = B·S tokens) plus causal attention's
    6·B·S²·L·H·dh (QKᵀ and PV, 2·B·H·S²·dh each forward, halved by the
    mask, times 3 for the backward); remat's recomputation not counted."""
    return 6.0 * n_params * B * S + \
        6.0 * B * S * S * cfg.n_layers * cfg.n_heads * cfg.head_dim


def _train_opt(cfg):
    """13a's optimizer settings: AdamW as configured, TRAIN_STEPS steps,
    a 1-step warm-up to TRAIN_LR."""
    from repro_torch.train.loop import make_opt_config
    return dataclasses.replace(make_opt_config(cfg, total_steps=TRAIN_STEPS),
                               warmup=1, lr=TRAIN_LR)


def phase_train(seed: int) -> dict:
    """Phase 13a: ``get_config("qwen3-4b")`` trained at full width and depth
    on the card: bf16 weights from the port's init, remat, AdamW with
    fp32 state, TRAIN_STEPS steps of ``make_train_step`` on the driver's
    ``synthetic_batch`` at B = TRAIN_B, S = TRAIN_S, drawn onto the card
    before the steps.  Step 1 warms up, its peak memory read after the
    gradients and after the update; steps 2-5 run with the sync debug
    mode at "warn" (host syncs a step) and are timed by event pairs; step
    6 runs under the profiler (the card's busy share).  Checks: finite
    losses and gradient norms, the optimizer's step 6, every parameter
    leaf moved.  Returns its losses, seconds a step, busy share and peak
    for phase 14a."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import synthetic_batch
    from repro_torch.models import build_model
    from repro_torch.train.loop import init_train_state, make_train_step
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(TRAIN_ARCH)
    check(cfg.remat and cfg.dtype == "bfloat16" and cfg.optimizer == "adamw"
          and cfg.opt_state_dtype == "float32", "qwen3-4b's training config "
          "changed")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, device=DEVICE)
    opt_cfg = _train_opt(cfg)
    t0 = time.perf_counter()
    params, opt_state, _ = init_train_state(
        model, opt_cfg, torch.Generator(device=DEVICE).manual_seed(seed))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    leaves = _leaves_of(params)
    n_params = sum(t.numel() for t in leaves)
    check(n_params == TRAIN_PARAMS, f"{n_params:,} parameters, not "
          f"{TRAIN_PARAMS:,}")
    state_bytes = sum(t.numel() * t.element_size()
                      for t in _leaves_of(opt_state))
    before = [t.detach().to("cpu", copy=True) for t in leaves]
    step = make_train_step(model, opt_cfg)
    B, S = TRAIN_B, TRAIN_S
    batches = [synthetic_batch(cfg, t, B, S, DEVICE)
               for t in range(TRAIN_STEPS)]
    metrics = []

    def one(t):
        nonlocal params, opt_state
        params, opt_state, m = step(params, opt_state, batches[t])
        metrics.append((m["loss"], m["grad_norm"]))

    with _step_peaks() as peaks:
        one(0)
    events = [torch.cuda.Event(enable_timing=True) for _ in range(5)]

    def timed_steps():
        events[0].record()
        for t in range(1, 5):
            one(t)
            events[t].record()

    syncs = host_syncs(timed_steps)
    events[-1].synchronize()
    step_ms = [events[i].elapsed_time(events[i + 1]) for i in range(4)]
    busy_ms, wall_ms, top = step_busy(lambda: one(5))
    peak = max(peaks[0], torch.cuda.max_memory_allocated())
    losses = [float(m[0]) for m in metrics]
    gnorms = [float(m[1]) for m in metrics]
    check(_finite(losses + gnorms), f"non-finite loss or grad norm: "
          f"{losses} {gnorms}")
    check(int(opt_state["step"]) == TRAIN_STEPS, f"optimizer step "
          f"{int(opt_state['step'])}, not {TRAIN_STEPS}")
    still = [i for i, (a, b) in enumerate(zip(before, _leaves_of(params)))
             if torch.equal(a.to(DEVICE), b.detach())]
    check(not still, f"{len(still)} parameter leaves did not move: {still}")
    mean_s = sum(step_ms) / len(step_ms) / 1e3
    flops = _train_flops(cfg, n_params, B, S)
    say(f"phase 13a train {TRAIN_ARCH}: {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, heads of {cfg.head_dim}, bf16, remat, AdamW "
        f"(state {opt_cfg.state_dtype}, lr {opt_cfg.lr} after a 1-step "
        f"warm-up): {n_params:,} parameters (init {init_s:.2f} s), optimizer "
        f"state {state_bytes:,} bytes; train_4k's global batch of 256 cut "
        f"to B={B} of S={S} on one card ({B * S:,} tokens a step); "
        f"{TRAIN_STEPS} steps, losses {[round(v, 4) for v in losses]}, grad "
        f"norms {[round(v, 4) for v in gnorms]}; steps 2-5 "
        f"{[round(v / 1e3, 4) for v in step_ms]} s (event pairs): "
        f"{mean_s:.4f} s a step = {B * S / mean_s:,.0f} tokens/s; step 6 "
        f"under the profiler: kernels {busy_ms:.1f} ms of {wall_ms:.1f} ms "
        f"wall (busy {busy_ms / wall_ms:.3f}), largest {top}; model FLOPs "
        f"a step {flops:.4e} (6·N·T + 6·B·S²·L·H·dh) over "
        f"{PEAK_BF16_FLOPS:.0e} FLOP/s dense bf16: FLOP share "
        f"{flops / PEAK_BF16_FLOPS / mean_s:.4f}; host syncs in steps 2-5: "
        f"{len(syncs)} {dict(collections.Counter(syncs))}; "
        f"max_memory_allocated {peak:,} bytes (step 1: {peaks[0]:,} to its "
        f"gradients, {peaks[1]:,} in its update); every leaf moved; "
        f"{_smi()}")
    del params, opt_state, model, before, leaves, step, metrics, batches
    torch.cuda.empty_cache()
    return {"losses": losses, "step_s": mean_s, "busy": busy_ms / wall_ms,
            "peak": peak}


@contextlib.contextmanager
def _step_peaks():
    """Peak bytes allocated on the card while the block runs one train
    step, to the end of its gradients and within its update: a wrapper
    around ``loop.loss_and_grads`` and ``loop.apply_updates``."""
    from repro_torch.train import loop
    grads_fn, update_fn, peaks = loop.loss_and_grads, loop.apply_updates, []

    def grads(*args):
        out = grads_fn(*args)
        peaks.append(torch.cuda.max_memory_allocated())
        torch.cuda.reset_peak_memory_stats()
        return out

    def update(*args):
        out = update_fn(*args)
        peaks.append(torch.cuda.max_memory_allocated())
        return out

    loop.loss_and_grads, loop.apply_updates = grads, update
    try:
        yield peaks
    finally:
        loop.loss_and_grads, loop.apply_updates = grads_fn, update_fn


@contextlib.contextmanager
def _tapped_grads():
    """Collect the gradients ``make_train_step`` computes while the block
    runs (a wrapper around ``loop.loss_and_grads``)."""
    from repro_torch.train import loop
    real, seen = loop.loss_and_grads, []

    def tap(*args):
        out = real(*args)
        seen.append(out[2])
        return out

    loop.loss_and_grads = tap
    try:
        yield seen
    finally:
        loop.loss_and_grads = real


def _rel(a, b) -> float:
    """||a - b|| / ||b|| on the CPU in float64 (0 where both are 0)."""
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    nb = float(b.norm())
    return float((a - b).norm()) / nb if nb else float((a - b).norm())


def _train_both(cfg, opt_cfg, batches, microbatches=1, compression=False,
                seed=0):
    """The same parameters (drawn on the CPU from ``seed``) trained on the
    card (``cfg`` with remat on) and on the CPU (as given), one step a
    batch.  Returns per device: the losses, grad norms, each step's
    gradients, the parameters before and after."""
    from repro_torch.models import build_model
    from repro_torch.train.compression import ErrorFeedbackInt8
    from repro_torch.train.loop import make_train_step
    from repro_torch.train.optim import init_state
    cpu_params = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(seed))[0]
    out = {}
    for dev, c in ((DEVICE, cfg.scaled(remat=True)), ("cpu", cfg)):
        model = build_model(c, device=dev)
        params = _tree_to(cpu_params, torch.device(dev)) if dev != "cpu" \
            else cpu_params
        p0 = [t.detach().cpu().clone() for t in _leaves_of(params)]
        state = init_state(opt_cfg, params)
        step = make_train_step(
            model, opt_cfg, microbatches=microbatches,
            compression=ErrorFeedbackInt8() if compression else None)
        losses, gnorms = [], []
        with _tapped_grads() as grads:
            for b in batches:
                params, state, m = step(params, state,
                                        {k: v.to(dev) for k, v in b.items()})
                losses.append(float(m["loss"]))
                gnorms.append(float(m["grad_norm"]))
        out[dev] = {"losses": losses, "gnorms": gnorms, "grads": grads,
                    "p0": p0, "p1": [t.detach().cpu()
                                     for t in _leaves_of(params)]}
        del model, params, state
    torch.cuda.empty_cache()
    return out[DEVICE], out["cpu"]


def _update_gaps(card, cpu) -> list:
    """Per leaf ||Δp_card - Δp_cpu|| / ||Δp_cpu||, Δp = p1 - p0."""
    return [_rel(c1 - c0, u1 - u0) for c0, c1, u0, u1 in
            zip(card["p0"], card["p1"], cpu["p0"], cpu["p1"])]


def phase_train_held(seed: int) -> None:
    """Phase 13b: one train step of Qwen3-4B's width and vocabulary at 1
    layer in fp32 (B = 1, S = 256) on the card and on the CPU from the same
    parameters and batch: the loss, each gradient leaf and each leaf's
    update, each within its tolerance."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import synthetic_batch
    from repro_torch.train.loop import make_opt_config
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(TRAIN_ARCH).scaled(n_layers=1, dtype="float32")
    opt_cfg = dataclasses.replace(make_opt_config(cfg, total_steps=1),
                                  warmup=1)
    t0 = time.perf_counter()
    card, cpu = _train_both(cfg, opt_cfg, [synthetic_batch(
        cfg, 0, HELD_B, HELD_S, "cpu")], seed=seed)
    loss_gap = abs(card["losses"][0] - cpu["losses"][0])
    grad_gaps = [_rel(a, b) for a, b in zip(_leaves_of(card["grads"][0]),
                                            _leaves_of(cpu["grads"][0]))]
    upd_gaps = _update_gaps(card, cpu)
    say(f"phase 13b train held, {TRAIN_ARCH} width and vocab, 1 layer, fp32, "
        f"B={HELD_B} S={HELD_S}, card (remat) vs CPU, one step: loss "
        f"{card['losses'][0]:.6f} vs {cpu['losses'][0]:.6f}, |diff| "
        f"{loss_gap:.2e} (tol {HELD_LOSS_TOL}); gradient leaves "
        f"||g_card - g_cpu|| / ||g_cpu||: max {max(grad_gaps):.2e} over "
        f"{len(grad_gaps)} leaves (tol {HELD_GRAD_TOL}); updates p1 - p0: "
        f"max {max(upd_gaps):.2e} (tol {HELD_UPDATE_TOL}); "
        f"{time.perf_counter() - t0:.1f} s")
    check(loss_gap <= HELD_LOSS_TOL, f"13b loss gap {loss_gap}")
    check(max(grad_gaps) <= HELD_GRAD_TOL, f"13b gradient gaps {grad_gaps}")
    check(max(upd_gaps) <= HELD_UPDATE_TOL, f"13b update gaps {upd_gaps}")


def phase_train_families(seed: int) -> None:
    """Phase 13c: each of TRAIN_CASES at its smoke config, card (remat) vs
    CPU: the losses, the grad norms and every leaf's update."""
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.launch.train import synthetic_batch
    from repro_torch.train.loop import make_opt_config
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    rows = []
    for arch, edit, mb, comp, steps, opt_of, tol in TRAIN_CASES:
        cfg = smoke_config(arch).scaled(**edit)
        opt_cfg = make_opt_config(get_config(opt_of) if opt_of else cfg,
                                  total_steps=steps)
        opt_cfg = dataclasses.replace(opt_cfg, warmup=1)
        batches = [synthetic_batch(cfg, t, SMOKE_B, SMOKE_S, "cpu")
                   for t in range(steps)]
        card, cpu = _train_both(cfg, opt_cfg, batches, mb, comp, seed)
        loss_gap = max(abs(a - b) for a, b in zip(card["losses"],
                                                  cpu["losses"]))
        gnorm_gap = max(abs(a - b) / b for a, b in zip(card["gnorms"],
                                                        cpu["gnorms"]))
        upd = max(_update_gaps(card, cpu))
        name = arch + "".join(f" {k}={v}" for k, v in edit.items()) + \
            (f" mb={mb}" if mb > 1 else "") + (" int8-ef" if comp else "") + \
            (f" {opt_cfg.kind}/{opt_cfg.state_dtype}/accum "
             f"{opt_cfg.accum_dtype}" if opt_of else "")
        rows.append(f"{name}: loss {loss_gap:.1e}, gnorm {gnorm_gap:.1e}, "
                    f"update {upd:.1e}")
        check(_finite(card["losses"] + card["gnorms"]), f"13c {name}: "
              "non-finite")
        check(loss_gap <= SMOKE_LOSS_TOL and gnorm_gap <= SMOKE_GNORM_TOL
              and upd <= tol, f"13c {name}: loss gap {loss_gap}, grad norm "
              f"gap {gnorm_gap}, update gap {upd} (tol {tol})")
    say(f"phase 13c train every family at smoke width, B={SMOKE_B} "
        f"S={SMOKE_S}, card (remat) vs CPU, gaps (loss abs tol "
        f"{SMOKE_LOSS_TOL}, grad norm rel tol {SMOKE_GNORM_TOL}, update "
        f"per case): {'; '.join(rows)}; {time.perf_counter() - t0:.1f} s")


def _driver(args: list, timeout: int = 300):
    """``python -m repro_torch.launch.train`` on the card with ``args``."""
    import os
    env = dict(os.environ, PYTHONPATH=str(SRC))
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.train"]
                          + DRIVER_ARGS + args, env=env, cwd=SRC.parent,
                          capture_output=True, text=True, timeout=timeout)


def _last_loss(stdout: str) -> float:
    lines = [ln for ln in stdout.splitlines() if ln.startswith("step ")]
    check(bool(lines), "the driver printed no step line")
    return float(lines[-1].split()[3])


def _overwrite(store, n: int) -> list:
    cids = sorted(store.manifest()["chunks"])[5:5 + n]
    for cid in cids:
        with open(store._chunk_path(cid), "wb") as f:
            f.write(b"garbage")
    return cids


def phase_train_repair(seed: int, decode) -> dict:
    """Phase 13d: the driver on the card crashes after step 6 (exit 17,
    its step-5 store kept); a copy of that store is the healthy peer;
    TRAIN_CORRUPT chunks of the local store are overwritten and
    ``launch.train.recover`` repairs them in-process, fetching exactly
    those chunks through the three decode kernels, whose launches are
    counted (not traced: on the H100 a trace of its two waves came back
    once without a launch the counters saw); then the store is corrupted
    again and the driver, rerun with ``--peer-dir``, repairs, resumes
    from step 5 and finishes; its last loss beside a run that never
    crashed.  Returns the in-process repair's launches."""
    from repro_torch.checkpoint import CheckpointStore
    from repro_torch.configs import smoke_config
    from repro_torch.launch.train import recover
    from repro_torch.models import build_model
    from repro_torch.train.loop import init_train_state, make_opt_config
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        local, peer, whole = tmp / "local", tmp / "peer", tmp / "whole"
        r = _driver(["--ckpt-dir", str(local), "--fail-at", "6"])
        check(r.returncode == 17 and "[ckpt] step 5" in r.stdout,
              f"the crash run: exit {r.returncode}, {r.stdout[-400:]} "
              f"{r.stderr[-800:]}")
        shutil.copytree(local, peer)
        store, healthy = CheckpointStore(str(local)), CheckpointStore(str(peer))
        bad = _overwrite(store, TRAIN_CORRUPT)
        check(sorted(store.verify()) == bad, "verify() misses the overwrite")
        cfg = smoke_config("starcoder2-3b")
        model = build_model(cfg, device=DEVICE)
        params, opt_state, _ = init_train_state(
            model, make_opt_config(cfg, total_steps=10),
            torch.Generator(device=DEVICE).manual_seed(seed))
        struct = torch.utils._pytree.tree_map(
            lambda t: torch.empty_like(t, device="meta"),
            {"params": params, "opt": opt_state})
        reset_launches(decode)
        state, start, rep = recover(store, struct, healthy, DEVICE)
        launches = read_launches(decode)
        man, peer_man = store.manifest()["chunks"], \
            healthy.manifest()["chunks"]
        check(rep.chunks_fetched == TRAIN_CORRUPT and store.verify() == []
              and man == peer_man and start == 5, f"in-process repair: "
              f"fetched {rep.chunks_fetched}, verify {store.verify()}, "
              f"step {start}")
        check(all(launches[fn.__name__] >= 1 for fn in decode),
              f"a decode kernel did not launch in the repair: {launches}")
        restored = _leaves_of(state)
        check(all(t.device.type == torch.device(DEVICE).type
                  for t in restored),
              "restored off the card")
        del state, params, opt_state, model, restored
        again = _overwrite(store, TRAIN_CORRUPT)
        r2 = _driver(["--ckpt-dir", str(local), "--peer-dir", str(peer)])
        check(r2.returncode == 0 and f"[recover] {TRAIN_CORRUPT} corrupt "
              f"chunks" in r2.stdout and "resumed from step 5" in r2.stdout
              and f"[recover] fetched {TRAIN_CORRUPT} chunks" in r2.stdout
              and r2.stdout.rstrip().endswith("done"), f"the repaired run: "
              f"exit {r2.returncode}, {r2.stdout[-600:]} {r2.stderr[-800:]}")
        r3 = _driver(["--ckpt-dir", str(whole)])
        check(r3.returncode == 0, f"the uncrashed run: {r3.stderr[-800:]}")
        resumed, straight = _last_loss(r2.stdout), _last_loss(r3.stdout)
        check(_finite([resumed, straight]), "non-finite driver loss")
        recovered = [ln for ln in r2.stdout.splitlines()
                     if ln.startswith("[recover]")]
    say(f"phase 13d train crash and repair on the card, driver "
        f"{' '.join(DRIVER_ARGS)}: exit 17 after [ckpt] step 5; "
        f"{TRAIN_CORRUPT} chunks overwritten ({bad}), repaired in-process: "
        f"fetched {rep.chunks_fetched} chunks, {rep.symbols_used} symbols, "
        f"{rep.total_bytes:,} bytes against {rep.naive_bytes:,}, verify() "
        f"[], launches {launches}; overwritten again "
        f"({again}) and the driver rerun with --peer-dir: {recovered}, "
        f"done; last loss {resumed} resumed vs {straight} uncrashed "
        f"(|diff| {abs(resumed - straight):.2e}); "
        f"{time.perf_counter() - t0:.1f} s")
    return launches


# phase 14: the device mesh
def _mesh_batch(batch: dict, mesh) -> dict:
    from repro_torch.launch.mesh import distribute
    from repro_torch.models import batch_specs
    return distribute(batch, batch_specs(batch, mesh), mesh)


def _host_leaves(tree) -> list:
    """Each leaf's full tensor copied to the host, one leaf at a time (a
    collective for DTensors: every rank walks the same leaves)."""
    return [(t.full_tensor() if hasattr(t, "full_tensor") else t)
            .detach().to("cpu", copy=True) for t in _leaves_of(tree)]


def _train_steps(mesh, seed: int, cfg) -> dict:
    """13a's training of ``cfg`` (the same seed, batches and optimizer
    settings) for MESH_STEPS steps, on ``mesh`` (None: the plain path):
    step 2 timed by
    an event pair, step 3 under the profiler.  Returns the losses, the
    parameters before and after on the host, seconds a step, busy share,
    the largest kernels, peak bytes and the optimizer state's bytes a
    rank."""
    from repro_torch.launch.train import synthetic_batch
    from repro_torch.models import build_model
    from repro_torch.train.loop import init_train_state, make_train_step
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, mesh, DEVICE)
    opt_cfg = _train_opt(cfg)
    params, state, _ = init_train_state(
        model, opt_cfg, torch.Generator(device=DEVICE).manual_seed(seed))
    p0 = _host_leaves(params) if mesh is None else None
    step = make_train_step(model, opt_cfg)
    batches = [synthetic_batch(cfg, t, TRAIN_B, TRAIN_S, DEVICE)
               for t in range(MESH_STEPS)]
    if mesh is not None:
        batches = [_mesh_batch(b, mesh) for b in batches]
    losses = []

    def one(t):
        nonlocal params, state
        params, state, m = step(params, state, batches[t])
        losses.append(m["loss"])

    one(0)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with _dryrun_held():
        start.record()
        one(1)
        end.record()
        end.synchronize()
    busy_ms, wall_ms, top = step_busy(lambda: one(2), _dryrun_held)
    out = {"losses": [float(v) for v in losses], "p0": p0,
           "p3": _host_leaves(params),
           "step_s": start.elapsed_time(end) / 1e3, "busy": busy_ms / wall_ms,
           "top": top, "peak": torch.cuda.max_memory_allocated(),
           "state_bytes": sum((t.to_local() if hasattr(t, "to_local")
                               else t).numel() * t.element_size()
                              for t in _leaves_of(state))}
    del params, state, model, step, batches
    torch.cuda.empty_cache()
    return out


def _update_gap_list(plain: dict, meshed: dict) -> tuple[list, int]:
    """Per leaf ||Δp_mesh - Δp_plain|| / ||Δp_plain|| (Δp = p3 - p0),
    computed on the card a leaf at a time; and how many leaves are
    bit-equal."""
    gaps, equal = [], 0
    for a0, a3, m3 in zip(plain["p0"], plain["p3"], meshed["p3"]):
        a0, a3, m3 = (t.to(DEVICE) for t in (a0, a3, m3))
        want = a3.float() - a0.float()
        gap = torch.linalg.vector_norm(m3.float() - a0.float() - want,
                                       dtype=torch.float64)
        gaps.append(float(gap / torch.linalg.vector_norm(
            want, dtype=torch.float64).clamp(min=1e-30)))
        equal += bool(torch.equal(m3, a3))
    return gaps, equal


def _distribute_consuming(tree, specs, mesh):
    """:func:`repro_torch.launch.mesh.distribute`, each full leaf dropped
    from ``tree`` as soon as its block is placed (a 60 GB model on a card
    needs no second copy of itself)."""
    from repro_torch.launch.mesh import distribute_leaf, is_spec
    keys = range(len(tree)) if isinstance(tree, list) else list(tree)
    for k in keys:
        if is_spec(specs[k]):
            tree[k] = distribute_leaf(tree[k], specs[k], mesh)
        else:
            _distribute_consuming(tree[k], specs[k], mesh)
    return tree


def _serve_ep(mesh, seed: int, served: dict, cfg) -> dict:
    """Qwen3-30B-A3B (``cfg``, phase 12's seed) in its EP mode, on
    ``mesh`` (its all_to_all_singles on the model group) or plain
    (None): phase 12's prompts prefilled, then MESH_SERVE_STEPS
    decode steps fed phase 12's tokens at the decode context phase 12
    padded its caches to.  Returns the last prefill logits and the
    decode logits on the host, each EP call's dropped pairs, prefill
    seconds, ms a decode step and the peak."""
    from repro_torch.launch.mesh import distribute
    from repro_torch.models import build_model
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, mesh, DEVICE)
    params, specs = model.init(torch.Generator(device=DEVICE)
                               .manual_seed(seed))
    if mesh is not None:
        params = _distribute_consuming(params, specs, mesh)
    B, P = SERVE_B, SERVE_PROMPT
    ids = served["ids"].to(DEVICE)
    da = model.mesh_axes["data"] if B % model.mesh_axes["data_size"] == 0 \
        else None

    def placed(t, spec):
        return t if mesh is None else distribute(t, spec, mesh)

    def full(t):
        return (t if mesh is None else t.full_tensor()).to("cpu")

    drops = {"prefill": [], "decode": []}
    # DTensor's views do not run in inference mode
    with torch.no_grad(), _dryrun_held():
        model.moe_drops = drops["prefill"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        last, states = model.prefill(params, {"tokens": placed(
            served["prompts"].to(DEVICE), (da, None))})
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        caches = _pad_to_spec(states, model.cache_spec(B, P + SERVE_STEPS)[0])
        del states
        model.moe_drops = drops["decode"]
        logits = []
        t0 = time.perf_counter()
        for t in range(MESH_SERVE_STEPS):
            lg, caches = model.decode_step(
                params, placed(ids[:, t:t + 1], (da, None)), caches,
                placed(torch.full((B,), P + t, device=DEVICE), (da,)))
            logits.append(lg[:, 0])
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / MESH_SERVE_STEPS
        out = {"last": full(last), "decoded": torch.stack(
                   [full(lg) for lg in logits], dim=1),
               "drops": {k: [int(c) for c in v] for k, v in drops.items()},
               "prefill_s": prefill_s, "step_ms": step_ms,
               "peak": torch.cuda.max_memory_allocated()}
    model.moe_drops = None
    del params, caches, model, logits, last
    torch.cuda.empty_cache()
    return out


def _dryrun_start(out_dir: str) -> list:
    """14c's processes, started at once at the lowest CPU priority (they
    and the cells they start take the cores 14a and 14b leave idle):
    every pod cell (``--all``, DRYRUN_JOBS cells at a time) and the two
    multi-pod cells."""
    import os
    env = dict(os.environ, PYTHONPATH=str(SRC))
    base = [sys.executable, "-m", "repro_torch.launch.dryrun", "--out",
            out_dir]
    cmds = [base + ["--all", "--mesh", "pod", "--jobs", str(DRYRUN_JOBS)]]
    cmds += [base + ["--arch", a, "--shape", s, "--mesh", "multipod"]
             for a, s in MULTIPOD_CELLS]
    procs = []
    for c in cmds:
        procs.append(subprocess.Popen(c, env=env, cwd=SRC.parent, text=True,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE,
                                      start_new_session=True))
        os.setpriority(os.PRIO_PROCESS, procs[-1].pid, 19)
    DRYRUN["groups"] = [p.pid for p in procs]
    return procs


def _signal_groups(sig) -> None:
    import os
    for g in DRYRUN["groups"]:
        try:
            os.killpg(g, sig)
        except ProcessLookupError:    # the group has ended
            pass


@contextlib.contextmanager
def _dryrun_held():
    """14c's processes (each started in a process group of its own, with
    the cells it starts) stopped while the block runs and resumed after,
    so that 14a's and 14b's timed steps have the host's cores to
    themselves: the mesh path is host-bound on DTensor's dispatch."""
    import signal
    _signal_groups(signal.SIGSTOP)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if DRYRUN["groups"]:
            DRYRUN["held_s"] += time.perf_counter() - t0
        _signal_groups(signal.SIGCONT)


def _stop(procs: list) -> None:
    """Kill 14c's processes and the cells they started."""
    import signal
    _signal_groups(signal.SIGKILL)
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.wait()
    DRYRUN["groups"] = []


def _dryrun_finish(procs: list, out_dir: str, t0: float) -> None:
    """Wait for 14c's processes (killing them past DRYRUN_TIMEOUT seconds
    from ``t0``, the time they were held not counted) and print a line a
    cell."""
    from repro_torch.configs import cells
    try:
        for p in procs:
            out, err = p.communicate(timeout=max(1.0, DRYRUN_TIMEOUT + DRYRUN[
                "held_s"] - (time.perf_counter() - t0)))
            check(p.returncode == 0, f"the dry run {p.args[3:]} exited "
                  f"{p.returncode}: {out[-1500:]} {err[-1500:]}")
    finally:
        _stop(procs)
    smi = _smi()
    todo = [(a, s, "pod") for a, s, _ in cells()] + \
        [(a, s, "multipod") for a, s in MULTIPOD_CELLS]
    for a, s, m in todo:
        path = Path(out_dir) / f"{a}__{s}__{m}.json"
        check(path.exists(), f"the dry run wrote no {path.name}")
        cell = json.loads(path.read_text())
        mem, coll = cell["memory"], cell["collectives"]
        check(mem["argument_size_in_bytes"] > 0 and
              cell["flops_per_device"] > 0, f"dry run {path.name}: {cell}")
        kinds = ", ".join(f"{k} {v['bytes']:,} ({v['count']})"
                          for k, v in coll.items())
        say(f"phase 14c dry run {a} {s} {m} ({cell['devices']} ranks, "
            f"traced in {cell['trace_s']} s): argument bytes a rank "
            f"{mem['argument_size_in_bytes']:,}, output "
            f"{mem['output_size_in_bytes']:,}, FLOPs a rank "
            f"{cell['flops_per_device']:.4e}, collective operand bytes a "
            f"rank (count) {kinds}; {smi}")
    say(f"phase 14c dry run: {len(todo)} cells in "
        f"{time.perf_counter() - t0:.1f} s ({DRYRUN_JOBS} pod cells at a "
        f"time at nice 19, beside 14a and 14b; held stopped "
        f"{DRYRUN['held_s']:.1f} s of it, while their steps were timed)")


@contextlib.contextmanager
def _deterministic():
    """Deterministic algorithms on while the block runs.  Without them
    cuDNN attention's backward and the EP combine's ``index_add_`` reorder
    their atomic adds, and two runs of the plain training step differ
    from step 2 on (by 3e-4, then 4e-3 in the loss, on the H100).  cuBLAS
    asks for ``CUBLAS_WORKSPACE_CONFIG``; every GEMM here runs on one
    stream, where its result does not depend on the workspace."""
    import os
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def _mesh_configs(world: int) -> tuple:
    """14a's and 14b's configs: unchanged (bf16, full depth) on one card,
    where the mesh path runs the plain path's very ops; across cards,
    where the model ranks' partial sums round otherwise and bf16 routing
    and lr-3e-3 updates amplify that (phases 12 and 14a), the held
    checks' fp32 configs: 13b's 1 layer and phase 12's MOE_FP32_LAYERS,
    full width."""
    from repro_torch.configs import get_config
    train, serve = get_config(TRAIN_ARCH), get_config(MOE_ARCH)
    if world == 1:
        return train, serve
    return (train.scaled(n_layers=1, dtype="float32"),
            serve.scaled(n_layers=MOE_FP32_LAYERS, dtype="float32"))


def _paired_runs(mesh, seed: int, served: dict, world: int) -> dict:
    """14a and 14b on one rank: the plain path, then the mesh path, each
    once, deterministic (:func:`_deterministic`).  Each rank runs the
    plain paths on its own card."""
    train, serve = _mesh_configs(world)
    with _deterministic():
        return {"plain_train": _train_steps(None, seed, train),
                "mesh_train": _train_steps(mesh, seed, train),
                "plain_serve": _serve_ep(None, seed, served, serve),
                "mesh_serve": _serve_ep(mesh, seed, served, serve)}


def _mesh_worker(rank: int, world: int, seed: int, ref_dir: str,
                 groups: list) -> None:
    """14a and 14b on rank ``rank`` of ``world`` (one NCCL rank a card,
    the mesh (1, world)); phase 12's inputs come from ``ref_dir``, rank 0
    writes the results there.  Rank 0 holds 14c's process ``groups``
    stopped while it times (the ranks' steps run in step)."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_local_mesh
    dist.init_process_group("nccl", init_method=f"file://{ref_dir}/init",
                            rank=rank, world_size=world)
    if rank == 0:
        DRYRUN["groups"] = groups
    try:
        mesh = make_local_mesh(1, world, device=DEVICE)
        out = _paired_runs(mesh, seed, torch.load(f"{ref_dir}/served.pt"),
                           world)
        if rank == 0:
            torch.save(dict(out, held_s=DRYRUN["held_s"]),
                       f"{ref_dir}/out.pt")
    finally:
        dist.destroy_process_group()


def phase_mesh(seed: int, trained: dict, served: dict) -> None:
    """Phase 14: the mesh path, on a (1, N) mesh over every card the
    process sees, one NCCL rank a card (on one card, this process's own
    one-rank group, which ``make_local_mesh`` starts).  The plain path
    and the mesh path each run once with deterministic algorithms on,
    plain first, so the two can be bit-equal (:func:`_mesh_configs` says
    at which configs): (a) 13a's training for MESH_STEPS steps, each
    step's loss within HELD_LOSS_TOL and each leaf's update within
    HELD_UPDATE_TOL of the plain path's (13b's tolerances), seconds a
    step, busy share and peak beside the plain path's and 13a's; (b)
    Qwen3-30B-A3B served in EP with phase 12's prompts and fed tokens,
    the logits within MESH_SERVE_TOL (MOE_FP32_TOL in fp32) of the plain
    path's, the same greedy tokens and dropped pairs; (c) the dry run of
    every cell in subprocesses at the lowest CPU priority, started first
    and run beside (a) and (b), held stopped while their steps are timed
    (:func:`_dryrun_held`).  On one card it also prints how far the
    deterministic plain runs lie from 13a's and phase 12's own."""
    import torch.distributed as dist
    import torch.multiprocessing as mp
    from repro_torch.launch.mesh import make_local_mesh
    t_phase = time.perf_counter()
    world = torch.cuda.device_count()
    with tempfile.TemporaryDirectory() as tmp:
        t_dry = time.perf_counter()
        procs = _dryrun_start(tmp)
        try:
            if world == 1:
                mesh = make_local_mesh(device=DEVICE)
                try:
                    runs = _paired_runs(mesh, seed, served, world)
                finally:
                    dist.destroy_process_group()
            else:
                torch.save(served, f"{tmp}/served.pt")
                mp.spawn(_mesh_worker, args=(world, seed, tmp,
                                             DRYRUN["groups"]), nprocs=world)
                runs = torch.load(f"{tmp}/out.pt")
                DRYRUN["held_s"] += runs["held_s"]
        except BaseException:
            _stop(procs)
            raise
        _report_mesh(runs, trained, served, world)
        _dryrun_finish(procs, tmp, t_dry)
    say(f"phase 14 {time.perf_counter() - t_phase:.1f} s")


def _report_mesh(runs: dict, trained: dict, served: dict, world: int):
    """14a's and 14b's lines and checks."""
    train_cfg, serve_cfg = _mesh_configs(world)
    where = (f"the mesh (1, {world}) over (data, model), {world} NCCL "
             f"rank(s), deterministic algorithms on")
    smi = _smi()
    plain, meshed = runs["plain_train"], runs["mesh_train"]
    gaps, equal = _update_gap_list(plain, meshed)
    loss_gaps = [abs(a - b) for a, b in zip(meshed["losses"],
                                            plain["losses"])]
    own = ""
    if world == 1:
        rerun = [abs(a - b) for a, b in zip(plain["losses"],
                                            trained["losses"])]
        own = (f"; the plain losses against 13a's own (nondeterministic) "
               f"{[f'{v:.1e}' for v in rerun]}, 13a {trained['step_s']:.4f} "
               f"s a step, busy {trained['busy']:.3f}, peak "
               f"{trained['peak']:,}")
    say(f"phase 14a train {TRAIN_ARCH} ({train_cfg.n_layers} layers, "
        f"{train_cfg.dtype}) on {where}, {MESH_STEPS} steps as 13a: losses "
        f"{meshed['losses']}, plain {plain['losses']}, |diff| max "
        f"{max(loss_gaps):.2e} (tol {HELD_LOSS_TOL}); updates p3 - p0 max "
        f"gap {max(gaps):.2e} over {len(gaps)} leaves (tol "
        f"{HELD_UPDATE_TOL}); bit-equal: losses {max(loss_gaps) == 0}, "
        f"leaves {equal} of {len(gaps)}; step 2 mesh {meshed['step_s']:.4f} "
        f"s, plain {plain['step_s']:.4f} s; step 3 under the profiler busy "
        f"mesh {meshed['busy']:.3f}, plain {plain['busy']:.3f}, the mesh's "
        f"largest {meshed['top']}; optimizer state "
        f"{meshed['state_bytes']:,} bytes a rank; max_memory_allocated mesh "
        f"{meshed['peak']:,}, plain {plain['peak']:,}{own}; {smi}")
    check(max(loss_gaps) <= HELD_LOSS_TOL, f"14a loss gaps {loss_gaps}")
    check(max(gaps) <= HELD_UPDATE_TOL, f"14a update gaps {gaps}")
    ps, ms = runs["plain_serve"], runs["mesh_serve"]
    tol = MESH_SERVE_TOL if world == 1 else MOE_FP32_TOL
    gap = max(float((ms["last"] - ps["last"]).abs().max()),
              float((ms["decoded"] - ps["decoded"]).abs().max()))
    bit = bool(torch.equal(ms["last"], ps["last"]) and
               torch.equal(ms["decoded"], ps["decoded"]))
    tokens = ms["decoded"].argmax(-1)
    same = bool(torch.equal(tokens, ps["decoded"].argmax(-1)))
    own = ""
    if world == 1:
        p12 = max(float((ps["last"] - served["last"]).abs().max()),
                  float((ps["decoded"] - served["decoded"]).abs().max()))
        own = (f"; the plain run against phase 12's own (nondeterministic): "
               f"logits max |diff| {p12:.3e}, tokens the same "
               f"{bool(torch.equal(tokens, served['ids'][:, 1:]))}, dropped "
               f"pairs {sum(served['drops']['prefill']):,}")
    say(f"phase 14b serve {MOE_ARCH} ({serve_cfg.n_layers} layers, "
        f"{serve_cfg.dtype}) through EP on {where}: phase 12's {SERVE_B} "
        f"prompts of {SERVE_PROMPT} tokens, prefill mesh "
        f"{ms['prefill_s']:.3f} s, plain {ps['prefill_s']:.3f} s; "
        f"{MESH_SERVE_STEPS} decode steps fed phase 12's tokens, mesh "
        f"{ms['step_ms']:.2f}, plain {ps['step_ms']:.2f} ms a step; mesh vs "
        f"plain logits max |diff| {gap:.3e} (tol {tol}), bit-equal {bit}, "
        f"greedy tokens the same {same}; dropped pairs prefill mesh "
        f"{sum(ms['drops']['prefill']):,}, plain "
        f"{sum(ps['drops']['prefill']):,}, decode "
        f"{sum(ms['drops']['decode'])}; max_memory_allocated mesh "
        f"{ms['peak']:,}, plain {ps['peak']:,}{own}; {smi}")
    check(gap <= tol and same, "14b: the mesh's logits or tokens are not "
          "the plain path's")
    check(ms["drops"] == ps["drops"], f"14b dropped pairs {ms['drops']} "
          f"are not the plain path's {ps['drops']}")


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_to(v, device) for v in tree]
    return tree.to(device)


def _hash_ops(L: int) -> int:
    """32-bit integer operations of one SipHash-2-4 over L words."""
    siprounds = 2 * (L // 2) + 2 + 4
    return siprounds * 14 * 2 + 8      # 14 u64 ops a round, 2 int32 each


def _bound(nbytes: float, ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def wave_runs(wave: dict) -> dict:
    """B, A and C at a wave recorded by :func:`largest_wave` or made by
    :func:`first_wave`: U units, the chains at their shared mp, as
    ``WaveLoop._stage2`` launches them, over the wave's fixed slots with
    the live count read on the card.  Each value is (kernel, plain,
    (bound ms, bound by), shape, the kernel over every slot without the
    count or None); map_indices keeps the live rows only (the kernel
    leaves the others unwritten)."""
    from repro_torch.kernels.map_indices import map_indices
    from repro_torch.kernels.peel import iblt_apply, purity_scan
    from repro_torch.kernels.ref import (iblt_apply_ref, map_indices_ref,
                                         purity_ref)
    loop, state, w = wave["args"]
    mp, K, U, L = loop.mp, loop.K, loop.U, state.sums.shape[1]
    nbytes, key = loop.nbytes, loop.key
    n, slots = int(w.count), w.items.shape[0]
    m_kw = dict(K=K, m=mp, nbytes=nbytes, key=key)
    idx, _ = map_indices(w.items, count=w.count, **m_kw)
    live = idx[:n]
    limit = loop.m_units.long()[w.unit[:n].long()][:, None]
    valid = int(((live >= 0) & (live < limit) &
                 (w.sides[:n] != 0)[:, None]).sum())
    nonempty = int((state.counts != 0).sum())
    apply_args = (w.items, idx, w.chks, w.sides, w.unit, loop.m_units)
    return {
        "purity_scan": (
            lambda: purity_scan(*state[:3], key=key, nbytes=nbytes),
            lambda: purity_ref(*state[:3], key=key, nbytes=nbytes),
            _bound(U * mp * (L + 3) * 4 + U * mp * 4,
                   nonempty * (_hash_ops(L) + 4)),
            f"U={U} mp={mp} L={L} nonempty={nonempty}", None),
        "map_indices": (
            lambda: tuple(t[:n] for t in map_indices(w.items, count=w.count,
                                                     **m_kw)),
            lambda: tuple(t[:n] for t in map_indices_ref(
                w.items, count=w.count, **m_kw)),
            _bound(n * (L + K + 2) * 4,
                   n * 2 * _hash_ops(L) + int((live < mp).sum()) * 28),
            f"n={n} of {slots} slots, L={L} K={K} m={mp}",
            lambda: map_indices(w.items, **m_kw)),
        "iblt_apply": (
            lambda: iblt_apply(*apply_args, mp=mp, count=w.count),
            lambda: iblt_apply_ref(*apply_args, mp=mp, count=w.count),
            _bound(n * (L + K + 4) * 4 + U * mp * (L + 3) * 4,
                   valid * (L + 3)),
            f"U={U} n={n} of {slots} slots, L={L} K={K} mp={mp} "
            f"m_u={loop.m_units.tolist()} valid slots={valid}",
            lambda: iblt_apply(*apply_args, mp=mp)),
    }


def chunk_times(diff, reps: int = 5) -> None:
    """Where a wave's time goes, at the start of the phase-3 decode: the
    first wave enqueued op by op, and captured as a CUDA graph and
    replayed, as the wave loop runs it on the card (captured into the
    loops' shared memory pool).  Host ms: the enqueue
    (op by op), the capture and the replay, each while the card is parked
    in a spin; card ms: the wave run back to back (CUDA events).  Median
    of ``reps`` fresh loops."""
    from repro_torch.kernels._build import CountedGraph
    times = {k: [] for k in ("enqueue", "card", "capture", "replay",
                             "graph card")}

    def parked(enqueue, host: str, card: str) -> None:
        torch.cuda.synchronize()
        torch.cuda._sleep(int(2e8))          # ~0.1 s: the enqueue fits
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        enqueue()
        times[host].append((time.perf_counter() - t0) * 1e3)
        end.record()
        end.synchronize()
        times[card].append(start.elapsed_time(end))

    for _ in range(reps):
        parked(make_loop(diff)._wave, "enqueue", "card")
        loop = make_loop(diff)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        graph = (loop._programs.capture(loop._wave) if loop._programs
                 else CountedGraph(loop._wave, loop.state.sums.device))
        times["capture"].append((time.perf_counter() - t0) * 1e3)
        parked(graph.replay, "replay", "graph card")
        del graph, loop
    ms = {k: sorted(v)[reps // 2] for k, v in times.items()}
    say(f"phase 10 one wave at the phase-3 start: op by op "
        f"{ms['enqueue']:.3f} ms of host enqueue and {ms['card']:.3f} ms on "
        f"the card; as a CUDA graph captured in {ms['capture']:.3f} ms, "
        f"replayed in {ms['replay']:.3f} ms of host and "
        f"{ms['graph card']:.3f} ms on the card")


def phase_times(diff, enc_items, wave, ckpt_wave, paths: dict,
                path_ms: dict, errs: dict) -> list:
    """The kernels at main-path shapes.  ``paths`` maps each main path to
    its launch counts and ``path_ms`` to its kernels' summed device ms; a
    kernel's ``launches`` and ``path_ms`` are their sums.  The first wave
    of the phase-3 decode gives each decode kernel's main row; ``wave`` is
    phase 7's largest wave, at which map_indices and iblt_apply are timed
    a second time (``wave_*`` keys of their rows); map_indices is timed a
    third time at the phase-6 encode shape (``encode_*`` keys).
    ``ckpt_wave`` is phase 8's largest wave (16-byte records, L = 4), at
    which purity_scan, map_indices and iblt_apply are timed again
    (``ckpt_*`` keys).  At the first wave and phase 7's wave, A and C are
    also timed over every slot of the wave without the live count (the
    dropped slots at side 0): ``slots_ms`` and ``wave_slots_ms``."""
    from repro_torch.core.hashing import DEFAULT_KEY
    from repro_torch.core.mapping import kmax
    from repro_torch.kernels.map_indices import map_indices
    from repro_torch.kernels.iblt_encode import iblt_encode
    from repro_torch.kernels.ref import iblt_encode_ref, map_indices_ref
    key, L = DEFAULT_KEY, (NBYTES + 3) // 4
    launches = {name: sum(p.get(name, 0) for p in paths.values())
                for name in KERNELS}
    runs = wave_runs({"args": first_wave(diff)})
    chunk_times(diff)
    wave_at = {"wave": {k: v for k, v in wave_runs(wave).items()
                        if k != "purity_scan"},
               "ckpt": wave_runs(ckpt_wave)}
    # the encoder's accumulation at the phase-6 shapes: A's 10^6 records
    n_enc, m_enc, K_enc = enc_items.shape[0], M_ENCODE, kmax(M_ENCODE)
    e_kw = dict(K=K_enc, m=m_enc, nbytes=NBYTES, key=key)
    e_idx, e_chk = map_indices(enc_items, **e_kw)
    e_valid = int(((e_idx >= 0) & (e_idx < m_enc)).sum())
    encode_runs = {
        "map_indices": (
            lambda: map_indices(enc_items, **e_kw),
            lambda: map_indices_ref(enc_items, **e_kw),
            _bound(n_enc * (L + K_enc + 2) * 4,
                   n_enc * 2 * _hash_ops(L) + e_valid * 28),
            f"n={n_enc} L={L} K={K_enc} m={m_enc}", None),
    }
    runs["iblt_encode"] = (
        lambda: iblt_encode(enc_items, e_idx, e_chk, m=m_enc),
        lambda: iblt_encode_ref(enc_items, e_idx, e_chk, m=m_enc),
        _bound(n_enc * (L + K_enc + 2) * 4 + m_enc * (L + 3) * 4,
               e_valid * (L + 3)),
        f"n={n_enc} K={K_enc} m={m_enc} valid slots={e_valid}", None)
    out = []
    for name, (kern, plain, (bound_ms, bound_by), shape, slots) in \
            runs.items():
        for g, w in zip(outputs(kern()), outputs(plain())):
            errs[name] = max(errs[name], max_abs_err(g, w))
        check(errs[name] == 0, f"{name} disagrees at main-path shapes")
        (ms, call_ms), (plain_ms, _) = cuda_ms(kern), cuda_ms(plain, 3, 1)
        prof_ms = profiler_ms(name, kern)
        source, replaces = KERNELS[name]
        per_path = {p: c.get(name, 0) for p, c in paths.items()}
        per_path_ms = {p: c.get(name, 0.0) for p, c in path_ms.items()}
        out.append({"name": name, "route": "cuda", "source": source,
                    "replaces": replaces, "launches": launches[name],
                    "path_ms": sum(per_path_ms.values()),
                    "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "library_ms": None, "profiler_ms": prof_ms})
        extra = ""
        if slots is not None:
            out[-1]["slots_ms"] = cuda_ms(slots)[0]
            extra = (f"; over every slot without the count "
                     f"{out[-1]['slots_ms']:.4f} ms")
        say(f"phase 10 {name} [{shape}]: {ms:.4f} ms on the card "
            f"({call_ms:.4f} ms a call from Python; the profiler's kernel "
            f"time {prof_ms:.4f} ms, {bound_ms / prof_ms:.3f} of the bound), "
            f"plain {plain_ms:.3f} "
            f"ms, bound {bound_ms:.4f} ms ({bound_by}){extra}, "
            f"{launches[name]} launches on the main paths {per_path}, their "
            f"device ms {per_path_ms}")
        for tag, at, table in (
                ("wave", "phase 7's largest wave", wave_at["wave"]),
                ("encode", "the phase-6 encode shape", encode_runs),
                ("ckpt", "phase 8's largest wave", wave_at["ckpt"])):
            if name not in table:
                continue
            kern, plain, (bound_ms, bound_by), shape, slots = table[name]
            for g, w in zip(outputs(kern()), outputs(plain())):
                errs[name] = max(errs[name], max_abs_err(g, w))
            check(errs[name] == 0, f"{name} disagrees at {at}")
            (ms, call_ms), (plain_ms, _) = cuda_ms(kern), cuda_ms(plain, 3, 1)
            prof_ms = profiler_ms(name, kern)
            out[-1].update({"max_abs_err": errs[name], f"{tag}_ms": ms,
                            f"{tag}_profiler_ms": prof_ms,
                            f"{tag}_plain_ms": plain_ms,
                            f"{tag}_bound_ms": bound_ms,
                            f"{tag}_shape": shape})
            extra = ""
            if slots is not None and tag == "wave":
                out[-1]["wave_slots_ms"] = cuda_ms(slots)[0]
                extra = (f"; over every slot without the count "
                         f"{out[-1]['wave_slots_ms']:.4f} ms")
            say(f"phase 10 {name} at {at} [{shape}]: {ms:.4f} ms on the "
                f"card ({call_ms:.4f} ms a call from Python; the profiler's "
                f"kernel time {prof_ms:.4f} ms, {bound_ms / prof_ms:.3f} of "
                f"the bound), plain "
                f"{plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by})"
                f"{extra}")
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
    from repro_torch.kernels.iblt_encode import iblt_encode
    from repro_torch.kernels.map_indices import map_indices
    from repro_torch.kernels.peel import iblt_apply, purity_scan
    decode = (map_indices, purity_scan, iblt_apply)
    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    errs = dict.fromkeys(KERNELS, 0)

    phase_build()
    phase_kernels(rng, errs, np.random.default_rng([args.seed, 2]))
    diff = phase_one_shot(rng, decode)
    paths, path_ms = {}, {}
    paths["session"], path_ms["session"] = phase_session(rng, decode)
    phase_overflow(rng)
    paths["encode"], path_ms["encode"], enc_items = phase_encode(
        rng, decode + (iblt_encode,))
    paths["sharded"], path_ms["sharded"], wave = phase_sharded(rng, decode)
    paths["checkpoint"], path_ms["checkpoint"], ckpt_wave = phase_checkpoint(
        args.seed, decode + (iblt_encode,))
    phase_reconcile_sets(args.seed)
    rows = phase_times(diff, enc_items, wave, ckpt_wave, paths, path_ms, errs)
    del wave, ckpt_wave
    phase_serve(args.seed)
    served = phase_serve_moe(args.seed)
    for arch in FAMILIES:
        phase_serve_family(arch, args.seed)
    t13 = time.perf_counter()
    trained = phase_train(args.seed)
    phase_train_held(args.seed)
    phase_train_families(args.seed)
    paths["train_repair"] = phase_train_repair(args.seed, decode)
    for row in rows:
        row["launches"] += paths["train_repair"].get(row["name"], 0)
    say(f"phase 13 {time.perf_counter() - t13:.1f} s")
    phase_mesh(args.seed, trained, served)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    say(f"total {time.perf_counter() - t0:.1f} s")
    say(smi)
    say(json.dumps({"kernels": rows, "checkpoint": {
        "launches": paths["checkpoint"], "path_ms": path_ms["checkpoint"]},
        "train_repair": {"launches": paths["train_repair"]}}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
