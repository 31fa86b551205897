#!/usr/bin/env python3
"""Time the designs tried for the iblt_apply / iblt_encode scatter on one GPU.

    python3 experiments/scatter_variants.py [--seed N]

Builds ``experiments/scatter_variants.cu`` with the package's nvcc flags
into ``build/experiments/`` and times, with CUDA events as
``chip_smoke.cuda_ms`` does:

1. the forms the two kernels had before ``csrc/scatter.cuh``, on the real
   inputs and with slots padded away, to isolate what held them back:
   ``iblt_apply`` without row 0, without rows < 472 and without rows
   >= 472; ``iblt_encode`` without the slots at or past its 472 shared
   rows, and without those before them;
2. the variants that ``scatter_variants.cu`` lists and the shipped kernels
   (through the package's wrappers, which size H themselves) at three
   shapes: the first wave of ``chip_smoke.py``'s one-shot decode (phase 3),
   a sharded-serving wave (32 units of 2,048 rows, 24 live, 6,948 items in
   sorted units: the shape of phase 7's largest wave, drawn at random
   here), and one encode of phase 6 (10^6 records at m = 20,480).

Each variant's output must equal the shipped kernel's bit for bit, and the
shipped kernel's its plain twin's.  Prints one line a timing and the card's
name and power limit, and writes ``build/experiments/scatter_variants.json``.
Exits nonzero without CUDA.
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
PRIOR_HOT = 472        # the shared rows of the prior encoder at L = 23


def build_library():
    from repro_torch.kernels import _build
    BUILD.mkdir(parents=True, exist_ok=True)
    so = BUILD / "scatter_variants.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
           str(Path(__file__).with_suffix(".cu"))]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}\n{proc.stderr}")
    lib = ctypes.CDLL(str(so))
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.sv_info.argtypes = [I, LL, ctypes.POINTER(ctypes.c_int)]
    lib.sv_prior_apply.argtypes = [P, P, P, P, LL, I, I, P, P, LL, P, P, P,
                                   P]
    lib.sv_prior_encode.argtypes = [P, P, P, LL, I, I, LL, P, P, P, P]
    lib.sv_variant.argtypes = [I, P, P, P, P, P, P, LL, LL, I, I, LL, I, I,
                               I, I, P, P, P, P]
    for fn in (lib.sv_info, lib.sv_prior_apply, lib.sv_prior_encode,
               lib.sv_variant):
        fn.restype = I
    return lib


def zeros(rows: int):
    return tuple(torch.zeros((rows, w), dtype=torch.int32, device="cuda")
                 for w in (L, 2, 1))


def ptr(t):
    return None if t is None else t.data_ptr()


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def checked(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: launch failed, cudaError {rc}")


class Case:
    """One scatter input: items, chains, weights, units, limits."""

    def __init__(self, items, idx, chk, weights, unit, limits, *, m, rows,
                 stride):
        self.items, self.idx, self.chk = items, idx, chk
        self.weights, self.unit, self.limits = weights, unit, limits
        self.m, self.rows, self.stride = m, rows, stride

    def padded(self, keep) -> "Case":
        """The same case with every slot outside ``keep(idx)`` padded."""
        pad = self.m if self.limits is None else self.stride
        idx = torch.where(keep(self.idx), self.idx, pad).to(torch.int32)
        return Case(self.items, idx, self.chk, self.weights, self.unit,
                    self.limits, m=self.m, rows=self.rows, stride=self.stride)

    def variant(self, lib, variant, H1, H2=0, grid=132, C=1):
        n, K = self.idx.shape

        def run():
            out = zeros(self.rows)
            checked(lib.sv_variant(
                variant, ptr(self.items), ptr(self.idx), ptr(self.chk),
                ptr(self.weights), ptr(self.unit), ptr(self.limits), self.m,
                n, K, L, self.stride, H1, H2, grid, C,
                *(t.data_ptr() for t in out), stream()),
                f"variant {variant}")
            return out
        return run


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("scatter_variants: CUDA is not available", file=sys.stderr)
        return 1
    from repro_torch.core import encode
    from repro_torch.core.hashing import DEFAULT_KEY
    from repro_torch.core.mapping import kmax
    from repro_torch.kernels.iblt_encode import iblt_encode
    from repro_torch.kernels.map_indices import map_indices
    from repro_torch.kernels.peel import iblt_apply
    from repro_torch.kernels.ref import iblt_apply_ref, iblt_encode_ref
    lib = build_library()
    info = (ctypes.c_int * 3)()
    clusters = {}
    for C in (8, 16):
        checked(lib.sv_info(C, 2235 * (L + 3) * 4, info), "sv_info")
        clusters[C] = info[2]
    sms, optin = info[0], info[1]
    fit = optin // (4 * (L + 3))
    rng = np.random.default_rng(args.seed)
    results = {"sms": sms, "smem_optin": optin, "clusters_at_227KB": clusters}

    def time_it(tag: str, fn, want=None) -> None:
        got = fn()
        torch.cuda.synchronize()
        equal = None if want is None else all(
            torch.equal(g, w) for g, w in zip(got, want))
        if want is not None and not equal:
            raise AssertionError(f"{tag}: differs from the shipped kernel")
        ms, call_ms = cs.cuda_ms(fn)
        results[tag] = {"ms": ms, "call_ms": call_ms, "equal": equal}
        print(f"{tag:64s} {ms:9.4f} ms  (call {call_ms:8.4f})", flush=True)

    # -- the first wave of the phase-3 one-shot decode -----------------------
    d, m = cs.D_ONE_SHOT, cs.M_ONE_SHOT
    recs = cs.random_records(rng, d)
    diff = encode(recs[: d // 2], cs.NBYTES, m).subtract(
        encode(recs[d // 2:], cs.NBYTES, m))
    loop, state, wave = cs.first_wave(diff)
    mp, n_new = loop.mp, int(wave.count)
    rows, side = wave.rows[:n_new], wave.sides[:n_new]
    items, chks = state.sums[rows], state.checks[rows]
    idx, _ = map_indices(items, K=kmax(mp), m=mp, nbytes=cs.NBYTES,
                         key=DEFAULT_KEY)
    n = items.shape[0]
    unit = torch.zeros(n, dtype=torch.int32, device="cuda")
    m_units = torch.tensor([m], dtype=torch.int32, device="cuda")
    first = Case(items, idx, chks, side, unit, m_units, m=m, rows=mp,
                 stride=mp)
    print(f"first wave: n={n} K={idx.shape[1]} m={m} valid slots="
          f"{int(((idx >= 0) & (idx < m)).sum())}", flush=True)

    def prior_apply(case):
        def run():
            out = zeros(case.rows)
            checked(lib.sv_prior_apply(
                ptr(case.items), ptr(case.idx), ptr(case.chk),
                ptr(case.weights), case.idx.shape[0], case.idx.shape[1], L,
                ptr(case.unit), ptr(case.limits), case.stride,
                *(t.data_ptr() for t in out), stream()), "prior apply")
            return out
        return run

    def shipped_apply(case):
        return lambda: iblt_apply(case.items, case.idx, case.chk,
                                  case.weights, case.unit, case.limits,
                                  mp=case.stride)
    want = shipped_apply(first)()
    plain = iblt_apply_ref(items, idx, chks, side, unit, m_units, mp=mp)
    if not all(torch.equal(g, w) for g, w in zip(want, plain)):
        raise AssertionError("shipped iblt_apply differs from its plain twin")
    time_it("apply/prior as is", prior_apply(first), want)
    time_it("apply/prior, row 0 padded",
            prior_apply(first.padded(lambda j: j != 0)))
    time_it(f"apply/prior, rows < {PRIOR_HOT} padded",
            prior_apply(first.padded(lambda j: j >= PRIOR_HOT)))
    time_it(f"apply/prior, rows >= {PRIOR_HOT} padded",
            prior_apply(first.padded(lambda j: j < PRIOR_HOT)))
    time_it("apply/shipped (wrapper)", shipped_apply(first), want)
    for H in (0, 256, 512, 1024, fit):
        time_it(f"apply/shipped body H={H}", first.variant(lib, 3, H), want)
    time_it("apply/three atomics a slot H=512", first.variant(lib, 0, 512),
            want)
    time_it("apply/three atomics a slot H=2232",
            first.variant(lib, 0, 2232), want)
    time_it("apply/three atomics, bulk flush H=2232",
            first.variant(lib, 1, 2232), want)
    time_it("apply/lanes on slots H=2232", first.variant(lib, 2, 2232), want)
    for H1, H2, C in ((1116, 1116, 8), (0, fit, 8)):
        if clusters[C] > 0:
            time_it(f"apply/cluster H1={H1} H2={H2} C={C}",
                    first.variant(lib, 4, H1, H2, C=C), want)

    # -- a sharded-serving wave ----------------------------------------------
    U, live, wn, wmp = 32, 24, 6_948, 2_048
    w_items = cs.rand_i32(rng, (wn, L))
    w_idx, w_chk = map_indices(w_items, K=kmax(wmp), m=wmp, nbytes=cs.NBYTES,
                               key=DEFAULT_KEY)
    w_unit = torch.from_numpy(np.sort(rng.integers(0, live, size=wn)).astype(
        np.int32)).to("cuda")
    w_mu = torch.zeros(U, dtype=torch.int32, device="cuda")
    w_mu[:live] = wmp
    w_side = torch.from_numpy(rng.choice([-1, 1], size=wn).astype(
        np.int32)).to("cuda")
    wave = Case(w_items, w_idx, w_chk, w_side, w_unit, w_mu, m=wmp,
                rows=U * wmp, stride=wmp)
    want = shipped_apply(wave)()
    plain = iblt_apply_ref(w_items, w_idx, w_chk, w_side, w_unit, w_mu,
                           mp=wmp)
    if not all(torch.equal(g, w) for g, w in zip(want, plain)):
        raise AssertionError("shipped iblt_apply differs at the wave")
    time_it("wave/prior as is", prior_apply(wave), want)
    time_it("wave/shipped (wrapper)", shipped_apply(wave), want)
    for H in (0, 512, wmp):
        time_it(f"wave/shipped body H={H}", wave.variant(lib, 3, H), want)
    time_it(f"wave/shipped body H={wmp} on {live} blocks (~one a unit)",
            wave.variant(lib, 3, wmp, grid=live), want)
    time_it(f"wave/three atomics a slot H={wmp}", wave.variant(lib, 0, wmp),
            want)
    time_it(f"wave/three atomics, bulk flush H={wmp}",
            wave.variant(lib, 1, wmp), want)
    time_it(f"wave/lanes on slots H={wmp}", wave.variant(lib, 2, wmp), want)

    # -- one encode of phase 6 ------------------------------------------------
    ne, me = cs.N_ENCODE, cs.M_ENCODE
    e_items = cs.words_on_card(cs.random_records(rng, ne))
    e_idx, e_chk = map_indices(e_items, K=kmax(me), m=me, nbytes=cs.NBYTES,
                               key=DEFAULT_KEY)
    enc = Case(e_items, e_idx, e_chk, None, None, None, m=me, rows=me,
               stride=0)

    def prior_encode(case):
        def run():
            out = zeros(case.rows)
            checked(lib.sv_prior_encode(
                ptr(case.items), ptr(case.idx), ptr(case.chk),
                case.idx.shape[0], case.idx.shape[1], L, case.m,
                *(t.data_ptr() for t in out), stream()), "prior encode")
            return out
        return run

    def shipped_encode(case):
        return lambda: iblt_encode(case.items, case.idx, case.chk, m=case.m)
    want = shipped_encode(enc)()
    plain = iblt_encode_ref(e_items, e_idx, e_chk, m=me)
    if not all(torch.equal(g, w) for g, w in zip(want, plain)):
        raise AssertionError("shipped iblt_encode differs from its twin")
    time_it("encode/prior as is", prior_encode(enc), want)
    time_it(f"encode/prior, slots >= {PRIOR_HOT} padded",
            prior_encode(enc.padded(lambda j: j < PRIOR_HOT)))
    time_it(f"encode/prior, slots < {PRIOR_HOT} padded",
            prior_encode(enc.padded(lambda j: j >= PRIOR_HOT)))
    time_it("encode/shipped (wrapper)", shipped_encode(enc), want)
    time_it(f"encode/shipped body H={fit}, slots >= {fit} padded",
            enc.padded(lambda j: j < fit).variant(lib, 3, fit))
    time_it(f"encode/shipped body H={fit}, slots < {fit} padded",
            enc.padded(lambda j: j >= fit).variant(lib, 3, fit))
    for variant, what in ((5, "prefetch 1 ahead"), (6, "prefetch 2 ahead"),
                          (7, "row 0 in registers"),
                          (8, "prefetch 2 ahead, row 0 in registers")):
        time_it(f"encode/shipped body H={fit}, {what}",
                enc.variant(lib, variant, fit), want)
        time_it(f"apply/shipped body H=512, {what}",
                first.variant(lib, variant, 512), None)
    time_it("encode/three atomics a slot H=0", enc.variant(lib, 0, 0), want)
    time_it("encode/three atomics a slot H=2232", enc.variant(lib, 0, 2232),
            want)
    time_it("encode/three atomics, bulk flush H=2232",
            enc.variant(lib, 1, 2232), want)
    time_it("encode/lanes on slots H=2232", enc.variant(lib, 2, 2232), want)
    for H1, H2, C in ((1116, 1116, 8), (0, fit, 8), (1676, 558, 8),
                      (1116, 1116, 16), (1676, 558, 16)):
        if clusters[C] > 0:
            time_it(f"encode/cluster H1={H1} H2={H2} C={C}",
                    enc.variant(lib, 4, H1, H2, C=C), want)

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    results["card"] = card
    print(f"SMs {sms}, opt-in shared memory {optin} B, clusters resident at "
          f"227 KB a block {clusters}")
    print(card)
    (BUILD / "scatter_variants.json").write_text(json.dumps(results,
                                                          indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
