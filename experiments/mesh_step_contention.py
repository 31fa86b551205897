#!/usr/bin/env python3
"""Time the port's mesh train step with and without the dry run beside
it, on one GPU.

    python3 experiments/mesh_step_contention.py [--seed N]

The step is ``chip_smoke.py`` 14a's: Qwen3-4B at full width, bf16, B = 2
of S = 4,096, on a (1, 1) mesh over one NCCL rank, deterministic
algorithms on (``chip_smoke._train_steps``).  The dry run is 14c's: every
pod cell and the two multi-pod cells in subprocesses at nice 19
(``chip_smoke._dryrun_start``).  Four runs, one line each with step 2's
seconds (an event pair) and step 3's busy share (the profiler):

A. alone;
B. beside the dry run, its processes held stopped while the steps are
   timed, as phase 14 runs (``chip_smoke._dryrun_held``);
C. beside the dry run, its processes running;
D. alone again, after they are killed.

Then the card's name and power limit.  Exits nonzero without CUDA.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("mesh_step_contention: CUDA is not available", file=sys.stderr)
        return 1
    import torch.distributed as dist
    import chip_smoke as c
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_local_mesh

    cfg = get_config(c.TRAIN_ARCH)
    mesh = make_local_mesh(device=c.DEVICE)

    def run(label):
        with c._deterministic():
            r = c._train_steps(mesh, args.seed, cfg)
        print(f"{label}: step 2 {r['step_s']:.4f} s, step 3 busy "
              f"{r['busy']:.3f}", flush=True)

    try:
        run("A alone")
        with tempfile.TemporaryDirectory() as tmp:
            procs = c._dryrun_start(tmp)
            try:
                time.sleep(20)     # the cells past their imports
                run("B beside the dry run, held")
                groups = c.DRYRUN["groups"]
                try:
                    c.DRYRUN["groups"] = []         # nothing to hold
                    run("C beside the dry run, running")
                finally:
                    c.DRYRUN["groups"] = groups
            finally:
                c._stop(procs)
        run("D alone again")
    finally:
        dist.destroy_process_group()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
