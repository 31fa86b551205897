"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload eth-state.catchup --seed 7 \
        --seconds 30 --trace 0

From the root of a checkout, on a machine with an NVIDIA card.  The
kernels build into ``build/repro_torch/`` at the first run and load from
there after; every other cache goes under ``build/portbench/``.  The last
line of standard output is the result as one JSON object; the last lines
of standard error are the numbers the check compared, each beside its
limit.  Without a card, or with fewer cards than the cell asks for, it
exits with 2 and prints no result.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache = ROOT / "build" / "portbench"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(cache / sub)
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("the program (src/repro_torch) is not in this checkout",
              file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from portbench import harness
    _, cell, _, _ = harness.load_cell(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    _build.build()
    out = harness.run(args.workload, args.seed, args.seconds,
                      bool(args.trace), t_start=T_START,
                      log=lambda line: print(line, file=sys.stderr,
                                             flush=True))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
