"""The check's control: answers that break a guarantee must fail it.

The configurations state no precision; they state guarantees (exact
recovery, the session ending at the first window end at which the
difference decodes).  The control puts the plain reference in the
program's place with the first of them broken the way a faster path
would be tempted to: each replica answers with what it holds one pacing
window before its difference decodes, a stale partial difference.  Its
reports go through the same comparison as a run's, and its readings must
exceed the limits (which are 0: every comparison is exact).

    python3 portbench/control.py --workload eth-state.catchup \
        --seeds 11 12 13

prints one JSON line of readings a seed (the numbers compared, over every
replica of the cell's pool).  It needs no card.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path


def readings(config: dict, traffic: dict, seed: int) -> dict:
    """The control's readings over the pool of one cell under ``seed``."""
    from portbench import generator, reference
    data = generator.make_cell(config, traffic, seed)
    key = tuple(int(k, 16) for k in config["session_key"])
    ends = reference.window_ends(config["pacing"]["block"],
                                 config["pacing"]["growth"],
                                 generator.stream_length(config, traffic))
    out = dict.fromkeys(("wrong_records", "wrong_symbols_used"), 0)
    for rep in data.replicas:
        want = reference.Expected(*generator.difference(data, rep), key, ends)
        remote, local, symbols = want.control()
        gap = reference.judge(remote, local, symbols, want)
        out["wrong_records"] += gap["records"]
        out["wrong_symbols_used"] += gap["symbols"]
    return out | {"replicas": len(data.replicas)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    root = Path(__file__).resolve().parent.parent
    sys.path[:0] = [str(root)]
    from portbench import harness
    _, _, config, traffic = harness.load_cell(args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        r = readings(config, traffic, seed)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "seconds": time.perf_counter() - t0, **r}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
