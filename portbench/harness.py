"""One run of one cell: set-up, the measured window, the check, the line.

Everything cell-specific is found by name: the cell's entry in
``BENCHMARK.json`` names its configuration (``portbench/configs/``) and
its traffic file (``portbench/workloads/<cell>.json``); the traffic file
names its driver (``portbench/drivers/``); each metric the cell reports
is read by ``portbench/metrics/<metric>.py``.  So a later cell, traffic
mix or metric is a new file, and no file here changes.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import resource
import subprocess
import time
from pathlib import Path

import numpy as np

from portbench import generator, imports, reference, trace

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
# each number compared, with its limit: every comparison is exact
LIMITS = {"wrong_records": 0, "wrong_symbols_used": 0, "failed_sessions": 0}


@dataclasses.dataclass
class Run:
    """What a metric reader reads."""
    L: int                           # 32-bit words a record
    setup_s: float
    window_s: float
    rounds: list                     # drivers' Round records
    device: dict | None = None       # traced run: busy_s, window_s, ...
    spans: trace.Spans | None = None

    @property
    def reports(self):
        return [rep for r in self.rounds for rep in r.reports]


def load_cell(name: str, root: Path = ROOT) -> tuple[dict, dict, dict, dict]:
    """(benchmark, cell entry, configuration, traffic) of cell ``name``."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise SystemExit(f"no cell {name!r} in BENCHMARK.json")
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = json.loads((root / entry["file"]).read_text())
    traffic = json.loads((HERE / "workloads" / f"{name}.json").read_text())
    return bench, cell, config, traffic


def metrics_of(bench: dict, cell: str, traced: bool) -> list[dict]:
    """The cell's end-to-end metrics (untraced) or per-layer ones."""
    kind = "per_layer" if traced else "end_to_end"
    return [m for m in bench[kind] if cell in m.get("workloads", [cell])]


def read_metric(name: str, run: Run):
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(run)


def check(run: Run, data: generator.CellData, config: dict,
          max_m: int) -> dict:
    """Every report of the window against the plain reference."""
    key = tuple(int(k, 16) for k in config["session_key"])
    nbytes = int(config["record_bytes"])
    ends = reference.window_ends(config["pacing"]["block"],
                                 config["pacing"]["growth"], max_m)
    want = {}
    gaps = dict.fromkeys(LIMITS, 0)
    failed = 0
    for rnd in run.rounds:
        if rnd.error is not None:
            gaps["failed_sessions"] += len(rnd.replicas)
            failed += len(rnd.replicas)
            continue
        for rep in rnd.reports:
            if rep.replica not in want:
                remote, local = generator.difference(
                    data, data.replicas[rep.replica])
                want[rep.replica] = reference.Expected(remote, local, key,
                                                       ends)
            gap = reference.judge(as_records(rep.only_remote, nbytes),
                                  as_records(rep.only_local, nbytes),
                                  rep.symbols_used, want[rep.replica])
            gaps["wrong_records"] += gap["records"]
            gaps["wrong_symbols_used"] += gap["symbols"]
            failed += bool(gap["records"] or gap["symbols"])
    return {"gaps": gaps, "failed": failed,
            "attempted": sum(len(r.replicas) for r in run.rounds)}


def as_records(words: np.ndarray, nbytes: int) -> np.ndarray:
    """A report's (r, L) uint32 little-endian words as (r, nbytes) bytes."""
    words = np.ascontiguousarray(words, dtype="<u4")
    return words.view(np.uint8).reshape(words.shape[0],
                                        4 * words.shape[1])[:, :nbytes]


def device_info(device: str) -> dict:
    import torch
    if device == "cpu":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}


def power_limit() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi unavailable ({exc})"


def run(cell: str, seed: int, seconds: float, traced: bool, *,
        t_start: float, device: str = "cuda", log=print) -> dict:
    """One run; returns the result line's object (without printing it)."""
    bench, _, config, traffic = load_cell(cell)
    return measure(bench, cell, config, traffic, seed, seconds, traced,
                   t_start=t_start, device=device, log=log)


def measure(bench: dict, cell: str, config: dict, traffic: dict, seed: int,
            seconds: float, traced: bool, *, t_start: float,
            device: str = "cuda", log=print) -> dict:
    """:func:`run` on a given configuration and traffic (the tests give
    small ones and ``device="cpu"``, the kernels' plain versions)."""
    data = generator.make_cell(config, traffic, seed)
    driver = importlib.import_module(
        f"portbench.drivers.{traffic['driver']}").Driver(
        config, traffic, data, seed, device)
    driver.warm()
    setup_s = time.perf_counter() - t_start
    spans = dev = None
    cpu0 = resource.getrusage(resource.RUSAGE_SELF)
    if traced:
        spans = trace.Spans()
        with spans.wrapped(driver.span_targets()), \
                trace.DeviceTrace() as prof:
            t0 = time.perf_counter_ns()
            rounds = driver.window(seconds)
            t1 = time.perf_counter_ns()
        dev = traced_device(prof, spans, rounds, t0, t1)
    else:
        t0 = time.perf_counter_ns()
        rounds = driver.window(seconds)
        t1 = time.perf_counter_ns()
    cpu1 = resource.getrusage(resource.RUSAGE_SELF)
    info = device_info(device)
    max_m = driver.max_m
    driver.close()
    found = imports.forbidden()
    if found:
        raise SystemExit("loaded in the measuring process: " +
                         ", ".join(found))
    L = (int(config["record_bytes"]) + 3) // 4
    record = Run(L, setup_s, (t1 - t0) * 1e-9, rounds, dev, spans)
    judged = check(record, data, config, max_m)
    metrics = {}
    for m in metrics_of(bench, cell, traced):
        value = read_metric(m["name"], record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    if traced:
        info.update(busy_s=dev["busy_s"], window_s=dev["window_s"])
    out = {"correct": all(judged["gaps"][k] <= v for k, v in LIMITS.items()),
           "attempted": judged["attempted"], "failed": judged["failed"],
           "metrics": metrics, "device": info}
    if traced:
        out["breakdown"] = {"device_ops": dev["device_ops"],
                            "idle_gaps": dev["idle_gaps"]}
    log(f"{cell} seed {seed}: {len(rounds)} rounds in {record.window_s:.3f} "
        f"s, set-up {setup_s:.3f} s; ticks "
        f"{sum(r.ticks for r in rounds)}, dispatches "
        f"{sum(r.dispatches for r in rounds)}, host fallbacks "
        f"{sum(p.host_fallbacks for p in record.reports)}; host cpu over "
        f"the window: user {cpu1.ru_utime - cpu0.ru_utime:.3f} s, system "
        f"{cpu1.ru_stime - cpu0.ru_stime:.3f} s; card {power_limit()}")
    errors = sorted({r.error for r in rounds if r.error})
    for err in errors[:5]:
        log(f"a round raised: {err}")
    for name, limit in LIMITS.items():
        log(f"compared {name} {judged['gaps'][name]} limit {limit}")
    out["compared"] = {k: {"value": judged["gaps"][k], "limit": v}
                       for k, v in LIMITS.items()}
    return out


def traced_device(prof, spans: trace.Spans, rounds: list, t0: int,
                  t1: int) -> dict:
    """Busy and idle time of the card over the traced window, its top
    operations, and its idle time by what the host was doing."""
    names, start, end = prof.events
    off = prof.offset_ns
    lo, hi = t0 + off, t1 + off
    host = {label: [(a + off, b + off) for a, b in ivs]
            for label, ivs in spans.intervals.items()}
    rnds = [(r.start_ns + off, r.end_ns + off) for r in rounds]
    return {"busy_s": trace.busy_ns(start, end, lo, hi) * 1e-9,
            "window_s": (hi - lo) * 1e-9,
            "device_ops": trace.top_ops(names, start, end, lo, hi),
            "idle_gaps": trace.idle_by_host(start, end, lo, hi, host, rnds)}
