"""A run whose timed path is broken underneath reads ``correct: false``.

Each test drives the rest of a run (set-up, the window, the check) on the
CPU, through the kernels' plain versions, at a size a test run holds,
and breaks the program where a fault of that kind would sit.  One chip,
so no exchange between chips can be left out.
"""
import json
import time
from pathlib import Path

import numpy as np
import pytest

from portbench import harness

HERE = Path(__file__).resolve().parent
BENCH = json.loads((HERE.parent / "BENCHMARK.json").read_text())


def tiny_run(seed: int = 21, cell: str = "eth-state.catchup") -> dict:
    config_name = cell.split(".")[0]
    cfg = json.loads((HERE / "configs" / f"{config_name}.json").read_text())
    cfg["records"] = 1500
    tr = json.loads((HERE / "workloads" / f"{cell}.json").read_text())
    if cell == "eth-state.catchup":
        tr["stale_per_replica"] = {"values": [3, 10, 30, 60]}
    return harness.measure(BENCH, cell, cfg, tr, seed, 0.3, False,
                           t_start=time.perf_counter(), device="cpu",
                           log=lambda line: None)


@pytest.mark.parametrize("cell", ["eth-state.catchup",
                                  "ckpt-qwen3-30b-a3b.audit"])
def test_sound_run_is_correct(cell):
    out = tiny_run(cell=cell)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0
    # the window ends at the end of a cycle through the whole pool
    pool = json.loads((HERE / "workloads" / f"{cell}.json").read_text())
    assert out["attempted"] % pool["replicas"] == 0
    assert list(out)[-1] == "compared"
    assert set(out["metrics"]) == {
        m["name"] for m in harness.metrics_of(BENCH, cell, traced=False)}


def test_answer_altered_where_produced(monkeypatch):
    from repro_torch.core.stream import StreamDecoder
    merge = StreamDecoder.merge_device_result

    def altered(self, res):
        if res.items.shape[0]:
            items = res.items.copy()
            items[0, 0] ^= np.uint32(1)
            res = res._replace(items=items)
        return merge(self, res)
    monkeypatch.setattr(StreamDecoder, "merge_device_result", altered)
    out = tiny_run()
    assert not out["correct"] and out["failed"] > 0


def test_state_left_unchanged(monkeypatch):
    from repro_torch.core.stream import StreamDecoder
    monkeypatch.setattr(StreamDecoder, "merge_device_result",
                        lambda self, res: None)
    out = tiny_run()
    assert not out["correct"]
    assert out["compared"]["failed_sessions"]["value"] > 0


def test_half_the_batch_left_out(monkeypatch):
    from repro_torch.protocol import engine
    execute = engine.execute_round

    def half(units, *args, **kwargs):
        return execute(units[: (len(units) + 1) // 2], *args, **kwargs)
    monkeypatch.setattr(engine, "execute_round", half)
    out = tiny_run()
    assert not out["correct"] and out["failed"] > 0
