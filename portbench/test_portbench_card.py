"""A traced run on the card at a test's size (skips without one).

Run on the card: ``python3 -m pytest -q -m card portbench`` from the root
of a checkout, with ``src`` on ``PYTHONPATH``.
"""
import json
import time
from pathlib import Path

import pytest

from portbench import harness

HERE = Path(__file__).resolve().parent


@pytest.mark.card
def test_traced_run_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from repro_torch.kernels import _build
    _build.build()
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    cfg = json.loads((HERE / "configs" /
                      "ckpt-qwen3-30b-a3b.json").read_text())
    cfg["records"] = 20000
    cell = "ckpt-qwen3-30b-a3b.audit"
    tr = json.loads((HERE / "workloads" / f"{cell}.json").read_text())
    out = harness.measure(bench, cell, cfg, tr, 5, 1.0, True,
                          t_start=time.perf_counter(),
                          log=lambda line: None)
    assert out["correct"] and out["device"]["platform"] == "gpu"
    assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
    assert set(out["metrics"]) == {m["name"] for m in bench["per_layer"]}
    assert 0 < out["metrics"]["kernels.decode_roofline"]["value"] <= 100
    assert out["breakdown"]["device_ops"]
