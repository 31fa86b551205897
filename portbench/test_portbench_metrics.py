"""The metric arithmetic: window-wide rates and tails, bytes bounds, the
device trace's busy and idle time."""
import json
from pathlib import Path

import numpy as np
import pytest

from portbench import harness, peaks, trace
from portbench.drivers.rounds import Report, Round

HERE = Path(__file__).resolve().parent
BENCH = json.loads((HERE.parent / "BENCHMARK.json").read_text())


def fake_run(durations_ms, d_each=10, L=23, device=None, spans=None):
    rounds, t = [], 0
    for i, ms in enumerate(durations_ms):
        w = np.zeros((d_each // 2, L), np.uint32)
        rep = Report(i, w, w, symbols_used=64, bytes_received=1000,
                     host_fallbacks=0)
        rounds.append(Round(t, t + int(ms * 1e6), [i], [rep], ticks=3,
                            dispatches=3, host_reads=5))
        t += int(ms * 1e6)
    return harness.Run(L, setup_s=12.5, window_s=t * 1e-9,
                       rounds=rounds, device=device, spans=spans)


def test_every_metric_has_its_reader():
    for kind in ("end_to_end", "per_layer"):
        for m in BENCH[kind]:
            assert (HERE / "metrics" / f"{m['name']}.py").exists()


def test_tail_and_rate_over_the_whole_window():
    durations = [100.0] * 180 + [400.0] * 20   # 200 rounds
    run = fake_run(durations)
    p95 = harness.read_metric("engine.sync_p95_ms", run)
    assert p95 == pytest.approx(np.percentile(durations, 95))
    # a median of chunks' p95 would read 100 here: 20 slow rounds in one
    # chunk of ten
    assert p95 == pytest.approx(400.0)
    rate = harness.read_metric("diff_items_per_s", run)
    assert rate == pytest.approx(200 * 10 / (sum(durations) * 1e-3))
    assert harness.read_metric("wire_bytes_per_diff", run) == 100.0
    assert harness.read_metric("wire_bytes_per_symbol", run) == 1000 / 64
    assert harness.read_metric("setup_s", run) == 12.5
    assert harness.read_metric("engine.ticks_per_round", run) == 3
    assert harness.read_metric("decode.host_reads_per_round", run) == 5


def test_readers_find_nothing_in_an_empty_window():
    run = fake_run([])
    for name in ("diff_items_per_s", "engine.sync_p95_ms", "wire_bytes_per_diff",
                 "wire_bytes_per_symbol", "device.idle_share",
                 "kernels.decode_roofline",
                 "serve.ms_per_ksym"):
        assert harness.read_metric(name, run) is None


def test_decode_bytes_bound():
    # eth-state: 92-byte records, L = 23: a symbol is 92 + 8 + 4 bytes on
    # the card, a recovered record 92 + 8
    assert peaks.symbol_bytes(23) == 104
    assert peaks.decode_bytes(262144, 100000, 23) == \
        262144 * 104 + 100000 * 100
    assert peaks.bound_seconds(3.35e12) == 1.0
    run = fake_run([50.0] * 4, device={"busy_s": 0.01, "window_s": 0.2})
    want = 4 * peaks.decode_bytes(64, 10, 23) / 3.35e12 / 0.01 * 100
    assert harness.read_metric("kernels.decode_roofline", run) == \
        pytest.approx(want)
    assert harness.read_metric("device.idle_share", run) == \
        pytest.approx(95.0)


def test_serve_rate_from_spans():
    spans = trace.Spans()
    spans.intervals["serve"] = [(0, 2_000_000), (5_000_000, 6_000_000)]
    spans.counts["serve"] = 3000
    run = fake_run([1.0], spans=spans)
    assert harness.read_metric("serve.ms_per_ksym", run) == \
        pytest.approx(1.0)


def test_union_busy_and_idle_by_host():
    start = np.array([10, 15, 40, 90])
    end = np.array([20, 30, 50, 120])
    s, e = trace.union(start, end, 0, 100)
    assert s.tolist() == [10, 40, 90] and e.tolist() == [30, 50, 100]
    assert trace.busy_ns(start, end, 0, 100) == 40
    # idle: [0,10) [30,40) [50,90); the host served in [0,35), waited in
    # [60,70); rounds cover [0,80)
    idle = dict(trace.idle_by_host(start, end, 0, 100,
                                   {"serve": [(0, 35)], "wait": [(60, 70)]},
                                   [(0, 80)]))
    assert idle["serve"] == pytest.approx(15e-9)
    assert idle["wait"] == pytest.approx(10e-9)
    assert idle["engine"] == pytest.approx(25e-9)       # [35,40) [50,60) [70,80)
    assert idle["between_rounds"] == pytest.approx(10e-9)
    assert sum(idle.values()) == pytest.approx(60e-9)


def test_top_ops_by_name():
    names = ["a", "b", "a"]
    ops = trace.top_ops(names, np.array([0, 5, 20]), np.array([4, 25, 30]),
                        0, 100)
    assert [n for n, _ in ops] == ["b", "a"]
    assert [t for _, t in ops] == pytest.approx([20e-9, 14e-9])


def test_short_kernel_names():
    assert trace.short_name("void at::native::f<long, 4>(long*, int)") == \
        "at::native::f"
    assert trace.short_name("purity_scan_kernel") == "purity_scan_kernel"
    assert trace.short_name("Memcpy HtoD (Pinned -> Device)") == "Memcpy HtoD"
