"""The traffic generator: deterministic per seed, fixed sizes per cell."""
import json
from pathlib import Path

import numpy as np
import pytest

from portbench import generator

HERE = Path(__file__).resolve().parent
CELLS = sorted(p.stem for p in (HERE / "workloads").glob("*.json"))


def small(config_name: str, records: int = 500) -> dict:
    cfg = json.loads((HERE / "configs" / f"{config_name}.json").read_text())
    cfg["records"] = records
    return cfg


def traffic(cell: str) -> dict:
    return json.loads((HERE / "workloads" / f"{cell}.json").read_text())


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5, 3 * 2**40, -3])
def test_same_seed_same_sets(seed):
    cfg, tr = small("eth-state"), traffic("eth-state.peers")
    tr["stale_per_replica"] = {"law": "log_uniform", "lo": 3, "hi": 40}
    a = generator.make_cell(cfg, tr, seed)
    b = generator.make_cell(cfg, tr, seed)
    assert np.array_equal(a.node, b.node)
    for x, y in zip(a.replicas, b.replicas):
        assert np.array_equal(x.rows, y.rows)
        assert np.array_equal(x.stale, y.stale)
    draws_a, draws_b = generator.rounds(tr, seed), generator.rounds(tr, seed)
    assert [next(draws_a) for _ in range(5)] == \
        [next(draws_b) for _ in range(5)]


def test_other_seed_other_sets_same_sizes():
    cfg, tr = small("eth-state"), traffic("eth-state.peers")
    tr["stale_per_replica"] = {"law": "log_uniform", "lo": 3, "hi": 40}
    a = generator.make_cell(cfg, tr, 1)
    b = generator.make_cell(cfg, tr, 2)
    assert not np.array_equal(a.node, b.node)
    assert sorted(r.d for r in a.replicas) == sorted(r.d for r in b.replicas)
    assert [r.d for r in a.replicas] != [r.d for r in b.replicas]


@pytest.mark.parametrize("config_name", ["eth-state", "ckpt-qwen3-30b-a3b"])
def test_stale_records_keep_their_key(config_name):
    cfg = small(config_name)
    tr = {"replicas": 3, "stale_per_replica": {"values": [0, 5, 20]}}
    data = generator.make_cell(cfg, tr, 11)
    kb = cfg["key_bytes"]
    assert sorted(r.d for r in data.replicas) == [0, 10, 40]
    for rep in data.replicas:
        fresh, stale = generator.difference(data, rep)
        assert np.array_equal(fresh[:, :kb], stale[:, :kb])
        assert (fresh[:, kb:] != stale[:, kb:]).any(axis=1).all()
        assert len(np.unique(rep.rows)) == rep.rows.size


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_has_its_pool(cell):
    tr = traffic(cell)
    sizes = generator.pool_sizes(tr["stale_per_replica"], tr["replicas"])
    assert len(sizes) == tr["replicas"] >= tr["peers_per_round"]
    assert min(sizes) >= 0 and max(sizes) > 0


def test_pool_laws():
    assert generator.pool_sizes({"values": [1, 2]}, 3) == [1, 2, 1]
    logs = generator.pool_sizes({"law": "log_uniform", "lo": 100,
                                 "hi": 2000}, 32)
    assert logs == sorted(logs) and 100 <= logs[0] and logs[-1] <= 2000
    audit = generator.pool_sizes({"law": "uniform", "lo": 1, "hi": 8,
                                  "zero_share": 1 / 3}, 64)
    assert audit.count(0) == 21 and set(audit) == set(range(9))


def test_stream_length_holds_the_largest_difference():
    cfg = small("eth-state")
    tr = {"replicas": 4, "stale_per_replica": {"values": [50000]}}
    # d = 100,000: decodes by 2**18 (>= 2.5 d), plus one pipelined window
    assert generator.stream_length(cfg, tr) == 2**19
    tr = {"replicas": 4, "stale_per_replica": {"values": [0, 3]}}
    assert generator.stream_length(cfg, tr) == 512


def test_rounds_cycle_through_the_pool():
    tr = {"replicas": 32, "peers_per_round": 8}
    draws = generator.rounds(tr, 99)
    for _ in range(3):
        cycle = [next(draws) for _ in range(4)]
        assert sorted(sum(cycle, [])) == list(range(32))
    with pytest.raises(ValueError):
        next(generator.rounds({"replicas": 10, "peers_per_round": 4}, 1))
