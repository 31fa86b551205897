"""The plain reference against the program on small sets (CPU)."""
import json
from pathlib import Path

import numpy as np
import pytest

from portbench import control, generator, reference

HERE = Path(__file__).resolve().parent
KEY = (0x0706050403020100, 0x0F0E0D0C0B0A0908)


def as_set(rows):
    return {bytes(r) for r in rows}


def test_difference_is_plain_set_arithmetic():
    cfg = json.loads((HERE / "configs" / "eth-state.json").read_text())
    cfg["records"] = 300
    tr = {"replicas": 2, "stale_per_replica": {"values": [4, 9]}}
    data = generator.make_cell(cfg, tr, 5)
    node = as_set(data.node)
    for rep in data.replicas:
        held = node - as_set(data.node[rep.rows]) | as_set(rep.stale)
        remote, local = generator.difference(data, rep)
        assert as_set(remote) == node - held
        assert as_set(local) == held - node


@pytest.mark.parametrize("nbytes", [16, 92, 5])
def test_hash_and_chains_match_the_program(nbytes):
    from repro_torch.core.hashing import bytes_to_words, map_key, siphash24
    from repro_torch.core.mapping import indices_matrix_np, map_seeds
    recs = generator.records(generator.rng(3, "h"), 40, nbytes)
    words = bytes_to_words(recs, nbytes)
    assert np.array_equal(reference.siphash24(recs, KEY),
                          siphash24(words, KEY, nbytes))
    assert np.array_equal(reference.siphash24(recs, map_key(KEY)) |
                          np.uint64(1), map_seeds(words, KEY, nbytes))
    item, index = reference.chains(recs, KEY, 5000)
    mat = indices_matrix_np(map_seeds(words, KEY, nbytes), 5000)
    for i in range(recs.shape[0]):
        row = mat[i][mat[i] < 5000]
        assert np.array_equal(index[item == i], row)


def test_peel_on_a_small_graph():
    # items 0, 1, 2; symbol 0 holds all, 1 holds {0}, 2 holds {0, 1},
    # 3 holds {2}: 0 peels at 1, then 1 at 2, then 2 at 0
    item = np.array([0, 0, 0, 1, 1, 2, 2])
    index = np.array([0, 1, 2, 0, 2, 0, 3])
    assert reference.peel(item, index, 3, 4).all()
    assert reference.peel(item, index, 3, 3).all()
    # two symbols: 0 peels at 1, and {1, 2} are stuck at 0
    assert reference.peel(item, index, 3, 2).tolist() == [True, False, False]
    assert not reference.peel(item, index, 3, 0).any()


@pytest.mark.parametrize("nbytes,d_remote,d_local",
                         [(92, 0, 0), (92, 1, 0), (16, 3, 5), (92, 40, 25),
                          (16, 300, 200)])
def test_symbols_used_match_a_program_session(nbytes, d_remote, d_local):
    from repro_torch.protocol import (Exponential, Session, SymbolStream,
                                      run_session)
    from repro_torch.core.encoder import Encoder
    gen = generator.rng(nbytes + d_remote, "s")
    common = generator.records(gen, 400, nbytes)
    remote = generator.records(gen, d_remote, nbytes)
    local = generator.records(gen, d_local, nbytes)
    stream = SymbolStream.from_items(np.concatenate([common, remote]),
                                     nbytes, KEY)
    enc = Encoder(nbytes, KEY)
    enc.add_items(np.concatenate([common, local]))
    rep = run_session(stream, Session(local=enc, pacing=Exponential(8, 2.0),
                                      device="cpu"), wire=True)
    want = reference.Expected(remote, local, KEY,
                              reference.window_ends(8, 2.0, 1 << 16))
    assert rep.symbols_used == want.symbols
    gap = reference.judge(rep.only_remote_bytes(), rep.only_local_bytes(),
                          rep.symbols_used, want)
    assert gap == {"records": 0, "symbols": 0}


def test_judge_counts_each_wrong_record():
    rows = generator.records(generator.rng(1, "j"), 6, 16)
    want = reference.Expected(rows[:3], rows[3:], KEY,
                              reference.window_ends(8, 2.0, 4096))
    assert reference.judge(rows[:3], rows[3:], want.symbols, want) == \
        {"records": 0, "symbols": 0}
    assert reference.judge(rows[:2], rows[3:], want.symbols, want) == \
        {"records": 1, "symbols": 0}
    assert reference.judge(rows[[0, 1, 2, 2]], rows[3:], want.symbols,
                           want)["records"] == 1
    assert reference.judge(rows[3:], rows[:3], 2 * want.symbols, want) == \
        {"records": 12, "symbols": 1}


@pytest.mark.parametrize("cell", ["eth-state.catchup",
                                  "ckpt-qwen3-30b-a3b.audit"])
def test_control_fails_the_check(cell):
    """The control (the reference one window early) reads above every
    limit; at a test's size (the chip run reads it at the cell's)."""
    config_name = cell.split(".")[0]
    cfg = json.loads((HERE / "configs" / f"{config_name}.json").read_text())
    cfg["records"] = 2000
    tr = json.loads((HERE / "workloads" / f"{cell}.json").read_text())
    if cell == "eth-state.catchup":
        tr["stale_per_replica"] = {"values": [50, 100, 150, 200]}
    for seed in (1, 2, 3):
        r = control.readings(cfg, tr, seed)
        assert r["wrong_symbols_used"] == r["replicas"]
        if cell == "eth-state.catchup":
            assert r["wrong_records"] > 0
