"""The PyTorch port's checkpoint store and repair ≡ the JAX package's.

Both packages save the same tree, built from a seed with numpy (bf16 as
``ml_dtypes`` arrays on the JAX side, through ``tree_from_numpy`` on the
port's): the stores must be byte-identical on disk and readable by either
package.  Repairs run the port's session on ``device="cpu"`` (the kernels'
plain torch versions) and must report what the reference reports.
"""
import dataclasses
import json
import os

import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from torch.utils._pytree import tree_map  # noqa: E402

from repro.checkpoint.manager import CheckpointStore as RefStore  # noqa: E402
from repro.checkpoint.reconcile import PeerEndpoint as RefPeer  # noqa: E402
from repro.checkpoint.reconcile import \
    sync_from_peer as ref_sync_from_peer  # noqa: E402

from repro_torch.checkpoint import (CheckpointStore, PeerEndpoint,  # noqa: E402
                                    SyncReport, sync_from_peer)
from repro_torch.checkpoint.manager import (_digest, cid_hashes,  # noqa: E402
                                            tree_from_numpy)
from repro_torch.checkpoint.reconcile import \
    _record_key_hashes  # noqa: E402


def numpy_tree(seed, scale=1.0):
    """float32, bf16 over two chunks, int32, a 0-d leaf, dict keys out of
    sorted order, a list."""
    rng = np.random.default_rng(seed)
    return {
        "layer1": {"w": (rng.standard_normal((300, 128)) * scale)
                   .astype(np.float32)},
        "embed": (rng.standard_normal((700, 200)) * scale)
        .astype(ml_dtypes.bfloat16),
        "blocks": [{"w": rng.integers(-9, 9, (64, 50), dtype=np.int32),
                    "b": np.zeros(50, np.float32)},
                   np.array(7, np.int32)],
        "layer0": {"w": (rng.standard_normal((256, 300)) * scale)
                   .astype(np.float32)},
    }


def ported(tree):
    return tree_from_numpy(tree, "cpu")


def chunk_files(store):
    d = os.path.join(store.root, "chunks")
    return {f: open(os.path.join(d, f), "rb").read() for f in os.listdir(d)}


def assert_same_tensors(got, want_numpy):
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want_numpy)):
        w = np.asarray(w)
        if w.dtype.name == "bfloat16":
            g, w = g.view(torch.int16), w.view(np.int16)
        np.testing.assert_array_equal(g.cpu().numpy(), w)


def test_store_is_byte_identical_across_packages(tmp_path):
    tree = numpy_tree(0)
    ref, port = RefStore(str(tmp_path / "r")), CheckpointStore(
        str(tmp_path / "t"))
    assert port.save(4, ported(tree)) == ref.save(4, tree)
    assert port.manifest() == ref.manifest()
    assert (tmp_path / "t" / "manifest.json").read_bytes() == \
        (tmp_path / "r" / "manifest.json").read_bytes()
    assert port.manifest()["leaves"]["embed"] == {"shape": [700, 200],
                                                  "dtype": "bfloat16"}
    assert port.manifest()["leaves"]["blocks/1"]["shape"] == []
    assert "embed#1" in port.manifest()["chunks"]
    assert chunk_files(port) == chunk_files(ref)
    assert port.records().dtype == np.uint8
    np.testing.assert_array_equal(port.records(), ref.records())


@pytest.mark.parametrize("writer", ["repro", "repro_torch"])
def test_store_restores_across_packages(tmp_path, writer):
    tree = numpy_tree(1)
    if writer == "repro":
        RefStore(str(tmp_path / "s")).save(2, tree)
    else:
        CheckpointStore(str(tmp_path / "s")).save(2, ported(tree))
    struct = tree_map(lambda t: torch.empty_like(t, device="meta"),
                      ported(tree))
    got = CheckpointStore(str(tmp_path / "s")).restore(struct, device="cpu")
    assert got["embed"].dtype == torch.bfloat16
    assert got["blocks"][1].shape == ()
    assert_same_tensors(got, tree)
    ref_struct = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape,
                                                             x.dtype), tree)
    back = RefStore(str(tmp_path / "s")).restore(ref_struct)
    assert_same_tensors(ported(jax.tree.map(np.asarray, back)), tree)


def test_restore_refuses_a_mismatched_structure(tmp_path):
    store = CheckpointStore(str(tmp_path / "s"))
    store.save(1, {"w": torch.zeros(4, 3)})
    with pytest.raises(ValueError, match="checkpoint holds"):
        store.restore({"w": torch.zeros(3, 4)}, device="cpu")
    with pytest.raises(ValueError, match="checkpoint holds"):
        store.restore({"w": torch.zeros(4, 3, dtype=torch.bfloat16)},
                      device="cpu")


def test_zero_element_leaves_round_trip(tmp_path):
    """Leaves of shapes (0,) and (3, 0) save, verify and restore in the
    port (the reference's ``load_leaf`` cannot restore them: it asks for
    one element and opens a chunk that was never written; ROADMAP, faults
    found).  Both packages' ``verify()`` accept the store."""
    tree = {"empty": torch.zeros(0), "wide": torch.zeros((3, 0),
                                                          dtype=torch.int32),
            "w": torch.arange(6, dtype=torch.float32).reshape(2, 3)}
    store = CheckpointStore(str(tmp_path / "z"))
    store.save(1, tree)
    assert store.verify() == []
    assert RefStore(store.root).verify() == []
    back = store.restore({k: torch.empty_like(v) for k, v in tree.items()},
                         device="cpu")
    for k, v in tree.items():
        assert back[k].shape == v.shape and back[k].dtype == v.dtype
        assert torch.equal(back[k], v)


def test_verify_detects_corruption(tmp_path):
    store = CheckpointStore(str(tmp_path / "c"))
    store.save(1, ported(numpy_tree(0)))
    cid = next(iter(store.manifest()["chunks"]))
    with open(store._chunk_path(cid), "r+b") as f:
        f.seek(0)
        f.write(b"\xff\xff\xff\xff")
    bad = store.verify()
    assert cid in bad and len(bad) == 1
    assert RefStore(store.root).verify() == bad


def stale_and_fresh(root, make):
    """(stale, fresh) stores of one package: the fresh one advanced — one
    leaf changed, one leaf dropped, one added."""
    base = numpy_tree(0)
    newer = dict(base)
    newer["layer1"] = {"w": base["layer1"]["w"] + np.float32(1.0)}
    newer["blocks"] = base["blocks"][:1]
    newer["head"] = np.arange(90_000, dtype=np.float32)
    stale, fresh = make(str(root / "stale")), make(str(root / "fresh"))
    return stale, fresh, base, newer


def test_sync_report_matches_reference(tmp_path):
    ref_stale, ref_fresh, base, newer = stale_and_fresh(tmp_path / "r",
                                                        RefStore)
    ref_stale.save(1, base)
    ref_fresh.save(2, newer)
    stale, fresh, _, _ = stale_and_fresh(tmp_path / "t", CheckpointStore)
    stale.save(1, ported(base))
    fresh.save(2, ported(newer))
    # the differing records include key-hash words with their top bit set
    old, new = ({r.tobytes() for r in s.records()} for s in (stale, fresh))
    diff = np.frombuffer(b"".join(sorted(old ^ new)), np.uint32)
    assert (diff.reshape(-1, 4)[:, :2] >> 31).any()

    before = stale.manifest()["chunks"]
    differing = [c for c, dig in fresh.manifest()["chunks"].items()
                 if before.get(c) != dig]

    want = ref_sync_from_peer(ref_stale, RefPeer(ref_fresh))
    got = sync_from_peer(stale, PeerEndpoint(fresh), device="cpu")
    for f in dataclasses.fields(want):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert got.chunks_fetched == len(differing) > 0
    assert got.host_fallbacks == 0
    assert stale.manifest() == ref_stale.manifest() == fresh.manifest()
    assert stale.verify() == []
    assert_same_tensors(stale.restore(ported(newer), device="cpu"), newer)


def test_record_key_hashes_keep_top_bits():
    kh = np.array([0xFFFF_FFFF_8000_0001, 0x8000_0000_FFFF_FFFF, 5],
                  np.uint64)
    recs = np.zeros((3, 2), "<u8")
    recs[:, 0] = kh
    words = recs.view(np.uint32)
    np.testing.assert_array_equal(_record_key_hashes(words), kh)
    with pytest.raises(TypeError, match="uint32"):
        _record_key_hashes(words.view(np.int32))


def test_cid_hashes_match_the_reference_records(tmp_path):
    store = CheckpointStore(str(tmp_path / "s"))
    store.save(1, ported(numpy_tree(2)))
    cids = sorted(store.manifest()["chunks"])
    recs = RefStore(store.root).records().view("<u8").reshape(-1, 2)
    np.testing.assert_array_equal(cid_hashes(cids), recs[:, 0])


def test_reconcile_corrupt_chunk(tmp_path):
    """Crash-corrupted chunks are detected by verify() and healed by
    reconciliation (digest mismatch -> manifest divergence -> repair)."""
    a = CheckpointStore(str(tmp_path / "a"))
    b = CheckpointStore(str(tmp_path / "b"))
    tree = ported(numpy_tree(3))
    a.save(5, tree)
    b.save(5, tree)
    cid = sorted(b.manifest()["chunks"])[1]
    with open(b._chunk_path(cid), "wb") as f:
        f.write(b"garbage")
    assert b.verify() == [cid]
    man = b.manifest()
    name, idx = cid.rsplit("#", 1)
    with open(b._chunk_path(cid), "rb") as f:
        data = np.frombuffer(f.read(), np.uint8)
    man["chunks"][cid] = _digest(name, int(idx), data)
    with open(os.path.join(b.root, "manifest.json"), "w") as f:
        json.dump(man, f)

    report = sync_from_peer(b, PeerEndpoint(a), device="cpu")
    assert isinstance(report, SyncReport)
    assert report.chunks_fetched == 1
    assert b.verify() == []


def test_peer_incremental_symbol_update(tmp_path):
    """Linearity: after the store changes, the peer updates its cached
    symbol stream in place and new replicas still reconcile correctly."""
    fresh = CheckpointStore(str(tmp_path / "f"))
    tree = numpy_tree(1)
    fresh.save(1, ported(tree))
    peer = PeerEndpoint(fresh)
    _ = peer.symbols(0, 64)              # warm the universal cache
    old_records = fresh.records()
    tree2 = dict(tree)
    tree2["layer0"] = {"w": tree["layer0"]["w"] * np.float32(2.0)}
    fresh.save(2, ported(tree2))
    new_records = fresh.records()
    old_set = {r.tobytes() for r in old_records}
    new_set = {r.tobytes() for r in new_records}
    added = np.array([np.frombuffer(x, np.uint8) for x in new_set - old_set])
    removed = np.array([np.frombuffer(x, np.uint8)
                        for x in old_set - new_set])
    peer.notify_update(added, removed)
    stale = CheckpointStore(str(tmp_path / "s"))
    stale.save(1, ported(tree))
    report = sync_from_peer(stale, peer, device="cpu")
    assert report.chunks_fetched == len(added)
    assert stale.manifest()["chunks"] == fresh.manifest()["chunks"]
    assert stale.verify() == []


def test_entry_points_refuse_the_cpu_unasked(tmp_path, monkeypatch):
    """Without CUDA the new entry points raise on their default device;
    they never drop to the CPU on their own."""
    from repro_torch.core import Sketch, reconcile_sets
    store = CheckpointStore(str(tmp_path / "s"))
    store.save(1, {"w": torch.arange(6)})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a, b = Sketch.from_items([b"\1" * 8], 8), Sketch.from_items([], 8)
    for call in (lambda: store.restore({"w": torch.arange(6)}),
                 lambda: sync_from_peer(store, PeerEndpoint(store)),
                 lambda: tree_from_numpy({"w": np.zeros(2)}),
                 lambda: reconcile_sets(a, b),
                 lambda: b.decode_against(a.symbols(4))):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
