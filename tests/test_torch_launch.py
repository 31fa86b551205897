"""The PyTorch port's training driver (``python -m
repro_torch.launch.train``) on ``--device cpu``: crash and resume, the
deterministic data pipeline, and the repair of corrupt chunks from a
peer through Rateless IBLT.

A run that crashes after step 6 and resumes from its step-5 checkpoint
must end with the same step-10 store, digest for digest, as a run that
never crashed (the CPU computes bit for bit alike in both processes).
The reference's own driver has two faults the port does not copy
(ROADMAP §3): ``synthetic_batch`` seeds from ``hash(cfg.name)``, which
Python salts per process, and a chunk corrupted at the peer's step is
never fetched, because the set reconciled is the manifest's digests,
which corruption leaves as they were.
"""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.checkpoint.manager import CheckpointStore as RefStore  # noqa: E402
from repro.checkpoint.reconcile import PeerEndpoint as RefPeer  # noqa: E402
from repro.checkpoint.reconcile import \
    sync_from_peer as ref_sync_from_peer  # noqa: E402

from repro_torch.checkpoint import CheckpointStore  # noqa: E402
from repro_torch.launch.train import recover  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
DRIVER = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
          "starcoder2-3b", "--smoke", "--steps", "10", "--batch", "2",
          "--seq", "32", "--ckpt-every", "5", "--device", "cpu"]


def run(args, timeout=120, **env):
    e = dict(os.environ, PYTHONPATH=str(ROOT / "src"), **env)
    return subprocess.run(args, env=e, cwd=ROOT, capture_output=True,
                          text=True, timeout=timeout)


def digests(path):
    with open(os.path.join(path, "manifest.json")) as f:
        man = json.load(f)
    return man["step"], man["chunks"]


def corrupt(path, n):
    """Overwrite the chunk files of ``n`` chunk ids; returns the ids."""
    store = CheckpointStore(str(path))
    cids = sorted(store.manifest()["chunks"])[3:3 + n]
    for cid in cids:
        with open(store._chunk_path(cid), "wb") as f:
            f.write(b"garbage")
    return cids


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """A run that never crashes, and one that crashes after step 6 (its
    step-5 store kept)."""
    base = tmp_path_factory.mktemp("driver")
    whole = run(DRIVER + ["--ckpt-dir", str(base / "whole")])
    assert whole.returncode == 0, whole.stderr[-800:]
    crash = run(DRIVER + ["--ckpt-dir", str(base / "crash"), "--fail-at",
                          "6"])
    assert crash.returncode == 17, crash.stderr[-800:]
    assert "[ckpt] step 5" in crash.stdout
    assert "[ckpt] step 10" not in crash.stdout
    return base, whole


@pytest.mark.parametrize("n_bad", [0, 2])
def test_resume_ends_with_the_uncrashed_digests(runs, n_bad, tmp_path):
    """Resuming the crashed run (with ``n_bad`` of its chunks overwritten
    and a copy of its store as the healthy peer) finishes at step 10 with
    every chunk digest of the run that never crashed, and fetches exactly
    the corrupted chunks."""
    base, whole = runs
    ckpt, peer = tmp_path / "ckpt", tmp_path / "peer"
    shutil.copytree(base / "crash", ckpt)
    shutil.copytree(base / "crash", peer)
    corrupt(ckpt, n_bad)
    extra = ["--peer-dir", str(peer)] if n_bad else []
    r = run(DRIVER + ["--ckpt-dir", str(ckpt)] + extra)
    assert r.returncode == 0, r.stderr[-800:]
    assert "[recover] resumed from step 5" in r.stdout
    assert r.stdout.rstrip().endswith("done")
    if n_bad:
        assert f"[recover] {n_bad} corrupt chunks" in r.stdout
        assert f"[recover] fetched {n_bad} chunks" in r.stdout
    assert digests(ckpt) == digests(base / "whole")
    last = [ln for ln in r.stdout.splitlines() if ln.startswith("step 9 ")]
    assert last and last[0].split()[3] == [
        ln for ln in whole.stdout.splitlines()
        if ln.startswith("step 9 ")][0].split()[3]


def test_corrupt_store_without_peer_exits_nonzero(runs, tmp_path):
    ckpt = tmp_path / "ckpt"
    shutil.copytree(runs[0] / "crash", ckpt)
    bad = corrupt(ckpt, 1)
    r = run(DRIVER + ["--ckpt-dir", str(ckpt)])
    assert r.returncode != 0 and bad[0] in r.stderr


BATCH_PRINT = """
import hashlib, sys
from {pkg}.configs import smoke_config
from {pkg}.launch.train import synthetic_batch
cfg = smoke_config("starcoder2-3b")
{draw}
print(hashlib.sha256(b"".join(toks)).hexdigest())
"""
DRAWS = {
    "repro_torch": "toks = [synthetic_batch(cfg, t, 2, 32, 'cpu')"
                   "['tokens'].numpy().tobytes() for t in (0, 7)]",
    "repro": "import numpy as np\n"
             "toks = [np.asarray(synthetic_batch(cfg, t, 2, 32)['tokens'])"
             ".tobytes() for t in (0, 7)]",
}


@pytest.mark.parametrize("pkg", ["repro_torch", "repro"])
def test_synthetic_batch_across_processes(pkg):
    """Two processes with different string-hash salts draw the same
    batches from the port's pipeline; the reference's seed is
    ``hash(cfg.name) % 2**31``, so its batches differ."""
    code = BATCH_PRINT.format(pkg=pkg, draw=DRAWS[pkg])
    outs = []
    for salt in ("1", "2"):
        r = run([sys.executable, "-c", code], PYTHONHASHSEED=salt,
                JAX_PLATFORMS="cpu")
        assert r.returncode == 0, r.stderr[-800:]
        outs.append(r.stdout.strip())
    assert (outs[0] == outs[1]) == (pkg == "repro_torch")


def _store_pair(tmp_path, pkg_store):
    """A healthy store and a replica at the same step with one chunk
    overwritten."""
    rng = np.random.default_rng(0)
    tree = {"w": rng.standard_normal((300, 500)).astype(np.float32),
            "b": rng.standard_normal(70).astype(np.float32)}
    if pkg_store is CheckpointStore:
        tree = {k: torch.from_numpy(v) for k, v in tree.items()}
    a = pkg_store(str(tmp_path / "a"))
    b = pkg_store(str(tmp_path / "b"))
    a.save(5, tree)
    b.save(5, tree)
    cid = sorted(b.manifest()["chunks"])[1]
    with open(b._chunk_path(cid), "wb") as f:
        f.write(b"garbage")
    return a, b, tree, cid


def test_same_step_corrupt_chunk_needs_redigest(tmp_path):
    """One chunk overwritten at the peer's step: the reference's
    ``sync_from_peer`` (what its driver calls) fetches nothing and the
    store still fails ``verify()``; the port's ``recover`` re-digests the
    chunk into the manifest first, fetches it, verifies and restores."""
    a, b, _, cid = _store_pair(tmp_path / "ref", RefStore)
    assert b.verify() == [cid]
    assert ref_sync_from_peer(b, RefPeer(a)).chunks_fetched == 0
    assert b.verify() == [cid]

    a, b, tree, cid = _store_pair(tmp_path / "port", CheckpointStore)
    struct = {k: torch.empty_like(v, device="meta") for k, v in tree.items()}
    state, step, report = recover(b, struct, a, device="cpu")
    assert report.chunks_fetched == 1 and step == 5
    assert b.verify() == []
    for k, v in tree.items():
        assert torch.equal(state[k], v)


def test_driver_raises_without_cuda(tmp_path):
    """Without ``--device cpu`` the driver runs on the card, and without
    one it raises instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = run(DRIVER[:-2] + ["--ckpt-dir", str(tmp_path / "c"), "--steps",
                           "1"])
    assert r.returncode != 0
    assert "CUDA is not available" in r.stderr
    assert not (tmp_path / "c").exists()
