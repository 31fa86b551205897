"""End-to-end training driver with checkpoint/restart fault tolerance and
Rateless-IBLT state repair.

Port of ``repro/launch/train.py``.  As the reference, it trains on
``make_local_mesh()``: a mesh of one rank on one device (the card unless
``--device cpu`` is asked for; without CUDA it raises), its parameters
and optimizer state DTensors placed by their specs.  The store holds each
leaf's full tensor, so a store written on a mesh is the one written
without; a restore places the leaves again:

    python -m repro_torch.launch.train --arch yi-9b --smoke --steps 50
    python -m repro_torch.launch.train --arch yi-9b --smoke --steps 50 \\
        --fail-at 20 --peer-dir /ckpts/healthy   # crash + IBLT repair demo

Recovery path on start (:func:`recover`): verify chunk digests -> if
chunks are corrupt and a peer is configured, write each bad chunk's
digest of its on-disk bytes into the manifest (the manifest, not the
bytes, is the set reconciled, so without this a corrupt chunk at the
peer's step differs in nothing) -> reconcile only the differing chunks
from the peer (:func:`repro_torch.checkpoint.reconcile.sync_from_peer`,
peeling on the device) -> verify again -> restore -> resume at the
stored step.  Batch t is a pure function of (arch, t) in any process
(:func:`synthetic_batch`), so a restarted worker resumes exactly.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import time

import torch
from torch.utils._pytree import tree_map


def synthetic_batch(cfg, step: int, batch: int, seq: int, device="cuda"):
    """Deterministic data pipeline with O(1) skip-ahead: int64 tokens
    drawn by a CPU ``torch.Generator`` seeded from a blake2b digest of
    the arch name and ``step`` (never ``hash()``, which Python salts per
    process), moved to ``device``; stub patches or frames are zeros."""
    digest = hashlib.blake2b(f"{cfg.name}#{step}".encode(), digest_size=8)
    gen = torch.Generator().manual_seed(
        int.from_bytes(digest.digest(), "little") >> 1)
    toks = torch.randint(0, cfg.vocab, (batch, seq + 1), generator=gen,
                         dtype=torch.int64).to(device)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.frontend == "vision_stub":
        out["patches"] = torch.zeros((batch, cfg.n_patches, cfg.d_model),
                                     device=device)
    if cfg.frontend == "audio_stub":
        out["frames"] = torch.zeros((batch, cfg.encoder_frames, cfg.d_model),
                                    device=device)
    return out


def _redigest(store, cids) -> None:
    """Write each chunk's keyed digest of its on-disk bytes (of no bytes
    if the file is gone) into ``store``'s manifest, so that its record
    differs from a healthy peer's."""
    from repro_torch.checkpoint.manager import _digest
    man = store.manifest()
    for cid in cids:
        name, idx = cid.rsplit("#", 1)
        try:
            with open(store._chunk_path(cid), "rb") as f:
                data = f.read()
        except FileNotFoundError:
            data = b""
        man["chunks"][cid] = _digest(name, int(idx), data)
    with open(os.path.join(store.root, "manifest.json"), "w") as f:
        json.dump(man, f)


def recover(store, struct, peer_store=None, device="cuda"):
    """Bring ``store``'s checkpoint back and restore it.

    Verifies every chunk; if some are corrupt and ``peer_store`` (a
    healthy :class:`~repro_torch.checkpoint.CheckpointStore`) is given,
    re-digests them into the manifest, repairs from the peer with
    ``sync_from_peer`` on ``device`` and verifies again, exiting nonzero
    with the chunks' names if any is still bad (or if no peer is given).
    Restores into ``struct`` (meta tensors will do) on ``device``.
    Returns (state, the manifest's step, the SyncReport or None)."""
    from repro_torch.checkpoint.reconcile import PeerEndpoint, sync_from_peer
    report = None
    bad = store.verify()
    if bad and peer_store is None:
        raise SystemExit(f"corrupt checkpoint, no peer: {bad[:4]}")
    if bad:
        print(f"[recover] {len(bad)} corrupt chunks; reconciling from peer "
              "via Rateless IBLT", flush=True)
        _redigest(store, bad)
        report = sync_from_peer(store, PeerEndpoint(peer_store),
                                device=device)
        print(f"[recover] fetched {report.chunks_fetched} chunks, "
              f"{report.total_bytes / 1e6:.2f} MB vs naive "
              f"{report.naive_bytes / 1e6:.2f} MB "
              f"({report.savings:.1f}x saved)", flush=True)
        still = store.verify()
        if still:
            raise SystemExit(f"[recover] {len(still)} chunks still corrupt "
                             f"after the repair: {still}")
    state = store.restore(struct, device)
    start = int(store.manifest()["step"])
    print(f"[recover] resumed from step {start}", flush=True)
    return state, start, report


def save_state(store, step: int, tree) -> None:
    """``store.save`` of the full tensors of a tree of DTensors (every
    rank takes part in the gathers; the first writes)."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import full_tree
    full = full_tree(tree)
    if not dist.is_initialized() or dist.get_rank() == 0:
        store.save(step, full)
    if dist.is_initialized():
        dist.barrier()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-9b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default="out/train_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--fail-at", type=int, default=0,
                    help="simulate a crash after this step (exit 17)")
    ap.add_argument("--peer-dir", default=None,
                    help="healthy peer checkpoint dir for IBLT repair")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; never chosen for you")
    args = ap.parse_args(argv)

    from repro_torch.checkpoint import CheckpointStore
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.core.decoder import resolve_device
    from repro_torch.launch.mesh import distribute, make_local_mesh
    from repro_torch.models import batch_specs, build_model
    from repro_torch.train.loop import (init_train_state, make_opt_config,
                                        make_train_step)
    from repro_torch.train.optim import state_specs

    device = resolve_device(args.device)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    mesh = make_local_mesh(device=device)
    model = build_model(cfg, mesh, device)
    opt_cfg = make_opt_config(cfg, total_steps=args.steps)
    store = CheckpointStore(args.ckpt_dir)

    params, opt_state, specs = init_train_state(
        model, opt_cfg, torch.Generator(device=device).manual_seed(0))
    start = 0
    if store.manifest() is not None:
        # the fresh state is freed before the checkpoint's is loaded
        struct = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                                device="meta"),
                          {"params": params, "opt": opt_state})
        del params, opt_state
        peer = CheckpointStore(args.peer_dir) if args.peer_dir else None
        state, start, _ = recover(store, struct, peer, device)
        state = distribute(state, {"params": specs,
                                   "opt": state_specs(opt_cfg, specs)}, mesh)
        params, opt_state = state["params"], state["opt"]

    step_fn = make_train_step(model, opt_cfg)
    t0 = time.time()
    for t in range(start, args.steps):
        batch = synthetic_batch(cfg, t, args.batch, args.seq, device)
        batch = distribute(batch, batch_specs(batch, mesh), mesh)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if t % 10 == 0 or t == args.steps - 1:
            print(f"step {t} loss {float(metrics['loss']):.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"({(time.time() - t0):.1f}s)", flush=True)
        if args.ckpt_every and (t + 1) % args.ckpt_every == 0:
            save_state(store, t + 1, {"params": params, "opt": opt_state})
            print(f"[ckpt] step {t + 1}", flush=True)
        if args.fail_at and t + 1 == args.fail_at:
            print("[failure-injection] simulating crash", flush=True)
            raise SystemExit(17)
    print("done", flush=True)


if __name__ == "__main__":
    main()
