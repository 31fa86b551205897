"""A stale training replica repairs its checkpoint from a healthy peer via
Rateless IBLT, on the PyTorch/CUDA port — the paper's Ethereum state-sync
scenario mapped onto the checkpoint store.

The parameters live on the card; the store copies them to the host one
leaf at a time, and the repair peels the manifest difference on the
card's kernels.

    PYTHONPATH=src python examples/torch_sync_checkpoint.py [--device cpu]
"""
import argparse
import tempfile

import torch

from repro_torch.checkpoint import CheckpointStore, PeerEndpoint, \
    sync_from_peer

parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
parser.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
device = parser.parse_args().device

gen = torch.Generator(device=device).manual_seed(0)


def randn(*shape):
    return torch.randn(shape, generator=gen, device=device)


with tempfile.TemporaryDirectory() as root:
    fresh = CheckpointStore(f"{root}/fresh")
    stale = CheckpointStore(f"{root}/stale")

    params = {"wte": randn(4096, 512),
              "blocks": [{"w": randn(512, 2048)} for _ in range(4)]}
    stale.save(100, params)

    # peer trained 10 more steps: a small fraction of chunks changed
    params["blocks"][2]["w"] = params["blocks"][2]["w"] + 0.01
    fresh.save(110, params)

    peer = PeerEndpoint(fresh)
    report = sync_from_peer(stale, peer, device=device)
    print(f"symbols used: {report.symbols_used} "
          f"({report.symbol_bytes/1e3:.1f} kB)")
    print(f"chunks fetched: {report.chunks_fetched} "
          f"({report.chunk_bytes/1e6:.2f} MB)")
    print(f"naive full download: {report.naive_bytes/1e6:.2f} MB")
    print(f"savings: {report.savings:.1f}x")
    assert stale.manifest()["chunks"] == fresh.manifest()["chunks"]
    assert stale.verify() == []
    back = stale.restore(params, device=device)
    assert torch.equal(back["blocks"][2]["w"], params["blocks"][2]["w"])
    print("replica repaired and verified. ✓")
