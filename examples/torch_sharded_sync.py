"""Sharded fan-out on the PyTorch/CUDA port: one 8-shard stream serves
replicas over merged payloads.

The server hash-partitions its key space into 8 shards and keeps one
universal symbol cache per shard.  Each replica opens a
``ShardedSession``: every round trip it requests a window for each
still-undecoded shard, the server answers with ONE merged wire payload,
and the replica decodes all touched shards in ONE batched decode on the
card.  Hot shards keep growing their windows while settled shards stop.

    PYTHONPATH=src python examples/torch_sharded_sync.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.protocol import (FixedBlock, ShardedStream,
                                  run_sharded_session)

parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
parser.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
device = parser.parse_args().device

rng = np.random.default_rng(11)
nbytes = 16
state = rng.integers(0, 256, (50_000, nbytes), dtype=np.uint8)

server = ShardedStream.from_items(state, nbytes, n_shards=8)  # encodes ONCE
print(f"server: {server.n_items} items over {server.n_shards} shards "
      f"({', '.join(str(s.n_items) for s in server.shards)})")

for staleness in (24, 400):
    replica_state = np.concatenate(
        [state[:-staleness],
         rng.integers(0, 256, (4, nbytes), dtype=np.uint8)])
    replica = ShardedStream.from_items(replica_state, nbytes, n_shards=8)
    session = server.session(local=replica, pacing=FixedBlock(8),
                             device=device)
    report = run_sharded_session(server, session)      # merged wire payloads
    d = staleness + 4
    per_shard = ", ".join(str(sr.symbols_used) for sr in report.shards)
    print(f"replica d={d}: decoded in {report.grow_steps} round trips, "
          f"{report.symbols_used} symbols total [{per_shard}] "
          f"({report.bytes_received} wire bytes, "
          f"overhead {report.overhead(d):.2f}x)")
    assert report.only_remote.shape[0] + report.only_local.shape[0] == d

print(f"server caches hold {server.m} symbols across shards — grown once, "
      f"shared by every replica")
