"""Quickstart on the PyTorch/CUDA port: reconcile two sets with Rateless
IBLT.

Alice publishes her set as one universal ``SymbolStream``; Bob opens a
``Session`` against it.  The session pulls windows of coded symbols as
wire ``bytes``, peels each window on the card's kernels as it arrives, and
stops the moment symbol 0 empties.  Nobody knew d = 42 in advance.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.core import Sketch, reconcile_sets
from repro_torch.protocol import Session, SymbolStream, run_session

parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
parser.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
device = parser.parse_args().device

rng = np.random.default_rng(0)

# two parties hold large, mostly-overlapping sets of 32-byte items
common = [bytes([0]) + rng.bytes(31) for _ in range(100_000)]
only_alice = [bytes([1]) + rng.bytes(31) for _ in range(30)]
only_bob = [bytes([2]) + rng.bytes(31) for _ in range(12)]

alice = SymbolStream.from_items(common + only_alice, nbytes=32)
bob = Sketch.from_items(common + only_bob, nbytes=32)

report = run_session(alice, Session(local=bob, device=device), wire=True)

d = len(only_alice) + len(only_bob)
print(f"difference size d = {d}")
print(f"coded symbols used = {report.symbols_used}  "
      f"(overhead {report.overhead(d):.2f}x, paper: 1.35-1.72x)")
print(f"wire bytes = {report.bytes_received} "
      f"vs naive {len(common + only_alice) * 32}")
got_a, got_b = report.only_remote_bytes(), report.only_local_bytes()
assert sorted(x.tobytes() for x in got_a) == sorted(only_alice)
assert sorted(x.tobytes() for x in got_b) == sorted(only_bob)
print(f"recovered symmetric difference exactly on {device}. ✓")

# the one-call convenience wrapper (same Session machinery underneath):
got_a2, got_b2, m_used = reconcile_sets(Sketch.from_items(
    common + only_alice, nbytes=32), bob, device=device)
assert sorted(x.tobytes() for x in got_a2) == sorted(only_alice)
print(f"reconcile_sets agrees (m = {m_used}). ✓")
