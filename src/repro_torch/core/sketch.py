"""Legacy one-call wrappers over the session protocol.

Port of ``repro/core/sketch.py``.  The primary entry point is
:mod:`repro_torch.protocol` — ``SymbolStream`` / ``Session`` /
``run_session`` — which is what ``reconcile_sets`` delegates to::

    from repro_torch.core import Sketch, reconcile_sets
    a = Sketch.from_items(list_of_bytes_a, nbytes=32)
    b = Sketch.from_items(list_of_bytes_b, nbytes=32)
    only_a, only_b, m_used = reconcile_sets(a, b)   # one Session, hidden

Both decoders peel on the device backend, on ``device="cuda"`` unless the
caller passes ``device="cpu"`` (the kernels' plain torch versions).
"""
from __future__ import annotations

from .decoder import PeelResult, peel
from .encoder import Encoder
from .hashing import DEFAULT_KEY
from .symbols import CodedSymbols


class Sketch(Encoder):
    """An Encoder with convenience constructors/decoders."""

    @classmethod
    def from_items(cls, items, nbytes: int, key=DEFAULT_KEY) -> "Sketch":
        s = cls(nbytes, key)
        if len(items):
            s.add_items(items)
        return s

    def decode_against(self, remote: CodedSymbols,
                       device="cuda") -> PeelResult:
        """Peel remote_prefix ⊖ local_prefix (same m) on ``device``."""
        return peel(remote.subtract(self.symbols(remote.m)), self.key,
                    device=device)


def reconcile_sets(a: Sketch, b: Sketch, block: int = 8,
                   max_m: int = 1 << 22, device="cuda"):
    """Run the rateless protocol: A streams windows until B decodes.

    One `Session` on the device backend pulls A's `SymbolStream` with the
    doubling schedule.  Returns (items_only_in_A bytes-array,
    items_only_in_B, symbols_used).
    """
    from repro_torch.protocol import (Exponential, Session, SymbolStream,
                                      run_session)
    session = Session(local=b, pacing=Exponential(block=block, growth=2.0),
                      max_m=max_m, device=device)
    rep = run_session(SymbolStream(a), session)
    return rep.only_remote_bytes(), rep.only_local_bytes(), rep.symbols_used
