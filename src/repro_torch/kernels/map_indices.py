"""Kernel A: per-item keyed hash + mapped-index chain, in CUDA.

Replaces the Pallas kernel ``repro/kernels/map_indices.py::map_indices``.
For each item (a row of L 32-bit words) it computes the SipHash-2-4
checksum under the session key, the mapping-PRNG seed (SipHash under
``map_key(key)``, low bit forced to 1), and the first K skip-sampled mapped
indices, pad = m.  The kernel (``csrc/map_indices.cu``) runs one thread per
item with native u64 SipHash; the note there says what bounds it and what
its design does about that.  ``m`` is a runtime argument, so one build
serves every prefix length.

On a CPU tensor the wrapper runs the plain torch version
(:func:`repro_torch.kernels.ref.map_indices_ref`); on a CUDA tensor it
launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.core.hashing import map_key

from ._build import check_launch, device_ptr, launcher, stream_of
from .ref import map_indices_ref

__all__ = ["map_indices", "map_indices_ref"]


def map_indices(items: torch.Tensor, *, K: int, m: int, nbytes: int, key):
    """items (n, L) int32 -> (idx (n, K) int32, pad = m; chk (n, 2) int32).

    ``map_indices.launches`` counts kernel launches.
    """
    if items.device.type == "cpu":
        return map_indices_ref(items, K=K, m=m, nbytes=nbytes, key=key)
    n, L = items.shape
    if not 0 <= m < 2 ** 31:
        raise ValueError(f"m={m} outside the int32 index range")
    idx = torch.empty((n, K), dtype=torch.int32, device=items.device)
    chk = torch.empty((n, 2), dtype=torch.int32, device=items.device)
    p_items = device_ptr(items, "items", torch.int32, 2)
    if n == 0:
        return idx, chk
    mk = map_key(key)
    with torch.cuda.device(items.device):
        rc = launcher("map_indices")(
            p_items, n, L, nbytes, K, m, key[0], key[1], mk[0], mk[1],
            idx.data_ptr(), chk.data_ptr(), stream_of(items))
    check_launch("map_indices", rc)
    map_indices.launches += 1
    return idx, chk


map_indices.launches = 0
