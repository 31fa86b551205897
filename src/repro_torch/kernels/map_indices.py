"""Kernel A: per-item keyed hash + mapped-index chain, in CUDA.

Replaces the Pallas kernel ``repro/kernels/map_indices.py::map_indices``.
For each item (a row of L 32-bit words) it computes the SipHash-2-4
checksum under the session key, the mapping-PRNG seed (SipHash under
``map_key(key)``, low bit forced to 1), and the first K skip-sampled mapped
indices, pad = m.  The kernel (``csrc/map_indices.cu`` on the body
``csrc/map_indices.cuh``) gives a block ``bn`` items with G lanes each,
builds their ``(bn, K)`` index tile in shared memory and writes it as one
contiguous span; :func:`launch_shape` picks ``bn`` and G from n and the
card.  The note in the source says what bounds it.  ``m`` is a runtime
argument, so one build serves every prefix length.

On a CPU tensor the wrapper runs the plain torch version
(:func:`repro_torch.kernels.ref.map_indices_ref`); on a CUDA tensor it
launches the kernel or raises.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.core.hashing import map_key

from ._build import (check_launch, count_launch, device_ptr, launcher,
                     stream_of)
from .ref import map_indices_ref

__all__ = ["launch_shape", "map_indices", "map_indices_ref"]

THREADS = 128     # threads a block
FILL = 128        # threads an SM below which an item takes more lanes
MAX_LANES = 4


def launch_shape(n: int, K: int, *, sms: int,
                 smem_optin: int) -> tuple[int, int, int]:
    """The kernel's launch shape for n items of K slots on a card of
    ``sms`` SMs and ``smem_optin`` bytes of shared memory a block:
    ``(bn, lanes, smem)``, items a block, lanes an item and the index
    tile's shared bytes a block.

    Lanes double from 1 while the wave gives fewer than ``FILL`` threads an
    SM, up to ``MAX_LANES``; a block has ``THREADS`` threads, and its items
    halve while their tile exceeds the shared memory.  Raises
    ``ValueError`` where one item's K indices do not fit.
    """
    lanes = 1
    while lanes < MAX_LANES and n * lanes < FILL * sms:
        lanes *= 2
    bn = THREADS // lanes
    while bn > 1 and 4 * (3 + bn * K) > smem_optin:
        bn //= 2
    smem = 4 * (3 + bn * K)     # 3 words align the tile with the output
    if smem > smem_optin:
        raise ValueError(f"K={K} indices of one item exceed the "
                         f"{smem_optin} bytes of shared memory a block")
    return bn, lanes, smem


@functools.lru_cache(maxsize=None)
def _card(index: int) -> tuple[int, int]:
    props = torch.cuda.get_device_properties(index)
    return props.multi_processor_count, props.shared_memory_per_block_optin


def map_indices(items: torch.Tensor, *, K: int, m: int, nbytes: int, key,
                count: torch.Tensor | None = None):
    """items (n, L) int32 -> (idx (n, K) int32, pad = m; chk (n, 2) int32).

    ``count``, a (1,) int64 tensor beside the items, limits the work to
    the first ``count`` items without a read on the host: the kernel reads
    it on the card and leaves the rows past it unwritten.
    ``map_indices.launches`` counts kernel launches.
    """
    if items.device.type == "cpu":
        return map_indices_ref(items, K=K, m=m, nbytes=nbytes, key=key,
                               count=count)
    n, L = items.shape
    if not 0 <= m < 2 ** 31:
        raise ValueError(f"m={m} outside the int32 index range")
    idx = torch.empty((n, K), dtype=torch.int32, device=items.device)
    chk = torch.empty((n, 2), dtype=torch.int32, device=items.device)
    p_items = device_ptr(items, "items", torch.int32, 2)
    p_count = None if count is None else device_ptr(count, "count",
                                                    torch.int64, 1)
    if n == 0:
        return idx, chk
    sms, optin = _card(items.device.index)
    bn, lanes, smem = launch_shape(n, K, sms=sms, smem_optin=optin)
    mk = map_key(key)
    with torch.cuda.device(items.device):
        rc = launcher("map_indices")(
            p_items, n, L, nbytes, K, m, key[0], key[1], mk[0], mk[1],
            idx.data_ptr(), chk.data_ptr(), bn, lanes, smem, p_count,
            stream_of(items))
    check_launch("map_indices", rc)
    count_launch(map_indices)
    return idx, chk


map_indices.launches = 0
