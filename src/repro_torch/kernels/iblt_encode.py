"""Kernel D: the encoder's coded-symbol accumulation, in CUDA.

Replaces the Pallas kernel ``repro/kernels/iblt_encode.py::iblt_encode``.
Given each item's mapped-index chain (kernel A, :mod:`.map_indices`), every
symbol ``j < m`` gets the XOR of the items and checksums mapped there and
their count.  The kernel (``csrc/iblt_encode.cu``) is the scatter body of
``csrc/scatter.cuh`` with weight +1, the body kernel C's ``iblt_apply``
shares: a warp per item with a lane per word, and the hot first rows —
every item maps to symbol 0 — in shared memory; the note there says what
bounds it.

On a CPU tensor the wrapper runs the plain torch version
(:func:`repro_torch.kernels.ref.iblt_encode_ref`); on a CUDA tensor it
launches the kernel or raises.
"""
from __future__ import annotations

import torch

from ._build import (check_launch, count_launch, device_ptr, launcher,
                     stream_of)
from .ref import iblt_encode_ref

__all__ = ["iblt_encode", "iblt_encode_ref"]


def iblt_encode(items: torch.Tensor, idxs: torch.Tensor, chks: torch.Tensor,
                *, m: int):
    """items (n, L), idxs (n, K) (pad = m), chks (n, 2), all int32 ->
    (sums (m, L), checks (m, 2), counts (m, 1)), all int32.  Only slots
    with ``0 <= idx < m`` count.  ``iblt_encode.launches`` counts kernel
    launches."""
    if items.device.type == "cpu":
        return iblt_encode_ref(items, idxs, chks, m=m)
    if not 0 <= m < 2 ** 31:
        raise ValueError(f"m={m} outside the int32 index range")
    n, L = items.shape
    K = idxs.shape[1]
    p_items = device_ptr(items, "items", torch.int32, 2)
    p_idxs = device_ptr(idxs, "idxs", torch.int32, 2)
    p_chks = device_ptr(chks, "chks", torch.int32, 2)
    if idxs.shape[0] != n or chks.shape != (n, 2):
        raise ValueError("items, idxs and chks disagree on n")
    dev = items.device
    sums = torch.zeros((m, L), dtype=torch.int32, device=dev)
    checks = torch.zeros((m, 2), dtype=torch.int32, device=dev)
    counts = torch.zeros((m, 1), dtype=torch.int32, device=dev)
    if n * K * m == 0:
        return sums, checks, counts
    with torch.cuda.device(dev):
        rc = launcher("iblt_encode")(
            p_items, p_idxs, p_chks, n, K, L, m, sums.data_ptr(),
            checks.data_ptr(), counts.data_ptr(), stream_of(items))
    check_launch("iblt_encode", rc)
    count_launch(iblt_encode)
    return sums, checks, counts


iblt_encode.launches = 0
