"""Carry a parameter tree of the reference (``repro.models``) into the
port.

The reference's parameters are jax arrays; its caller hands them over as
numpy arrays (``np.asarray`` of each leaf).  bfloat16 has no numpy dtype
without ``ml_dtypes``, so bf16 leaves arrive as their raw 16-bit words (a
``uint16`` view), as the checkpoint store carries them; no parameter of
the model is an integer, so every ``uint16`` leaf is read as bf16.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.decoder import resolve_device


def _leaf(a, device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint16:
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(device)


def params_from_numpy(tree, device="cuda", mesh=None, specs=None):
    """Nested dicts / lists / tuples of numpy arrays -> the same tree of
    tensors on ``device`` (tuples become lists, as the port's trees); with
    a ``mesh``, DTensors placed by ``specs`` (the tree ``init`` returns
    beside the parameters)."""
    device = resolve_device(device)

    def walk(x):
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [walk(v) for v in x]
        return _leaf(x, device)

    out = walk(tree)
    if mesh is None:
        return out
    from repro_torch.launch.mesh import distribute
    return distribute(out, specs, mesh)
