"""Shared layers: norms, embeddings, RoPE, gated MLP.

Port of ``repro/models/layers.py``.  Functional style: params are nested
dicts of tensors.  Each ``init_*`` draws from an explicit
``torch.Generator`` and returns the params alone; the reference's
PartitionSpecs wait for the port's device mesh.  Norms and the unembedding
compute in float32, as in the reference.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def _init(gen: torch.Generator, shape, scale=None, dtype=torch.float32):
    """Normal draws times ``scale`` (default 1/sqrt(shape[0])), on the
    generator's device, cast to ``dtype``."""
    scale = scale if scale is not None else 1.0 / np.sqrt(shape[0])
    x = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (x * scale).to(dtype)


# ---------------------------------------------------------------- norms --
def init_rmsnorm(d, dtype, device):
    return torch.ones((d,), dtype=dtype, device=device)


def rmsnorm(x, w, eps=1e-6):
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.float()).to(x.dtype)


def init_layernorm(d, dtype, device):
    return {"w": torch.ones((d,), dtype=dtype, device=device),
            "b": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm(x, p, eps=1e-6):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * p["w"].float() + p["b"].float()).to(x.dtype)


# ----------------------------------------------------------- embeddings --
def init_embed(gen, vocab, d, dtype):
    return _init(gen, (vocab, d), scale=0.02, dtype=dtype)


def embed_lookup(emb, tokens):
    return F.embedding(tokens, emb)


def unembed(x, emb):
    """(B, S, D) x (V, D)^T -> fp32 logits."""
    return x.float() @ emb.float().T


# ----------------------------------------------------------------- RoPE --
def rope_frequencies(d_head, theta):
    return 1.0 / (theta ** (np.arange(0, d_head, 2) / d_head))


@functools.lru_cache(maxsize=None)
def _rope_freqs(d_head, theta, device) -> torch.Tensor:
    """float32 frequencies on ``device``, copied there once."""
    return torch.as_tensor(rope_frequencies(d_head, theta),
                           dtype=torch.float32, device=device)


def apply_rope(x, positions, theta):
    """x: (..., S, H, Dh), positions: (..., S).  The reference's half-split
    layout: the first and second halves of the head dim form the pairs."""
    freqs = _rope_freqs(x.shape[-1], theta, x.device)
    ang = positions[..., :, None].float() * freqs        # (..., S, Dh/2)
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------------ gated MLP --
def init_mlp(gen, d, d_ff, dtype):
    return {"wi": _init(gen, (d, d_ff), dtype=dtype),
            "wg": _init(gen, (d, d_ff), dtype=dtype),
            "wo": _init(gen, (d_ff, d), dtype=dtype)}


def mlp(x, p):
    h = F.silu(x @ p["wi"]) * (x @ p["wg"])
    return h @ p["wo"]
