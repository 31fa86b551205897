"""GQA attention: global/local (sliding window), causal train/prefill paths
and a KV-cache decode step; optional qk-norm; cross-attention for enc-dec.

Port of ``repro/models/attention.py``.  The reference computes attention
in plain jnp (``_sdpa``, and the blockwise ``_sdpa_flash`` above 512
positions), outside any Pallas kernel; here every attention is one
``torch.nn.functional.scaled_dot_product_attention`` call.  GQA keeps the
reference's grouping: query head h reads KV head h // n_rep, n_rep =
n_heads / n_kv_heads.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import _init, apply_rope, init_rmsnorm, rmsnorm

NEG_INF = -1e30


def init_attention(gen, cfg, dtype):
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {"wq": _init(gen, (d, h * dh), dtype=dtype),
         "wk": _init(gen, (d, kv * dh), dtype=dtype),
         "wv": _init(gen, (d, kv * dh), dtype=dtype),
         "wo": _init(gen, (h * dh, d), dtype=dtype)}
    if cfg.qk_norm:
        p["q_norm"] = init_rmsnorm(dh, dtype, gen.device)
        p["k_norm"] = init_rmsnorm(dh, dtype, gen.device)
    return p


def _qkv(x, p, cfg, positions):
    B, S, _ = x.shape
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ p["wq"]).reshape(B, S, h, dh)
    k = (x @ p["wk"]).reshape(B, S, kv, dh)
    v = (x @ p["wv"]).reshape(B, S, kv, dh)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _sdpa(q, k, v, mask=None, causal: bool = False):
    """q: (B,S,H,Dh), k/v: (B,T,KV,Dh) -> (B,S,H,Dh).  ``mask`` is a bool
    (S, T) or (B, S, T) tensor, True where a query may attend.  Query head
    h reads KV head h // (H / KV), the reference's grouping."""
    if mask is not None and mask.dim() == 3:
        mask = mask[:, None]
    out = F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=mask, is_causal=causal, enable_gqa=q.shape[2] > k.shape[2])
    return out.transpose(1, 2)


def _allowed(S, T, window: int = 0, offset: int = 0, device=None):
    """(S, T) bool: query offset+i may see key j."""
    qpos = torch.arange(S, device=device) + offset
    kpos = torch.arange(T, device=device)
    ok = kpos[None, :] <= qpos[:, None]
    if window:
        ok &= kpos[None, :] > qpos[:, None] - window
    return ok


def causal_mask(S, T, window: int = 0, offset: int = 0, device=None):
    """(S, T) additive fp32 mask; rows are query positions
    offset..offset+S-1."""
    ok = _allowed(S, T, window, offset, device)
    return torch.where(ok, 0.0, NEG_INF).to(torch.float32)


def attention(x, p, cfg, window: int = 0, return_kv: bool = False):
    """Causal self-attention over a full sequence (train / prefill).

    With return_kv, also returns the decode cache: full (B,S,KV,Dh) for
    global blocks; for windowed blocks a rolling buffer of the last
    `window` positions placed at slot = position % window.
    """
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    q, k, v = _qkv(x, p, cfg, positions)
    if window and window < S:
        out = _sdpa(q, k, v, _allowed(S, S, window, device=x.device))
    else:
        out = _sdpa(q, k, v, causal=True)
    y = out.reshape(B, S, -1) @ p["wo"]
    if not return_kv:
        return y
    if window and window < S:
        ck = torch.roll(k[:, -window:], shifts=S % window, dims=1)
        cv = torch.roll(v[:, -window:], shifts=S % window, dims=1)
    else:
        ck, cv = k, v
    return y, ck, cv


def attention_decode(x, p, cfg, cache_k, cache_v, pos, window: int = 0):
    """One-token decode against a KV cache.

    x: (B, 1, D); cache_k/v: (B, S_max, KV, Dh) — for windowed blocks the
    cache is a rolling buffer of size `window` written at pos % window.
    pos: (B,) current absolute position.  The new key and value are
    written into the caches in place; returns (out (B,1,D), cache_k,
    cache_v).
    """
    B = x.shape[0]
    S_max = cache_k.shape[1]
    q, k, v = _qkv(x, p, cfg, pos[:, None])
    slot = pos % S_max if window else pos            # (B,)
    bidx = torch.arange(B, device=x.device)
    cache_k[bidx, slot] = k[:, 0]
    cache_v[bidx, slot] = v[:, 0]
    kpos = torch.arange(S_max, device=x.device)[None, :]
    if window:
        # rolling buffer: slot j holds position pos - ((pos - j) mod S_max)
        age = (pos[:, None] - kpos) % S_max
        ok = age < torch.clamp(pos[:, None] + 1, max=window)
    else:
        ok = kpos <= pos[:, None]
    out = _sdpa(q, cache_k, cache_v, ok[:, None, :])
    return out.reshape(B, 1, -1) @ p["wo"], cache_k, cache_v


# -------------------------------------------------------- cross-attention
def init_cross_attention(gen, cfg, dtype):
    return init_attention(gen, cfg, dtype)


def cross_attention(x, p, cfg, enc_k, enc_v):
    """x: (B, S, D) queries; enc_k/v precomputed (B, T, KV, Dh)."""
    B, S, _ = x.shape
    h, dh = cfg.n_heads, cfg.head_dim
    q = (x @ p["wq"]).reshape(B, S, h, dh)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
    out = _sdpa(q, enc_k, enc_v)
    return out.reshape(B, S, -1) @ p["wo"]


def encode_kv(enc_out, p, cfg):
    """Precompute cross-attention K/V from encoder output."""
    B, T, _ = enc_out.shape
    kv, dh = cfg.n_kv_heads, cfg.head_dim
    k = (enc_out @ p["wk"]).reshape(B, T, kv, dh)
    v = (enc_out @ p["wv"]).reshape(B, T, kv, dh)
    if cfg.qk_norm:
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    return k, v
