"""GQA attention: global/local (sliding window), causal train/prefill paths
and a KV-cache decode step; optional qk-norm; cross-attention for enc-dec.

Port of ``repro/models/attention.py``.  The reference computes attention
in plain jnp (``_sdpa``, and the blockwise ``_sdpa_flash`` above 512
positions), outside any Pallas kernel; here every full-sequence attention
is one ``torch.nn.functional.scaled_dot_product_attention`` call, and a
step against a cache the reference's ``_sdpa`` (float32 scores, softmax,
weights cast to the values' dtype).  GQA keeps the reference's grouping:
query head h reads KV head h // n_rep, n_rep = n_heads / n_kv_heads.

On a mesh (``ma``, see :mod:`.layers`) the projections run through
DTensor; the SDPA call runs under :func:`.layers.shard_map` with the
reference's constraints: batch over the data axes, heads over "model"
only when the KV heads divide over it (else every model rank attends
over all heads, as the reference's ``_sdpa_flash`` does).  KV caches
shard the head dim over "model" (``transformer.block_cache_spec``); where
that splits it over more than one rank, a decode step sums its per-token
score partials over the model ranks, as GSPMD does for the reference,
instead of gathering the cache.  Where it does not (no mesh, or one model
rank), the step is the one SDPA call of the plain path.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .layers import (_init, apply_rope, batch_axes, constrain, group_of,
                     init_rmsnorm, pin, psum, rmsnorm, shard_map)

NEG_INF = -1e30


def init_attention(gen, cfg, dtype, fsdp: bool, model_axis: int = 16):
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    row = "data" if fsdp else None
    kv_shard = "model" if kv % model_axis == 0 else None
    p = {"wq": _init(gen, (d, h * dh), dtype=dtype),
         "wk": _init(gen, (d, kv * dh), dtype=dtype),
         "wv": _init(gen, (d, kv * dh), dtype=dtype),
         "wo": _init(gen, (h * dh, d), dtype=dtype)}
    s = {"wq": (row, "model"), "wk": (row, kv_shard),
         "wv": (row, kv_shard), "wo": ("model", row)}
    if cfg.qk_norm:
        p["q_norm"], s["q_norm"] = init_rmsnorm(dh, dtype, gen.device)
        p["k_norm"], s["k_norm"] = init_rmsnorm(dh, dtype, gen.device)
    return p, s


def _heads(t, n: int, dh: int, ma):
    """(B, S, n·dh) projections as (B, S, n, dh): on a mesh first placed
    with the batch over the data axes and the heads over "model" when n
    divides over it, else replicated there (the reference computes such
    K/V on every model rank)."""
    B, S, _ = t.shape
    if ma is not None:
        t = constrain(t, (batch_axes(ma, B), None,
                          "model" if n % ma["model_size"] == 0 else None),
                      ma)
    return t.reshape(B, S, n, dh)


def _qkv(x, p, cfg, positions, ma=None):
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = _heads(x @ p["wq"], h, dh, ma)
    k = _heads(x @ p["wk"], kv, dh, ma)
    v = _heads(x @ p["wv"], kv, dh, ma)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def heads_spec(ma, B: int, KV: int):
    """The spec of (B, S, heads, Dh) activations around the SDPA call:
    batch over the data axes, heads over "model" when the KV heads divide
    over it."""
    kv_shard = "model" if ma is not None and KV % ma["model_size"] == 0 \
        else None
    return (batch_axes(ma, B), None, kv_shard, None)


def cache_spec_of(ma, B: int, dh: int):
    """The spec of a (B, T, KV, Dh) KV cache: batch over the data axes,
    the head dim over "model" when it divides (the reference's
    ``block_cache_spec``)."""
    dh_shard = "model" if ma is not None and dh % ma["model_size"] == 0 \
        else None
    return (batch_axes(ma, B), None, None, dh_shard)


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


def sdpa(q, k, v, ma=None, mask=None, causal: bool = False):
    """:func:`_sdpa` on the mesh: q (B,S,H,Dh), k/v (B,T,KV,Dh)
    redistributed to :func:`heads_spec`; ``mask`` a plain (S, T) bool
    tensor (the same for every row)."""
    spec = heads_spec(ma, q.shape[0], k.shape[2])
    return shard_map(lambda q_, k_, v_: _sdpa(q_, k_, v_, mask, causal), ma,
                     (spec, spec, spec), (spec,))(q, k, v)


def attention(x, p, cfg, window: int = 0, return_kv: bool = False, ma=None):
    """Causal self-attention over a full sequence (train / prefill).

    With return_kv, also returns the decode cache: full (B,S,KV,Dh) for
    global blocks; for windowed blocks a rolling buffer of the last
    `window` positions placed at slot = position % window (on a mesh,
    placed by :func:`cache_spec_of`).
    """
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)
    q, k, v = _qkv(x, p, cfg, positions, ma)
    spec = heads_spec(ma, B, cfg.n_kv_heads)
    rolled = bool(window and window < S)
    mask = _allowed(S, S, window, device=x.device) if rolled else None

    def local(q_, k_, v_):
        out = _sdpa(q_, k_, v_, mask, causal=not rolled)
        if not return_kv:
            return out
        if rolled:
            return (out, torch.roll(k_[:, -window:], shifts=S % window,
                                    dims=1),
                    torch.roll(v_[:, -window:], shifts=S % window, dims=1))
        return out, k_, v_

    outs = shard_map(local, ma, (spec, spec, spec),
                     (spec,) * (3 if return_kv else 1))(q, k, v)
    y = out_proj(outs[0] if return_kv else outs, p["wo"], ma)
    if not return_kv:
        return y
    cspec = cache_spec_of(ma, B, cfg.head_dim)
    return y, constrain(outs[1], cspec, ma), constrain(outs[2], cspec, ma)


def out_proj(out, wo, ma):
    """The (B, S, H, Dh) attention output through ``wo``.  On a mesh its
    heads go over "model" where they divide (a slice, where the attention
    ran on every model rank), so the projection and its gradient are
    per-shard; where they do not, the flattened output stays whole over
    "model", its gradient too."""
    B, S, H, _ = out.shape
    if ma is None or ma["mesh"] is None:
        return out.reshape(B, S, -1) @ wo
    da = batch_axes(ma, B)
    if H % ma["model_size"] == 0:
        return constrain(out, (da, None, "model"), ma).reshape(B, S, -1) @ wo
    return pin(out.reshape(B, S, -1), (da,), ma) @ wo


def _split_group(ma, spec):
    """The model group when a cache placed by ``spec`` (see
    :func:`cache_spec_of`) has its head dim split over more than one
    rank, else None."""
    group = group_of(ma) if spec[3] else None
    return group if group is not None and group.size() > 1 else None


def _attend_cache(q, k, v, mask, n_rep: int, d_head: int, group):
    """Attention of q (B,S,H,dh) over a cache k/v (B,T,KV,dh) under mask
    (B,S,T) bool (None: every key).  With no ``group`` the head dim is
    whole here: one SDPA call.  Else k/v hold this rank's slice of the
    head dim: the reference's ``_sdpa``, its score partials computed in
    the cache's dtype (no float32 copy of the cache) and summed over the
    group in float32, scaled by the full head width's 1/sqrt(Dh),
    softmax, the weights cast to v's dtype; returns this rank's
    (B,S,H,dh) slice."""
    if group is None:
        return _sdpa(q, k, v, mask)
    B, S, H, dh = q.shape
    KV = k.shape[2]
    qr = q.reshape(B, S, KV, n_rep, dh)
    scores = psum(torch.einsum("bsgrd,btgd->bgrst", qr, k).float(), group)
    scores = scores / float(np.sqrt(d_head))
    if mask is not None:
        scores = scores.masked_fill(~mask[:, None, None], NEG_INF)
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bgrst,btgd->bsgrd", w, v)
    return out.reshape(B, S, H, dh)


def attention_decode(x, p, cfg, cache_k, cache_v, pos, window: int = 0,
                     ma=None):
    """One-token decode against a KV cache.

    x: (B, 1, D); cache_k/v: (B, S_max, KV, Dh) — for windowed blocks the
    cache is a rolling buffer of size `window` written at pos % window.
    pos: (B,) current absolute position.  The new key and value are
    written into the caches in place; returns (out (B,1,D), cache_k,
    cache_v).  On a mesh the caches must already be placed by
    :func:`cache_spec_of` (the write goes into each rank's block).
    """
    B = x.shape[0]
    S_max = cache_k.shape[1]
    q, k, v = _qkv(x, p, cfg, pos[:, None], ma)
    spec = cache_spec_of(ma, B, cfg.head_dim)
    _check_placed(ma, spec, cache_k, cache_v)
    group = _split_group(ma, spec)

    def local(q_, k_, v_, ck, cv, pos_):
        b = q_.shape[0]
        slot = pos_ % S_max if window else pos_                # (b,)
        bidx = torch.arange(b, device=q_.device)
        ck[bidx, slot] = k_[:, 0]
        cv[bidx, slot] = v_[:, 0]
        kpos = torch.arange(S_max, device=q_.device)[None, :]
        if window:
            # rolling buffer: slot j holds position pos - ((pos - j) mod S_max)
            age = (pos_[:, None] - kpos) % S_max
            ok = age < torch.clamp(pos_[:, None] + 1, max=window)
        else:
            ok = kpos <= pos_[:, None]
        return _attend_cache(q_, ck, cv, ok[:, None, :],
                             cfg.n_heads // cfg.n_kv_heads, cfg.head_dim,
                             group)

    out = shard_map(local, ma, (spec,) * 5 + (spec[:1],), (spec,))(
        q, k, v, cache_k, cache_v, pos)
    return out_proj(constrain(out, spec[:3], ma), p["wo"], ma), cache_k, \
        cache_v


def _check_placed(ma, spec, *caches) -> None:
    """Caches written in place must already be placed by ``spec``: a
    redistributed copy would take the write."""
    from torch.distributed.tensor import DTensor
    if ma is None or ma["mesh"] is None:
        return
    from .layers import mesh_placements
    want = tuple(mesh_placements(ma, spec))
    for c in caches:
        if not isinstance(c, DTensor) or tuple(c.placements) != want:
            raise ValueError(f"a cache written in place must be placed as "
                             f"{want}")


# -------------------------------------------------------- cross-attention
def init_cross_attention(gen, cfg, dtype, fsdp: bool, model_axis: int = 16):
    return init_attention(gen, cfg, dtype, fsdp, model_axis)


def cross_attention(x, p, cfg, enc_k, enc_v, ma=None, cached=False):
    """x: (B, S, D) queries; enc_k/v precomputed (B, T, KV, Dh): in the
    projections' layout, or (``cached``) a decode cache placed by
    :func:`cache_spec_of` (see :func:`_attend_cache`)."""
    B = x.shape[0]
    h, dh = cfg.n_heads, cfg.head_dim
    q = _heads(x @ p["wq"], h, dh, ma)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
    if not cached:
        return out_proj(sdpa(q, enc_k, enc_v, ma), p["wo"], ma)
    spec = cache_spec_of(ma, B, dh)
    group = _split_group(ma, spec)

    def local(q_, k_, v_):
        return _attend_cache(q_, k_, v_, None, h // cfg.n_kv_heads, dh,
                             group)

    out = shard_map(local, ma, (spec,) * 3, (spec,))(q, enc_k, enc_v)
    return out_proj(constrain(out, spec[:3], ma), p["wo"], ma)


def encode_kv(enc_out, p, cfg, ma=None):
    """Precompute cross-attention K/V from encoder output."""
    kv, dh = cfg.n_kv_heads, cfg.head_dim
    k = _heads(enc_out @ p["wk"], kv, dh, ma)
    v = _heads(enc_out @ p["wv"], kv, dh, ma)
    if cfg.qk_norm:
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    return k, v
