"""Encoder–decoder assembly (whisper-family).

Port of ``repro/models/encdec.py``.  The audio frontend is the
reference's stub: the model takes precomputed frame embeddings
(B, frames, d_model).  Encoder blocks are bidirectional; decoder blocks
are causal self-attention + cross-attention + MLP, with the zoo's
RMSNorm + RoPE.  Layers are stacked over depth in ``params["enc"]`` and
``params["dec"]``; a Python loop walks them where the reference scans,
each stacked leaf split once a forward (``transformer._layers``).  Under
autograd with ``cfg.remat`` each encoder and decoder block runs under
``torch.utils.checkpoint``, as the reference wraps each in
``jax.checkpoint``; the loss keeps no decode caches.
"""
from __future__ import annotations

import torch

from . import attention as att
from .layers import embed_lookup, init_embed, init_mlp, init_rmsnorm, mlp, \
    rmsnorm, unembed
from .transformer import _dtype, _index, _layers, _stack_trees, \
    init_stacked, remat, shard_aware_ce


def _init_enc_block(gen, cfg, dtype):
    return {"ln1": init_rmsnorm(cfg.d_model, dtype, gen.device),
            "attn": att.init_attention(gen, cfg, dtype),
            "ln2": init_rmsnorm(cfg.d_model, dtype, gen.device),
            "ffn": init_mlp(gen, cfg.d_model, cfg.d_ff, dtype)}


def _init_dec_block(gen, cfg, dtype):
    p = _init_enc_block(gen, cfg, dtype)
    p["ln_c"] = init_rmsnorm(cfg.d_model, dtype, gen.device)
    p["cross"] = att.init_cross_attention(gen, cfg, dtype)
    return p


def _enc_block(x, p, cfg):
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    B, S, _ = h.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    q, k, v = att._qkv(h, p["attn"], cfg, positions)
    o = att._sdpa(q, k, v)                       # bidirectional
    x = x + o.reshape(B, S, -1) @ p["attn"]["wo"]
    h = rmsnorm(x, p["ln2"], cfg.norm_eps)
    return x + mlp(h, p["ffn"])


def _dec_block(x, p, cfg, enc_kv, keep_cache=True):
    """(x_out, the self-attention K/V, or None unless ``keep_cache``)."""
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    if keep_cache:
        o, ck, cv = att.attention(h, p["attn"], cfg, return_kv=True)
    else:
        o = att.attention(h, p["attn"], cfg)
    x = x + o
    h = rmsnorm(x, p["ln_c"], cfg.norm_eps)
    x = x + att.cross_attention(h, p["cross"], cfg, *enc_kv)
    h = rmsnorm(x, p["ln2"], cfg.norm_eps)
    return x + mlp(h, p["ffn"]), {"k": ck, "v": cv} if keep_cache else None


def _dec_block_step(x, p, cfg, cache, pos):
    """One-token step; the cache's self-attention K/V are written in
    place."""
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    o, _, _ = att.attention_decode(h, p["attn"], cfg, cache["k"],
                                   cache["v"], pos)
    x = x + o
    h = rmsnorm(x, p["ln_c"], cfg.norm_eps)
    x = x + att.cross_attention(h, p["cross"], cfg, cache["xk"], cache["xv"])
    h = rmsnorm(x, p["ln2"], cfg.norm_eps)
    return x + mlp(h, p["ffn"])


class EncDecModel:
    """Whisper-style: stub audio frames -> encoder -> causal decoder.
    ``device`` as in :class:`.transformer.Model`."""

    def __init__(self, cfg, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)

    def _mask(self, lg):
        if self.cfg.padded_vocab != self.cfg.vocab:
            return torch.where(
                torch.arange(lg.shape[-1], device=lg.device) < self.cfg.vocab,
                lg, -1e30)
        return lg

    def init(self, gen: torch.Generator):
        """Random parameters in the reference's tree layout, drawn from
        ``gen`` (a generator on ``self.device``)."""
        cfg = self.cfg
        dtype = _dtype(cfg.dtype)
        return {
            "embed": init_embed(gen, cfg.padded_vocab, cfg.d_model, dtype),
            "ln_f": init_rmsnorm(cfg.d_model, dtype, gen.device),
            "enc": init_stacked(cfg.encoder_layers or cfg.n_layers,
                                lambda: _init_enc_block(gen, cfg, dtype)),
            "dec": init_stacked(cfg.n_layers,
                                lambda: _init_dec_block(gen, cfg, dtype))}

    def encode(self, params, frames):
        x = frames.to(_dtype(self.cfg.dtype))
        for lp in _layers(params["enc"], params["enc"]["ln1"].shape[0]):
            x = remat(_enc_block, self.cfg, x, lp, self.cfg)
        return x

    def _dec_stack(self, params, x, enc_out, keep_caches=True):
        """The decoder and the final norm.  Returns (x, caches): per layer
        the self-attention K/V over the tokens and the cross-attention K/V
        of ``enc_out``, stacked over the layers (None unless
        ``keep_caches``)."""
        cfg = self.cfg
        caches = []
        for lp in _layers(params["dec"], cfg.n_layers):
            kv = att.encode_kv(enc_out, lp["cross"], cfg)
            x, cache = remat(_dec_block, cfg, x, lp, cfg, kv, keep_caches)
            if keep_caches:
                caches.append(dict(cache, xk=kv[0], xv=kv[1]))
        x = rmsnorm(x, params["ln_f"], cfg.norm_eps)
        return x, _stack_trees(caches) if keep_caches else None

    def loss(self, params, batch):
        enc_out = self.encode(params, batch["frames"])
        x = embed_lookup(params["embed"], batch["tokens"])
        x, _ = self._dec_stack(params, x, enc_out, keep_caches=False)
        logits = self._mask(unembed(x, params["embed"]))
        ce = shard_aware_ce(logits, batch["labels"])
        return ce, {"ce": ce, "aux": 0.0}

    def prefill(self, params, batch):
        enc_out = self.encode(params, batch["frames"])
        x = embed_lookup(params["embed"], batch["tokens"])
        x, caches = self._dec_stack(params, x, enc_out)
        return self._mask(unembed(x[:, -1:], params["embed"])), caches

    def decode_step(self, params, tokens, caches, pos):
        """tokens (B,1), pos (B,) -> (logits (B,1,V), caches).  The caches'
        self-attention K/V are updated in place and returned."""
        x = embed_lookup(params["embed"], tokens)
        for i in range(self.cfg.n_layers):
            x = _dec_block_step(x, _index(params["dec"], i), self.cfg,
                                _index(caches, i), pos)
        x = rmsnorm(x, params["ln_f"], self.cfg.norm_eps)
        return self._mask(unembed(x, params["embed"])), caches

    def cache_spec(self, B, S_ctx):
        """The decode caches' shapes and dtypes as meta tensors: self- and
        cross-attention K/V, stacked over the decoder's layers."""
        cfg = self.cfg
        L, F, kv, dh = cfg.n_layers, cfg.encoder_frames, cfg.n_kv_heads, \
            cfg.head_dim

        def meta(*shp):
            return torch.empty((L,) + shp, dtype=_dtype(cfg.dtype),
                               device="meta")

        return {"k": meta(B, S_ctx, kv, dh), "v": meta(B, S_ctx, kv, dh),
                "xk": meta(B, F, kv, dh), "xv": meta(B, F, kv, dh)}
