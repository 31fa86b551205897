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
``jax.checkpoint``; the loss keeps no decode caches.  ``init`` returns
``(params, specs)``; on a mesh (``ma``, see :mod:`.layers`) the model runs
as :mod:`.transformer`'s does, its caches placed by the reference's
``cache_spec`` (batch over the data axes, the head dim over "model").
"""
from __future__ import annotations

import torch

from . import attention as att
from .layers import batch_axes, constrain, embed_lookup, gathered, \
    init_embed, init_mlp, init_rmsnorm, like, mlp, pin, residual, \
    rmsnorm, unembed
from .transformer import _dtype, _index, _layers, _stack_trees, \
    init_stacked, remat, shard_aware_ce


def _init_enc_block(gen, cfg, dtype, fsdp, ma):
    p, s = {}, {}
    p["ln1"], s["ln1"] = init_rmsnorm(cfg.d_model, dtype, gen.device)
    p["attn"], s["attn"] = att.init_attention(gen, cfg, dtype, fsdp, ma)
    p["ln2"], s["ln2"] = init_rmsnorm(cfg.d_model, dtype, gen.device)
    p["ffn"], s["ffn"] = init_mlp(gen, cfg.d_model, cfg.d_ff, dtype, fsdp)
    return p, s


def _init_dec_block(gen, cfg, dtype, fsdp, ma):
    p, s = _init_enc_block(gen, cfg, dtype, fsdp, ma)
    p["ln_c"], s["ln_c"] = init_rmsnorm(cfg.d_model, dtype, gen.device)
    p["cross"], s["cross"] = att.init_cross_attention(gen, cfg, dtype, fsdp,
                                                      ma)
    return p, s


def _enc_block(x, p, cfg, ma=None):
    p = gathered(p, ma)
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    B, S, _ = h.shape
    positions = torch.arange(S, device=x.device)
    q, k, v = att._qkv(h, p["attn"], cfg, positions, ma)
    o = att.out_proj(att.sdpa(q, k, v, ma), p["attn"]["wo"], ma)  # both ways
    x = residual(x, o, ma)
    h = rmsnorm(x, p["ln2"], cfg.norm_eps)
    return residual(x, mlp(h, p["ffn"]), ma)


def _dec_block(x, p, cfg, enc_kv, keep_cache=True, ma=None):
    """(x_out, the self-attention K/V, or None unless ``keep_cache``)."""
    p = gathered(p, ma)
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    if keep_cache:
        o, ck, cv = att.attention(h, p["attn"], cfg, return_kv=True, ma=ma)
    else:
        o = att.attention(h, p["attn"], cfg, ma=ma)
    x = residual(x, o, ma)
    h = rmsnorm(x, p["ln_c"], cfg.norm_eps)
    x = residual(x, att.cross_attention(h, p["cross"], cfg, *enc_kv, ma=ma),
                 ma)
    h = rmsnorm(x, p["ln2"], cfg.norm_eps)
    return residual(x, mlp(h, p["ffn"]), ma), \
        {"k": ck, "v": cv} if keep_cache else None


def _dec_block_step(x, p, cfg, cache, pos, ma=None):
    """One-token step; the cache's self-attention K/V are written in
    place."""
    p = gathered(p, ma)
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    o, _, _ = att.attention_decode(h, p["attn"], cfg, cache["k"],
                                   cache["v"], pos, ma=ma)
    x = residual(x, o, ma)
    h = rmsnorm(x, p["ln_c"], cfg.norm_eps)
    x = residual(x, att.cross_attention(h, p["cross"], cfg, cache["xk"],
                                        cache["xv"], ma=ma, cached=True), ma)
    h = rmsnorm(x, p["ln2"], cfg.norm_eps)
    return residual(x, mlp(h, p["ffn"]), ma)


class EncDecModel:
    """Whisper-style: stub audio frames -> encoder -> causal decoder.
    ``mesh_axes`` and ``device`` as in :class:`.transformer.Model`."""

    def __init__(self, cfg, mesh_axes, device="cuda"):
        self.cfg = cfg
        self.mesh_axes = mesh_axes
        self.device = torch.device(device)

    def _mask(self, lg):
        if self.cfg.padded_vocab != self.cfg.vocab:
            keep = torch.arange(lg.shape[-1], device=lg.device) < \
                self.cfg.vocab
            return torch.where(like(keep, lg), lg, -1e30)
        return lg

    def _logits(self, params, x):
        """The tied unembedding, padded vocab ids masked."""
        return self._mask(unembed(x, gathered(params["embed"],
                                              self.mesh_axes)))

    def _embed(self, params, tokens):
        x = embed_lookup(gathered(params["embed"], self.mesh_axes), tokens)
        return pin(x, (batch_axes(self.mesh_axes, x.shape[0]),),
                   self.mesh_axes)

    def init(self, gen: torch.Generator):
        """(params, specs): random parameters in the reference's tree
        layout, drawn from ``gen`` (a generator on ``self.device``), and
        the reference's specs."""
        cfg = self.cfg
        dtype = _dtype(cfg.dtype)
        ma = self.mesh_axes["model_size"]
        p, s = {}, {}
        p["embed"], s["embed"] = init_embed(gen, cfg.padded_vocab,
                                            cfg.d_model, dtype, cfg.fsdp)
        p["ln_f"], s["ln_f"] = init_rmsnorm(cfg.d_model, dtype, gen.device)
        p["enc"], s["enc"] = init_stacked(
            cfg.encoder_layers or cfg.n_layers,
            lambda: _init_enc_block(gen, cfg, dtype, cfg.fsdp, ma))
        p["dec"], s["dec"] = init_stacked(
            cfg.n_layers,
            lambda: _init_dec_block(gen, cfg, dtype, cfg.fsdp, ma))
        return p, s

    def encode(self, params, frames):
        x = constrain(frames.to(_dtype(self.cfg.dtype)),
                      (batch_axes(self.mesh_axes, frames.shape[0]),),
                      self.mesh_axes)
        for lp in _layers(params["enc"], params["enc"]["ln1"].shape[0]):
            x = remat(_enc_block, self.cfg, x, lp, self.cfg, self.mesh_axes)
        return x

    def _dec_stack(self, params, x, enc_out, keep_caches=True):
        """The decoder and the final norm.  Returns (x, caches): per layer
        the self-attention K/V over the tokens and the cross-attention K/V
        of ``enc_out``, stacked over the layers (None unless
        ``keep_caches``)."""
        cfg = self.cfg
        caches = []
        for lp in _layers(params["dec"], cfg.n_layers):
            kv = att.encode_kv(enc_out, gathered(lp["cross"], self.mesh_axes),
                               cfg, self.mesh_axes)
            x, cache = remat(_dec_block, cfg, x, lp, cfg, kv, keep_caches,
                             self.mesh_axes)
            if keep_caches:
                cspec = att.cache_spec_of(self.mesh_axes, x.shape[0],
                                          cfg.head_dim)
                caches.append(dict(cache, xk=constrain(kv[0], cspec,
                                                       self.mesh_axes),
                                   xv=constrain(kv[1], cspec,
                                                self.mesh_axes)))
        x = rmsnorm(x, params["ln_f"], cfg.norm_eps)
        return x, _stack_trees(caches) if keep_caches else None

    def loss(self, params, batch):
        enc_out = self.encode(params, batch["frames"])
        x = self._embed(params, batch["tokens"])
        x, _ = self._dec_stack(params, x, enc_out, keep_caches=False)
        ce = shard_aware_ce(self._logits(params, x), batch["labels"],
                            self.mesh_axes)
        return ce, {"ce": ce, "aux": 0.0}

    def prefill(self, params, batch):
        enc_out = self.encode(params, batch["frames"])
        x = self._embed(params, batch["tokens"])
        x, caches = self._dec_stack(params, x, enc_out)
        return self._logits(params, x[:, -1:]), caches

    def decode_step(self, params, tokens, caches, pos):
        """tokens (B,1), pos (B,) -> (logits (B,1,V), caches).  The caches'
        self-attention K/V are updated in place and returned."""
        x = self._embed(params, tokens)
        for i in range(self.cfg.n_layers):
            x = _dec_block_step(x, _index(params["dec"], i), self.cfg,
                                _index(caches, i), pos, self.mesh_axes)
        x = rmsnorm(x, params["ln_f"], self.cfg.norm_eps)
        return self._logits(params, x), caches

    def cache_spec(self, B, S_ctx):
        """(the decode caches' shapes and dtypes as meta tensors, their
        specs): self- and cross-attention K/V, stacked over the decoder's
        layers."""
        cfg = self.cfg
        L, F, kv, dh = cfg.n_layers, cfg.encoder_frames, cfg.n_kv_heads, \
            cfg.head_dim
        ma = self.mesh_axes
        da = ma["data"] if B % ma["data_size"] == 0 else None
        spec = (None, da, None, None,
                "model" if dh % ma["model_size"] == 0 else None)

        def meta(*shp):
            return torch.empty((L,) + shp, dtype=_dtype(cfg.dtype),
                               device="meta")

        return ({"k": meta(B, S_ctx, kv, dh), "v": meta(B, S_ctx, kv, dh),
                 "xk": meta(B, F, kv, dh), "xv": meta(B, F, kv, dh)},
                {"k": spec, "v": spec, "xk": spec, "xv": spec})
