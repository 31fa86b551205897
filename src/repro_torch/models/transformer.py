"""Model assembly: the decoder-only stack for attention-family blocks with
a uniform facade (init, loss, prefill, decode_step).

Port of ``repro/models/transformer.py`` for the "attn" and "local" block
kinds with a dense FFN: yi-9b, qwen3-4b, starcoder2-3b, mistral-large-123b
and internvl2-76b's backbone (its vision frontend is the reference's stub
of patch embeddings).  Depth is organized as the reference's repeated
*periods* of ``cfg.block_pattern``: each kind's parameters are stacked
over the period count in ``params["periods"]`` and leftover layers
(depth % period) run as the "tail", so a parameter tree of the reference
converts leaf for leaf (:mod:`.convert`).  The reference scans the
periods with ``jax.lax.scan``; here a Python loop walks them.
"""
from __future__ import annotations

import torch

from . import attention as att
from .layers import (embed_lookup, init_embed, init_mlp, init_rmsnorm, mlp,
                     rmsnorm, unembed)

NOT_PORTED = {
    "wkv": "RWKV-6 blocks (ROADMAP queue 1, item 3.4, models/rwkv6.py)",
    "rglru": "RG-LRU blocks (ROADMAP queue 1, item 3.5, models/rglru.py)",
    "moe": "MoE FFNs (ROADMAP queue 1, item 3.3, models/moe.py)",
}


def _refuse(what: str):
    raise NotImplementedError(f"{NOT_PORTED[what]} are not ported yet")


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def _index(tree, i):
    """Leaf ``[i]`` of every tensor of a nested dict/list."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_index(v, i) for v in tree]
    return tree[i]


def _stack_trees(trees):
    """Stack matching nested dicts/lists of tensors along a new axis 0."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack_trees([t[k] for t in trees]) for k in first}
    if isinstance(first, (list, tuple)):
        return [_stack_trees([t[j] for t in trees])
                for j in range(len(first))]
    return torch.stack(trees)


def shard_aware_ce(logits, labels):
    """Mean cross entropy over the positions whose label is >= 0: the
    value of the reference's ``shard_aware_ce`` (the sharding constraint
    there does not change the value)."""
    lse = torch.logsumexp(logits, dim=-1)
    sel = torch.arange(logits.shape[-1], device=logits.device) == \
        labels[..., None]
    gold = torch.where(sel, logits, 0.0).sum(dim=-1)
    mask = (labels >= 0).float()
    return ((lse - gold) * mask).sum() / torch.clamp(mask.sum(), min=1.0)


# --------------------------------------------------------------- blocks --
def _check_kind(kind, cfg):
    if kind in NOT_PORTED:
        _refuse(kind)
    if kind not in ("attn", "local"):
        raise ValueError(kind)
    if cfg.n_experts:
        _refuse("moe")


def init_block(gen, kind, cfg, dtype):
    """One sub-block's params: pre-norms + mixer + ffn."""
    _check_kind(kind, cfg)
    p = {"ln1": init_rmsnorm(cfg.d_model, dtype, gen.device),
         "attn": att.init_attention(gen, cfg, dtype),
         "ln2": init_rmsnorm(cfg.d_model, dtype, gen.device),
         "ffn": init_mlp(gen, cfg.d_model, cfg.d_ff, dtype)}
    return p


def block_cache_spec(kind, cfg, B, S_ctx, dtype):
    """Decode-state shapes and dtypes for one sub-block, as meta
    tensors."""
    _check_kind(kind, cfg)
    w = S_ctx if kind == "attn" else min(cfg.window or S_ctx, S_ctx)
    shp = (B, w, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.empty(shp, dtype=dtype, device="meta"),
            "v": torch.empty(shp, dtype=dtype, device="meta")}


def block_forward(x, p, kind, cfg):
    """Full-sequence pass.  Returns (x_out, new_state, aux_loss)."""
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    window = cfg.window if kind == "local" else 0
    o, ck, cv = att.attention(h, p["attn"], cfg, window=window,
                              return_kv=True)
    x = x + o
    h = rmsnorm(x, p["ln2"], cfg.norm_eps)
    return x + mlp(h, p["ffn"]), {"k": ck, "v": cv}, 0.0


def block_decode(x, p, kind, cfg, cache, pos):
    """One-token step.  Returns (x_out, new_cache); the cache's tensors
    are updated in place."""
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    window = cfg.window if kind == "local" else 0
    o, ck, cv = att.attention_decode(h, p["attn"], cfg, cache["k"],
                                     cache["v"], pos, window=window)
    x = x + o
    h = rmsnorm(x, p["ln2"], cfg.norm_eps)
    return x + mlp(h, p["ffn"]), dict(cache, k=ck, v=cv)


# ---------------------------------------------------------------- model --
class Model:
    """Decoder-only language model of attention-family blocks.

    ``device`` is where :meth:`init` puts the parameters and where the
    model expects its inputs.  Block kinds and FFNs that are not ported
    yet raise ``NotImplementedError`` at construction.
    """

    def __init__(self, cfg, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        pattern = cfg.pattern()
        period = len(cfg.block_pattern)
        self.n_periods = len(pattern) // period
        self.period_kinds = list(cfg.block_pattern)
        self.tail_kinds = pattern[self.n_periods * period:]
        for kind in dict.fromkeys(pattern):
            _check_kind(kind, cfg)

    # -- params ----------------------------------------------------------
    def init(self, gen: torch.Generator):
        """Random parameters in the reference's tree layout, drawn from
        ``gen`` (a generator on ``self.device``)."""
        cfg = self.cfg
        dtype = _dtype(cfg.dtype)
        p = {"embed": init_embed(gen, cfg.padded_vocab, cfg.d_model, dtype)}
        if not cfg.tie_embeddings:
            p["unembed"] = init_embed(gen, cfg.padded_vocab, cfg.d_model,
                                      dtype)
        p["ln_f"] = init_rmsnorm(cfg.d_model, dtype, gen.device)
        p["periods"] = [
            _stack_trees([init_block(gen, kind, cfg, dtype)
                          for _ in range(self.n_periods)])
            for kind in self.period_kinds] if self.n_periods else \
            [{} for _ in self.period_kinds]
        p["tail"] = [init_block(gen, kind, cfg, dtype)
                     for kind in self.tail_kinds]
        return p

    # -- forward ---------------------------------------------------------
    def _embed_inputs(self, params, batch):
        x = embed_lookup(params["embed"], batch["tokens"])
        if self.cfg.frontend == "vision_stub" and "patches" in batch:
            x = torch.cat([batch["patches"].to(x.dtype), x], dim=1)
        return x

    def _stack(self, params, x):
        """The blocks and the final norm.  Returns (x, states, aux): each
        kind's decode state stacked over the periods, and the tail's."""
        cfg = self.cfg
        per_period = []
        for i in range(self.n_periods):
            states = []
            for j, kind in enumerate(self.period_kinds):
                x, st, _ = block_forward(x, _index(params["periods"][j], i),
                                         kind, cfg)
                states.append(st)
            per_period.append(states)
        periods = [_stack_trees([s[j] for s in per_period])
                   for j in range(len(self.period_kinds))] \
            if per_period else []
        tail = []
        for i, kind in enumerate(self.tail_kinds):
            x, st, _ = block_forward(x, params["tail"][i], kind, cfg)
            tail.append(st)
        x = rmsnorm(x, params["ln_f"], cfg.norm_eps)
        return x, {"periods": periods, "tail": tail}, 0.0

    def logits(self, params, x):
        emb = params["embed"] if self.cfg.tie_embeddings else params["unembed"]
        lg = unembed(x, emb)
        if self.cfg.padded_vocab != self.cfg.vocab:  # mask padding rows
            lg = torch.where(
                torch.arange(lg.shape[-1], device=lg.device) < self.cfg.vocab,
                lg, -1e30)
        return lg

    # -- public API --------------------------------------------------------
    def loss(self, params, batch):
        """Causal LM loss.  labels < 0 are masked."""
        x = self._embed_inputs(params, batch)
        x, _, aux = self._stack(params, x)
        labels = batch["labels"]
        if self.cfg.frontend == "vision_stub" and "patches" in batch:
            npz = batch["patches"].shape[1]
            pad = torch.full((labels.shape[0], npz), -1, dtype=labels.dtype,
                             device=labels.device)
            labels = torch.cat([pad, labels], dim=1)
        ce = shard_aware_ce(self.logits(params, x), labels)
        return ce + 0.01 * aux, {"ce": ce, "aux": aux}

    def prefill(self, params, batch):
        """Full forward; returns (last-position logits, decode states): each
        block's K/V cache over the prompt (a rolling buffer of the last
        ``window`` positions for "local" blocks)."""
        x = self._embed_inputs(params, batch)
        x, states, _ = self._stack(params, x)
        return self.logits(params, x[:, -1:]), states

    def decode_step(self, params, tokens, caches, pos):
        """tokens (B,1), pos (B,) -> (logits (B,1,V), caches).  The caches'
        tensors are updated in place and returned."""
        cfg = self.cfg
        x = embed_lookup(params["embed"], tokens)
        for i in range(self.n_periods):
            for j, kind in enumerate(self.period_kinds):
                x, _ = block_decode(x, _index(params["periods"][j], i), kind,
                                    cfg, _index(caches["periods"][j], i),
                                    pos)
        for i, kind in enumerate(self.tail_kinds):
            x, _ = block_decode(x, params["tail"][i], kind, cfg,
                                caches["tail"][i], pos)
        x = rmsnorm(x, params["ln_f"], cfg.norm_eps)
        return self.logits(params, x), caches

    # -- specs -------------------------------------------------------------
    def cache_spec(self, B, S_ctx):
        """The decode caches' shapes and dtypes as meta tensors, in the
        tree :meth:`decode_step` takes (each kind's stacked over the
        periods)."""
        dtype = _dtype(self.cfg.dtype)

        def stacked(sd):
            return {k: torch.empty((self.n_periods,) + tuple(t.shape),
                                   dtype=t.dtype, device="meta")
                    for k, t in sd.items()}

        return {"periods": [stacked(block_cache_spec(k, self.cfg, B, S_ctx,
                                                     dtype))
                            for k in self.period_kinds],
                "tail": [block_cache_spec(k, self.cfg, B, S_ctx, dtype)
                         for k in self.tail_kinds]}
