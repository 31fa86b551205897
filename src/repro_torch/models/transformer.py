"""Model assembly: decoder-only stacks (dense, MoE, RWKV-6, hybrid RG-LRU
with local attention, the VLM backbone) with a uniform facade (init, loss,
prefill, decode_step).

Port of ``repro/models/transformer.py``.  Block kinds are "attn" and
"local" (:mod:`.attention`), "wkv" (:mod:`.rwkv6`, with its channel-mix
FFN) and "rglru" (:mod:`.rglru`); the FFN is dense, or an MoE
(:mod:`.moe`) when ``cfg.n_experts`` is set.  internvl2-76b's vision
frontend is the reference's stub of patch embeddings.  Depth is organized
as the reference's repeated *periods* of ``cfg.block_pattern``: each
kind's parameters are stacked over the period count in
``params["periods"]`` and leftover layers (depth % period) run as the
"tail", so a parameter tree of the reference converts leaf for leaf
(:mod:`.convert`).  The reference scans the periods with ``jax.lax.scan``;
here a Python loop walks them, each stacked leaf split into its layers
once a forward (:func:`_layers`), so that autograd builds a stacked
leaf's gradient once and not once a layer.  Under autograd with
``cfg.remat`` each period runs under ``torch.utils.checkpoint``, as the
reference wraps it in ``jax.checkpoint``; the loss keeps no decode
states.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint
from torch.utils._pytree import tree_flatten, tree_unflatten

from . import attention as att
from . import moe as moe_mod
from . import rglru as rg
from . import rwkv6 as rwkv
from .layers import (embed_lookup, init_embed, init_mlp, init_rmsnorm, mlp,
                     rmsnorm, unembed)

def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def _index(tree, i):
    """Leaf ``[i]`` of every tensor of a nested dict/list."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_index(v, i) for v in tree]
    return tree[i]


def _layers(tree, n: int) -> list:
    """The n per-layer trees of a tree stacked over n layers: one
    ``unbind`` a leaf, whose backward stacks the layers' gradients once."""
    leaves, spec = tree_flatten(tree)
    split = [t.unbind(0) for t in leaves]
    return [tree_unflatten([s[i] for s in split], spec) for i in range(n)]


def remat(fn, cfg, *args):
    """``fn(*args)``, under ``torch.utils.checkpoint`` when ``cfg.remat``
    is set and autograd records: its activations are recomputed in the
    backward pass instead of kept (the models draw no random numbers, so
    no RNG state is saved)."""
    if cfg.remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return fn(*args)


def _stack_trees(trees):
    """Stack matching nested dicts/lists of tensors along a new axis 0."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack_trees([t[k] for t in trees]) for k in first}
    if isinstance(first, (list, tuple)):
        return [_stack_trees([t[j] for t in trees])
                for j in range(len(first))]
    return torch.stack(trees)


def init_stacked(n: int, make):
    """``_stack_trees([make() for _ in range(n)])`` (the same draws, in
    the same order) holding one unstacked tree at a time, so a stack of
    60 GB of experts needs no second 60 GB."""
    leaves, spec = tree_flatten(make())
    out = [torch.empty((n,) + tuple(t.shape), dtype=t.dtype,
                       device=t.device) for t in leaves]
    for i in range(n):
        if i:
            leaves = tree_flatten(make())[0]
        for o, t in zip(out, leaves):
            o[i] = t
    return tree_unflatten(out, spec)


def shard_aware_ce(logits, labels):
    """Mean cross entropy over the positions whose label is >= 0: the
    value of the reference's ``shard_aware_ce`` (the sharding constraint
    there does not change the value)."""
    lse = torch.logsumexp(logits, dim=-1)
    # a gather, not the reference's one-hot select: no second (B, S, V)
    # tensor, forward or backward; masked positions read id 0, times 0
    gold = logits.gather(-1, labels.clamp(min=0).long()[..., None])[..., 0]
    mask = (labels >= 0).float()
    return ((lse - gold) * mask).sum() / torch.clamp(mask.sum(), min=1.0)


# --------------------------------------------------------------- blocks --
def init_block(gen, kind, cfg, dtype):
    """One sub-block's params: pre-norms + mixer + ffn."""
    p = {"ln1": init_rmsnorm(cfg.d_model, dtype, gen.device)}
    if kind in ("attn", "local"):
        p["attn"] = att.init_attention(gen, cfg, dtype)
    elif kind == "wkv":
        p["attn"] = rwkv.init_rwkv(gen, cfg, dtype)
    elif kind == "rglru":
        p["attn"] = rg.init_rglru(gen, cfg, dtype)
    else:
        raise ValueError(kind)
    p["ln2"] = init_rmsnorm(cfg.d_model, dtype, gen.device)
    if kind == "wkv":
        p["ffn"] = rwkv.init_rwkv_ffn(gen, cfg, dtype)
    elif cfg.n_experts:
        p["ffn"] = moe_mod.init_moe(gen, cfg, dtype)
    else:
        p["ffn"] = init_mlp(gen, cfg.d_model, cfg.d_ff, dtype)
    return p


def block_cache_spec(kind, cfg, B, S_ctx, dtype):
    """Decode-state shapes and dtypes for one sub-block, as meta tensors;
    the recurrent states are float32 where the reference keeps them so."""
    def meta(shp, dt=dtype):
        return torch.empty(shp, dtype=dt, device="meta")

    dh, h = cfg.head_dim, cfg.n_heads
    dr = cfg.d_rnn or cfg.d_model
    if kind in ("attn", "local"):
        w = S_ctx if kind == "attn" else min(cfg.window or S_ctx, S_ctx)
        shp = (B, w, cfg.n_kv_heads, dh)
        return {"k": meta(shp), "v": meta(shp)}
    if kind == "wkv":
        return {"state": meta((B, h, dh, dh), torch.float32),
                "shift_a": meta((B, cfg.d_model)),
                "shift_f": meta((B, cfg.d_model))}
    if kind == "rglru":
        return {"h": meta((B, dr), torch.float32),
                "conv": meta((B, rg.CONV_W - 1, dr))}
    raise ValueError(kind)


def _ffn(h, p, cfg, drops):
    """The dense or MoE FFN: (out, aux_loss)."""
    if cfg.n_experts:
        return moe_mod.moe_ffn(h, p, cfg, drops)
    return mlp(h, p), 0.0


def block_forward(x, p, kind, cfg, drops=None, keep_state=True):
    """Full-sequence pass from zero recurrent state.  Returns (x_out,
    new_state, aux_loss); the state is None unless ``keep_state``.
    ``drops`` goes to an MoE FFN (:func:`.moe.moe_ffn`)."""
    B = x.shape[0]
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    if kind in ("attn", "local"):
        window = cfg.window if kind == "local" else 0
        if keep_state:
            o, ck, cv = att.attention(h, p["attn"], cfg, window=window,
                                      return_kv=True)
            state = {"k": ck, "v": cv}
        else:
            o = att.attention(h, p["attn"], cfg, window=window)
            state = {}
    elif kind == "wkv":
        shift = torch.zeros((B, cfg.d_model), dtype=x.dtype, device=x.device)
        s0 = torch.zeros((B, cfg.n_heads, cfg.head_dim, cfg.head_dim),
                         device=x.device)
        o, shift_out, s_new = rwkv.rwkv_block(h, p["attn"], cfg, shift, s0)
        state = {"state": s_new, "shift_a": shift_out}
    elif kind == "rglru":
        dr = cfg.d_rnn or cfg.d_model
        conv = torch.zeros((B, rg.CONV_W - 1, dr), dtype=x.dtype,
                           device=x.device)
        h0 = torch.zeros((B, dr), device=x.device)
        o, conv, hl = rg.rglru_block(h, p["attn"], cfg, conv, h0)
        state = {"h": hl, "conv": conv}
    else:
        raise ValueError(kind)
    x = x + o
    h = rmsnorm(x, p["ln2"], cfg.norm_eps)
    if kind == "wkv":
        shift = torch.zeros((B, cfg.d_model), dtype=x.dtype, device=x.device)
        o, state["shift_f"] = rwkv.rwkv_ffn(h, p["ffn"], shift)
        aux = 0.0
    else:
        o, aux = _ffn(h, p["ffn"], cfg, drops)
    return x + o, state if keep_state else None, aux


def block_decode(x, p, kind, cfg, cache, pos, drops=None):
    """One-token step.  Returns (x_out, cache); the cache's tensors are
    updated in place."""
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    new = {}
    if kind in ("attn", "local"):
        window = cfg.window if kind == "local" else 0
        o, _, _ = att.attention_decode(h, p["attn"], cfg, cache["k"],
                                       cache["v"], pos, window=window)
    elif kind == "wkv":
        o, new["shift_a"], new["state"] = rwkv.rwkv_decode(
            h, p["attn"], cfg, cache["shift_a"], cache["state"])
    elif kind == "rglru":
        o, new["conv"], new["h"] = rg.rglru_decode(
            h, p["attn"], cfg, cache["conv"], cache["h"])
    else:
        raise ValueError(kind)
    x = x + o
    h = rmsnorm(x, p["ln2"], cfg.norm_eps)
    if kind == "wkv":
        o, new["shift_f"] = rwkv.rwkv_ffn(h, p["ffn"], cache["shift_f"])
    else:
        o, _ = _ffn(h, p["ffn"], cfg, drops)
    for k, v in new.items():
        cache[k].copy_(v)
    return x + o, cache


# ---------------------------------------------------------------- model --
class Model:
    """Decoder-only language model (dense, MoE, RWKV-6, hybrid, VLM
    backbone).

    ``device`` is where :meth:`init` puts the parameters and where the
    model expects its inputs.  ``moe_drops``, if set to a list, gets each
    EP MoE call's dropped (token, expert) pair count appended as a 0-dim
    device tensor, in call order (48 a forward of Qwen3-30B-A3B), once a
    call also where ``cfg.remat`` recomputes it.
    """

    def __init__(self, cfg, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        pattern = cfg.pattern()
        period = len(cfg.block_pattern)
        self.n_periods = len(pattern) // period
        self.period_kinds = list(cfg.block_pattern)
        self.tail_kinds = pattern[self.n_periods * period:]
        self.moe_drops = None

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
            init_stacked(self.n_periods,
                         lambda kind=kind: init_block(gen, kind, cfg, dtype))
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

    def _period(self, x, layers, keep_states):
        """One period of blocks: (x, their states, aux summed, the MoE
        calls' dropped-pair counts).  The counts are returned, not
        appended, so a recomputation under remat (whose outputs are
        dropped) counts nothing."""
        cfg = self.cfg
        drops = [] if self.moe_drops is not None else None
        states, aux = [], 0.0
        for kind, p in zip(self.period_kinds, layers):
            x, st, a = block_forward(x, p, kind, cfg, drops, keep_states)
            states.append(st)
            aux = aux + a
        return x, states, aux, drops

    def _stack(self, params, x, keep_states=True):
        """The blocks and the final norm.  Returns (x, states, aux): each
        kind's decode state stacked over the periods and the tail's (None
        unless ``keep_states``), and the MoE load-balance loss summed over
        the layers (0.0 without experts)."""
        cfg = self.cfg
        per_layer = [_layers(p, self.n_periods) for p in params["periods"]]
        per_period, aux_total = [], 0.0
        for i in range(self.n_periods):
            x, states, aux, drops = remat(
                self._period, cfg, x, [p[i] for p in per_layer],
                keep_states)
            if drops is not None:
                self.moe_drops.extend(drops)
            per_period.append(states)
            aux_total = aux_total + aux
        tail = []
        for i, kind in enumerate(self.tail_kinds):
            x, st, a = block_forward(x, params["tail"][i], kind, cfg,
                                     self.moe_drops, keep_states)
            tail.append(st)
            aux_total = aux_total + a
        x = rmsnorm(x, params["ln_f"], cfg.norm_eps)
        if not keep_states:
            return x, None, aux_total
        periods = [_stack_trees([s[j] for s in per_period])
                   for j in range(len(self.period_kinds))] \
            if per_period else []
        return x, {"periods": periods, "tail": tail}, aux_total

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
        x, _, aux = self._stack(params, x, keep_states=False)
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
        attention block's K/V cache over the prompt (a rolling buffer of the
        last ``window`` positions for "local" blocks), each recurrent
        block's state after the prompt."""
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
                                    pos, self.moe_drops)
        for i, kind in enumerate(self.tail_kinds):
            x, _ = block_decode(x, params["tail"][i], kind, cfg,
                                caches["tail"][i], pos, self.moe_drops)
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
