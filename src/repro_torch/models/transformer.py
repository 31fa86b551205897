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

``Model.init`` returns ``(params, specs)`` as the reference's does.  On a
device mesh (``build_model(cfg, mesh)``) the parameters are DTensors
placed by those specs (:func:`repro_torch.launch.mesh.distribute`), the
residual stream is constrained as the reference constrains it (batch over
the data axes after the embedding; sequence- or feature-parallel over
"model" between periods, ``_sp_constrain``), and the cross entropy keeps
the float32 logits vocab-sharded (:func:`shard_aware_ce`).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

from repro_torch.launch.mesh import is_spec

from . import attention as att
from . import moe as moe_mod
from . import rglru as rg
from . import rwkv6 as rwkv
from .layers import (batch_axes, constrain, embed_lookup, gathered,
                     init_embed, init_mlp, init_rmsnorm, like,
                     mesh_placements, mlp, on_mesh, pin, residual,
                     rmsnorm, shard_map, unembed)

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
    """``make()`` (params, specs) drawn n times and stacked along a new
    axis 0, the specs with a leading None (the same draws, in the same
    order, as stacking n calls), holding one unstacked tree at a time, so
    a stack of 60 GB of experts needs no second 60 GB."""
    first, specs = make()
    leaves, spec = tree_flatten(first)
    out = [torch.empty((n,) + tuple(t.shape), dtype=t.dtype,
                       device=t.device) for t in leaves]
    for i in range(n):
        if i:
            leaves = tree_flatten(make()[0])[0]
        for o, t in zip(out, leaves):
            o[i] = t
    return tree_unflatten(out, spec), stack_specs(specs)


def stack_specs(specs):
    """Specs of leaves stacked along a new axis 0: a leading None."""
    return tree_map(lambda sp: (None,) + sp, specs, is_leaf=is_spec)


def _ce_parts(lg, lab, offset: int):
    """One vocab shard's part of the cross entropy: lg (b, S, V_loc) the
    logits of vocab ids [offset, offset + V_loc), lab (b, S).  Returns the
    shard's logsumexp (b, S, 1) and the gold logit where the label falls
    in the shard (else 0)."""
    V = lg.shape[-1]
    rel = lab.long() - offset
    inside = (rel >= 0) & (rel < V)
    gold = lg.gather(-1, rel.clamp(0, V - 1)[..., None])[..., 0]
    return torch.logsumexp(lg, dim=-1, keepdim=True), \
        torch.where(inside, gold, 0.0)


def shard_aware_ce(logits, labels, ma=None):
    """Mean cross entropy over the positions whose label is >= 0.

    Without a mesh, a gather of the gold logit (no second (B, S, V)
    tensor, forward or backward; masked positions read id 0, times 0).
    On a mesh the (B, S, V) float32 logits stay on (data, None, "model"),
    as the reference constrains them: each vocab shard's logsumexp and
    gold logit under :func:`.layers.shard_map`, then a logsumexp over the
    model ranks' parts and a sum of the gold parts, (B, S)-sized."""
    if not on_mesh(ma):
        lse = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, labels.clamp(min=0).long()[..., None])[..., 0]
    else:
        da = batch_axes(ma, logits.shape[0])
        V_loc = logits.shape[-1] // ma["model_size"]
        offset = ma["mesh"].get_local_rank("model") * V_loc
        parts, gold = shard_map(
            lambda lg, lab: _ce_parts(lg, lab, offset), ma,
            ((da, None, "model"), (da, None)),
            ((da, None, "model"),
             mesh_placements(ma, (da, None), ("model",))))(logits, labels)
        lse = torch.logsumexp(constrain(parts, (da,), ma), dim=-1)
    mask = (labels >= 0).float()
    return ((lse - gold) * mask).sum() / torch.clamp(mask.sum(), min=1.0)


# --------------------------------------------------------------- blocks --
def init_block(gen, kind, cfg, dtype, fsdp: bool, model_axis: int):
    """One sub-block's params and specs: pre-norms + mixer + ffn."""
    p, s = {}, {}
    p["ln1"], s["ln1"] = init_rmsnorm(cfg.d_model, dtype, gen.device)
    if kind in ("attn", "local"):
        p["attn"], s["attn"] = att.init_attention(gen, cfg, dtype, fsdp,
                                                  model_axis)
    elif kind == "wkv":
        p["attn"], s["attn"] = rwkv.init_rwkv(gen, cfg, dtype, fsdp)
    elif kind == "rglru":
        p["attn"], s["attn"] = rg.init_rglru(gen, cfg, dtype, fsdp)
    else:
        raise ValueError(kind)
    p["ln2"], s["ln2"] = init_rmsnorm(cfg.d_model, dtype, gen.device)
    if kind == "wkv":
        p["ffn"], s["ffn"] = rwkv.init_rwkv_ffn(gen, cfg, dtype, fsdp)
    elif cfg.n_experts:
        p["ffn"], s["ffn"] = moe_mod.init_moe(gen, cfg, dtype, fsdp)
    else:
        p["ffn"], s["ffn"] = init_mlp(gen, cfg.d_model, cfg.d_ff, dtype, fsdp)
    return p, s


def block_cache_spec(kind, cfg, B, S_ctx, dtype, data_axes, model_axis_size):
    """Decode-state shapes and dtypes for one sub-block, as meta tensors,
    and their specs: the recurrent states are float32 where the reference
    keeps them so.  KV caches shard batch over the data axes and the head
    dim over "model" (when it divides: GQA KV-head counts often do not),
    and a decode step sums its per-token score partials over the model
    ranks instead of gathering the cache."""
    def meta(shp, dt=dtype):
        return torch.empty(shp, dtype=dt, device="meta")

    dh, h = cfg.head_dim, cfg.n_heads
    dr = cfg.d_rnn or cfg.d_model
    dh_shard = "model" if dh % model_axis_size == 0 else None
    if kind in ("attn", "local"):
        w = S_ctx if kind == "attn" else min(cfg.window or S_ctx, S_ctx)
        shp = (B, w, cfg.n_kv_heads, dh)
        spec = (data_axes, None, None, dh_shard)
        return {"k": meta(shp), "v": meta(shp)}, {"k": spec, "v": spec}
    if kind == "wkv":
        return ({"state": meta((B, h, dh, dh), torch.float32),
                 "shift_a": meta((B, cfg.d_model)),
                 "shift_f": meta((B, cfg.d_model))},
                {"state": (data_axes, "model", None, None),
                 "shift_a": (data_axes, None), "shift_f": (data_axes, None)})
    if kind == "rglru":
        return ({"h": meta((B, dr), torch.float32),
                 "conv": meta((B, rg.CONV_W - 1, dr))},
                {"h": (data_axes, "model"),
                 "conv": (data_axes, None, "model")})
    raise ValueError(kind)


def _ffn(h, p, cfg, drops, ma):
    """The dense or MoE FFN: (out, aux_loss)."""
    if cfg.n_experts:
        return moe_mod.moe_ffn(h, p, cfg, drops, ma)
    return mlp(h, p), 0.0


def _entry(x, ma):
    """The residual stream placed with the batch over the data axes and
    replicated over "model": between periods it is sequence-parallel
    (``Model._sp_constrain``), and this is the all-gather at block
    entry."""
    return constrain(x, (batch_axes(ma, x.shape[0]),), ma)


def block_forward(x, p, kind, cfg, drops=None, keep_state=True, ma=None):
    """Full-sequence pass from zero recurrent state.  Returns (x_out,
    new_state, aux_loss); the state is None unless ``keep_state``.
    ``drops`` goes to an MoE FFN (:func:`.moe.moe_ffn`); ``ma`` is the
    mesh's axes (None for one device)."""
    B = x.shape[0]
    x, p = _entry(x, ma), gathered(p, ma)
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    if kind in ("attn", "local"):
        window = cfg.window if kind == "local" else 0
        if keep_state:
            o, ck, cv = att.attention(h, p["attn"], cfg, window=window,
                                      return_kv=True, ma=ma)
            state = {"k": ck, "v": cv}
        else:
            o = att.attention(h, p["attn"], cfg, window=window, ma=ma)
            state = {}
    elif kind == "wkv":
        shift = h.new_zeros((B, cfg.d_model))
        s0 = h.new_zeros((B, cfg.n_heads, cfg.head_dim, cfg.head_dim),
                         dtype=torch.float32)
        o, shift_out, s_new = rwkv.rwkv_block(h, p["attn"], cfg, shift, s0,
                                              ma)
        state = {"state": s_new, "shift_a": shift_out}
    elif kind == "rglru":
        dr = cfg.d_rnn or cfg.d_model
        conv = h.new_zeros((B, rg.CONV_W - 1, dr))
        h0 = h.new_zeros((B, dr), dtype=torch.float32)
        o, conv, hl = rg.rglru_block(h, p["attn"], cfg, conv, h0, ma)
        state = {"h": hl, "conv": conv}
    else:
        raise ValueError(kind)
    x = residual(x, o, ma)
    h = rmsnorm(x, p["ln2"], cfg.norm_eps)
    if kind == "wkv":
        o, state["shift_f"] = rwkv.rwkv_ffn(h, p["ffn"], h.new_zeros(
            (B, cfg.d_model)))
        aux = 0.0
    else:
        o, aux = _ffn(h, p["ffn"], cfg, drops, ma)
    return residual(x, o, ma), state if keep_state else None, aux


def block_decode(x, p, kind, cfg, cache, pos, drops=None, ma=None):
    """One-token step.  Returns (x_out, cache); the cache's tensors are
    updated in place."""
    p = gathered(p, ma)
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    new = {}
    if kind in ("attn", "local"):
        window = cfg.window if kind == "local" else 0
        o, _, _ = att.attention_decode(h, p["attn"], cfg, cache["k"],
                                       cache["v"], pos, window=window, ma=ma)
    elif kind == "wkv":
        o, new["shift_a"], new["state"] = rwkv.rwkv_decode(
            h, p["attn"], cfg, cache["shift_a"], cache["state"], ma)
    elif kind == "rglru":
        o, new["conv"], new["h"] = rg.rglru_decode(
            h, p["attn"], cfg, cache["conv"], cache["h"])
    else:
        raise ValueError(kind)
    x = residual(x, o, ma)
    h = rmsnorm(x, p["ln2"], cfg.norm_eps)
    if kind == "wkv":
        o, new["shift_f"] = rwkv.rwkv_ffn(h, p["ffn"], cache["shift_f"])
    else:
        o, _ = _ffn(h, p["ffn"], cfg, drops, ma)
    for k, v in new.items():
        cache[k].copy_(v)
    return residual(x, o, ma), cache


# ---------------------------------------------------------------- model --
class Model:
    """Decoder-only language model (dense, MoE, RWKV-6, hybrid, VLM
    backbone).

    ``mesh_axes`` is ``models.model.mesh_axes_of(mesh)`` (its "mesh" None
    for one device); ``device`` is where :meth:`init` puts the parameters
    and where the model expects its inputs.  ``moe_drops``, if set to a
    list, gets each EP MoE call's dropped (token, expert) pair count
    appended as a 0-dim device tensor (summed over the data shards on a
    mesh), in call order (48 a forward of Qwen3-30B-A3B), once a call
    also where ``cfg.remat`` recomputes it.
    """

    def __init__(self, cfg, mesh_axes, device="cuda"):
        self.cfg = cfg
        self.mesh_axes = mesh_axes
        self.device = torch.device(device)
        pattern = cfg.pattern()
        period = len(cfg.block_pattern)
        self.n_periods = len(pattern) // period
        self.period_kinds = list(cfg.block_pattern)
        self.tail_kinds = pattern[self.n_periods * period:]
        self.moe_drops = None

    # -- params ----------------------------------------------------------
    def init(self, gen: torch.Generator):
        """(params, specs): random parameters in the reference's tree
        layout, drawn from ``gen`` (a generator on ``self.device``), plain
        tensors; specs as the reference's at this mesh's model size."""
        cfg = self.cfg
        dtype = _dtype(cfg.dtype)
        ma = self.mesh_axes["model_size"]
        p, s = {}, {}
        p["embed"], s["embed"] = init_embed(gen, cfg.padded_vocab,
                                            cfg.d_model, dtype, cfg.fsdp)
        if not cfg.tie_embeddings:
            p["unembed"], s["unembed"] = init_embed(
                gen, cfg.padded_vocab, cfg.d_model, dtype, cfg.fsdp)
        p["ln_f"], s["ln_f"] = init_rmsnorm(cfg.d_model, dtype, gen.device)
        p["periods"], s["periods"] = [], []
        for kind in self.period_kinds:
            if self.n_periods:
                bp, bs = init_stacked(self.n_periods, lambda kind=kind:
                                      init_block(gen, kind, cfg, dtype,
                                                 cfg.fsdp, ma))
            else:
                bp, bs = {}, {}
            p["periods"].append(bp)
            s["periods"].append(bs)
        tail = [init_block(gen, kind, cfg, dtype, cfg.fsdp, ma)
                for kind in self.tail_kinds]
        p["tail"], s["tail"] = [t[0] for t in tail], [t[1] for t in tail]
        return p, s

    # -- forward ---------------------------------------------------------
    def _embed_inputs(self, params, batch):
        ma = self.mesh_axes
        x = embed_lookup(gathered(params["embed"], ma), batch["tokens"])
        x = pin(x, (batch_axes(ma, x.shape[0]),), ma)
        if self.cfg.frontend == "vision_stub" and "patches" in batch:
            x = torch.cat([batch["patches"].to(x.dtype), x], dim=1)
        return x

    def _sp_constrain(self, x):
        """Sequence-parallel placement of the residual stream between
        periods (Megatron-SP), as the reference's: S over "model" when it
        divides, else d; the stream as it is without a mesh."""
        ma = self.mesh_axes
        if not on_mesh(ma):
            return x
        B, S, d = x.shape
        da, msz = batch_axes(ma, B), ma["model_size"]
        if S % msz == 0:
            return constrain(x, (da, "model", None), ma)
        if d % msz == 0:
            return constrain(x, (da, None, "model"), ma)
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
            x, st, a = block_forward(x, p, kind, cfg, drops, keep_states,
                                     self.mesh_axes)
            states.append(st)
            aux = aux + a
        return self._sp_constrain(x), states, aux, drops

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
                                     self.moe_drops, keep_states,
                                     self.mesh_axes)
            tail.append(st)
            aux_total = aux_total + a
        x = rmsnorm(_entry(x, self.mesh_axes), params["ln_f"], cfg.norm_eps)
        if not keep_states:
            return x, None, aux_total
        periods = [_stack_trees([s[j] for s in per_period])
                   for j in range(len(self.period_kinds))] \
            if per_period else []
        return x, {"periods": periods, "tail": tail}, aux_total

    def logits(self, params, x):
        emb = params["embed"] if self.cfg.tie_embeddings else params["unembed"]
        lg = unembed(x, gathered(emb, self.mesh_axes))
        if self.cfg.padded_vocab != self.cfg.vocab:  # mask padding rows
            keep = torch.arange(lg.shape[-1], device=lg.device) < \
                self.cfg.vocab
            lg = torch.where(like(keep, lg), lg, -1e30)
        return lg

    # -- public API --------------------------------------------------------
    def loss(self, params, batch):
        """Causal LM loss.  labels < 0 are masked."""
        x = self._embed_inputs(params, batch)
        x, _, aux = self._stack(params, x, keep_states=False)
        labels = batch["labels"]
        if self.cfg.frontend == "vision_stub" and "patches" in batch:
            npz = batch["patches"].shape[1]
            pad = labels.new_full((labels.shape[0], npz), -1)
            labels = torch.cat([pad, labels], dim=1)
        ce = shard_aware_ce(self.logits(params, x), labels, self.mesh_axes)
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
        x = self._embed_inputs(params, {"tokens": tokens})
        for i in range(self.n_periods):
            for j, kind in enumerate(self.period_kinds):
                x, _ = block_decode(x, _index(params["periods"][j], i), kind,
                                    cfg, _index(caches["periods"][j], i),
                                    pos, self.moe_drops, self.mesh_axes)
        for i, kind in enumerate(self.tail_kinds):
            x, _ = block_decode(x, params["tail"][i], kind, cfg,
                                caches["tail"][i], pos, self.moe_drops,
                                self.mesh_axes)
        x = rmsnorm(x, params["ln_f"], cfg.norm_eps)
        return self.logits(params, x), caches

    # -- specs -------------------------------------------------------------
    def cache_spec(self, B, S_ctx):
        """(the decode caches' shapes and dtypes as meta tensors, their
        specs), in the tree :meth:`decode_step` takes (each kind's stacked
        over the periods)."""
        dtype = _dtype(self.cfg.dtype)
        ma = self.mesh_axes
        da = ma["data"] if B % ma["data_size"] == 0 else None

        def one(kind):
            return block_cache_spec(kind, self.cfg, B, S_ctx, dtype, da,
                                    ma["model_size"])

        def stacked(sd):
            return {k: torch.empty((self.n_periods,) + tuple(t.shape),
                                   dtype=t.dtype, device="meta")
                    for k, t in sd.items()}

        periods = [one(k) for k in self.period_kinds]
        tail = [one(k) for k in self.tail_kinds]
        return ({"periods": [stacked(t) for t, _ in periods],
                 "tail": [t for t, _ in tail]},
                {"periods": [stack_specs(sp) for _, sp in periods],
                 "tail": [sp for _, sp in tail]})
