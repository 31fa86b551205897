"""Mixture-of-Experts FFN with the reference's two dispatch modes.

Port of ``repro/models/moe.py``.  The reference computes both modes with
jnp, einsums and ``jax.lax.ragged_dot``, outside any Pallas kernel; here
they are torch ops and matmuls.  On a mesh (``ma``, see :mod:`.layers`)
each mode runs under :func:`.layers.shard_map` with the reference's
specs: tokens over the data axes, and on one device (no mesh) the same
code runs with one shard.

``ep`` — expert parallelism, GShard-style capacity-bucketed dispatch:
experts are sharded over the "model" axis; each (token, expert) pair of
a data shard takes the next slot of its expert's bucket of ``cap``
slots, in token order, and pairs past ``cap`` are dropped.  The (E, cap,
d) send buffer goes to the experts' ranks by an ``all_to_all_single`` on
the model group, a grouped matmul applies the local experts to every
sender's bucket, and a second ``all_to_all_single`` brings the outputs
back (without a mesh both are the identity).  The aux loss is averaged
over every rank (the reference's pmean over the model and data axes),
and the dropped pairs are summed over the data shards.

``tp`` — the dropless sorted dispatch: every expert's d_ff is sliced
over "model"; pairs sorted by expert (stably) go through a grouped
matmul, here one matmul per non-empty expert group (the reference's
``ragged_dot``), and the outputs are summed over the model ranks like a
dense layer's.  Reading the group sizes waits for the device once a
call.  The aux loss is the whole batch's (token means summed over the
data shards), as GSPMD keeps it in the reference.

Capacity depends on how many tokens a call carries
(``cap = max(8, round(cf·T·k/E))``, Python's round-half-even, T the data
shard's tokens), so a prefill, a decode step and a teacher-forced forward
drop different pairs.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import (_init, batch_axes, constrain, data_dims, grad_scaled,
                     group_of, mesh_placements, on_mesh, shard_map)


def init_moe(gen, cfg, dtype, fsdp: bool):
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    row = "data" if fsdp else None
    p = {"router": _init(gen, (d, e), scale=0.02, dtype=torch.float32),
         "wi": _init(gen, (e, d, f), dtype=dtype),
         "wg": _init(gen, (e, d, f), dtype=dtype),
         "wo": _init(gen, (e, f, d), dtype=dtype)}
    if cfg.moe_mode == "ep":
        s = {"router": (row, None), "wi": ("model", row, None),
             "wg": ("model", row, None), "wo": ("model", row, None)}
    else:  # tp: slice d_ff
        s = {"router": (row, None), "wi": (None, row, "model"),
             "wg": (None, row, "model"), "wo": (None, "model", row)}
    return p, s


def _choose(x2d, router, k):
    """x2d (T, d) -> (probabilities (T, E), weights (T, k), experts
    (T, k)).  The router runs in float32; top-k values come in descending
    order."""
    probs = torch.softmax(x2d.float() @ router, dim=-1)
    w, idx = torch.topk(probs, k, dim=-1)
    return probs, w / w.sum(dim=-1, keepdim=True), idx


def _route(x2d, router, k):
    """x2d (T, d) -> (weights (T, k), experts (T, k), aux_loss)."""
    probs, w, idx = _choose(x2d, router, k)
    # load-balance auxiliary loss (Switch-style), on the first choice only
    e = router.shape[1]
    me = probs.mean(dim=0)
    ce = F.one_hot(idx[:, 0], e).float().mean(dim=0)
    return w, idx, e * (me * ce).sum()


def capacity(T: int, k: int, E: int, cf: float) -> int:
    """Slots in each expert's bucket for a call of T tokens."""
    return int(max(8, round(cf * T * k / E)))


def _bucket_slots(flat_e, E: int, cap: int):
    """Each pair's slot in its expert's bucket, in token order, and
    whether it fits (pos < cap): the reference's cumsum of the (T·k, E)
    one-hot, as a stable sort by expert (a cumsum down that one-hot's
    long axis took 12 ms a layer on the H100 at T = 4,096)."""
    order = torch.argsort(flat_e, stable=True)
    sizes = torch.zeros(E, dtype=flat_e.dtype, device=flat_e.device) \
        .scatter_add_(0, flat_e, torch.ones_like(flat_e))   # no host read
    starts = torch.cumsum(sizes, dim=0) - sizes
    pos = torch.empty_like(flat_e)
    pos[order] = torch.arange(flat_e.numel(), device=flat_e.device) - \
        starts[flat_e[order]]
    return pos, pos < cap


# ------------------------------------------------------------------- EP --
def _all_to_all(x, group):
    """Block j of x's leading axis to rank j of ``group``, block j of the
    result from rank j (``all_to_all_single``, differentiable); x itself
    without a group."""
    if group is None:
        return x
    import torch.distributed._functional_collectives as funcol
    return funcol.all_to_all_single_autograd(x.contiguous(), None, None,
                                             group)


def _ep_ffn_local(x2d, router, wi, wg, wo, *, k, cf, group=None):
    """Capacity-bucketed dispatch on one shard: x2d (T, d) the data
    shard's tokens; wi/wg/wo this rank's E_loc experts of the E split
    over ``group`` (all of them without one).  Returns (y, aux, the
    dropped pair count as a 0-dim tensor)."""
    n_shards = 1 if group is None else group.size()
    T, d = x2d.shape
    e_loc = wi.shape[0]
    E = e_loc * n_shards
    w, idx, aux = _route(x2d, router, k)
    cap = capacity(T, k, E, cf)
    flat_e = idx.reshape(-1)                                     # (T*k,)
    flat_t = torch.arange(T, device=x2d.device).repeat_interleave(k)
    pos, keep = _bucket_slots(flat_e, E, cap)
    slot = torch.where(keep, pos, 0)
    send = torch.zeros((E, cap, d), dtype=x2d.dtype, device=x2d.device)
    send.index_put_((flat_e, slot),
                    torch.where(keep[:, None], x2d[flat_t], 0),
                    accumulate=True)
    # rank j gets experts [j*e_loc, (j+1)*e_loc) of every sender's buffer
    recv = _all_to_all(send, group).reshape(n_shards, e_loc, cap, d)
    toks = recv.transpose(0, 1).reshape(e_loc, n_shards * cap, d)
    h = F.silu(torch.bmm(toks, wi)) * torch.bmm(toks, wg)
    out = torch.bmm(h, wo)                          # (e_loc, n*cap, d)
    back = out.reshape(e_loc, n_shards, cap, d).transpose(0, 1)
    ret = _all_to_all(back, group).reshape(E, cap, d)
    gathered = torch.where(keep[:, None], ret[flat_e, slot], 0)
    contrib = gathered * w.reshape(-1)[:, None].to(gathered.dtype)
    y = torch.zeros_like(x2d).index_add_(0, flat_t, contrib)
    return y, aux, (~keep).sum()


def moe_ffn(x, p, cfg, drops=None, ma=None):
    """x (B, S, d) -> (y, aux_loss).  ``drops``, if a list, gets each EP
    call's dropped-pair count appended as a 0-dim device tensor (no host
    read; summed over the data shards on a mesh); the "tp" mode drops
    nothing."""
    if cfg.moe_mode == "tp":
        return _moe_ffn_tp(x, p, cfg, ma)
    B, S, d = x.shape
    da = batch_axes(ma, B)
    spec_x, spec_w = (da, None, None), ("model", None, None)
    n_ranks = ma["mesh"].size() if on_mesh(ma) else 1
    n_model = ma["model_size"] if on_mesh(ma) else 1

    def run(xb, router, wi, wg, wo):
        y, aux, dropped = _ep_ffn_local(
            xb.reshape(-1, d), router, wi, wg, wo, k=cfg.experts_per_token,
            cf=cfg.capacity_factor, group=group_of(ma))
        # the model ranks of a data shard route the same tokens; each
        # copy's buckets reach every expert rank
        return grad_scaled(y.reshape(xb.shape), 1 / n_model), \
            aux / n_ranks, dropped

    out = in_grads = None
    if on_mesh(ma):
        data, every = data_dims(ma), ma["mesh"].mesh_dim_names
        out = (spec_x, mesh_placements(ma, (), every),
               mesh_placements(ma, (), data))
        in_grads = (mesh_placements(ma, spec_x, ("model",)),
                    mesh_placements(ma, (None, None), every)) + \
            (mesh_placements(ma, spec_w, data),) * 3
    y, aux, dropped = shard_map(
        run, ma, (spec_x, (None, None), spec_w, spec_w, spec_w), out,
        in_grads)(x, p["router"], p["wi"], p["wg"], p["wo"])
    aux = constrain(aux, (), ma)
    if drops is not None and on_mesh(ma):
        dropped = dropped.full_tensor()
    if drops is not None:
        drops.append(dropped)
    return y, aux


def _tp_local(xb, router, wi, wg, wo, *, k, n_experts, n_model=1):
    """Sorted dispatch of one data shard's tokens through this rank's
    slice of every expert's d_ff: (the partial output, the router's
    probabilities summed over the tokens, the first choices' counts, the
    last two over ``n_model``: each model rank's equal share of them)."""
    B, S, d = xb.shape
    x2d = xb.reshape(B * S, d)
    probs, w, idx = _choose(x2d, router, k)
    flat_e = idx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    inv = torch.argsort(order, stable=True)
    xs = x2d.repeat_interleave(k, dim=0)[order]                 # (T*k, d)
    sizes = torch.bincount(flat_e, minlength=n_experts).tolist()
    ys = torch.empty_like(xs)
    start = 0
    for g, n in enumerate(sizes):
        if n:
            rows = xs[start:start + n]
            h = F.silu(rows @ wi[g]) * (rows @ wg[g])
            ys[start:start + n] = h @ wo[g]
        start += n
    y = ys[inv] * w.reshape(-1)[:, None].to(ys.dtype)
    first = F.one_hot(idx[:, 0], n_experts).float()
    return (y.reshape(B * S, k, d).sum(dim=1).reshape(B, S, d),
            probs.sum(dim=0) / n_model, first.sum(dim=0) / n_model)


def _moe_ffn_tp(x, p, cfg, ma=None):
    """Dropless sorted dispatch: a grouped matmul over the experts'
    contiguous slices of the sorted pairs, d_ff sliced over "model"; the
    aux loss E·Σ mean(probs)·mean(first choices) over the whole batch."""
    B, S, d = x.shape
    da = batch_axes(ma, B)
    spec_x = (da, None, None)
    spec_w = [(None, None, "model")] * 2 + [(None, "model", None)]
    out = in_grads = None
    if on_mesh(ma):
        data, every = data_dims(ma), ma["mesh"].mesh_dim_names
        out = (mesh_placements(ma, spec_x, ("model",)),
               mesh_placements(ma, (None,), every),
               mesh_placements(ma, (None,), every))
        in_grads = (mesh_placements(ma, spec_x, ("model",)),
                    mesh_placements(ma, (None, None), every)) + \
            tuple(mesh_placements(ma, s, data) for s in spec_w)
    y, probs_sum, first_sum = shard_map(
        lambda *a: _tp_local(*a, k=cfg.experts_per_token,
                             n_experts=cfg.n_experts,
                             n_model=ma["model_size"] if on_mesh(ma) else 1),
        ma, (spec_x, (None, None), *spec_w), out, in_grads)(
        x, p["router"], p["wi"], p["wg"], p["wo"])
    T = B * S
    me = constrain(probs_sum, (), ma) / T
    ce = constrain(first_sum, (), ma) / T
    return y, constrain(cfg.n_experts * (me * ce).sum(), (), ma)
