"""Mixture-of-Experts FFN with the reference's two dispatch modes.

Port of ``repro/models/moe.py`` for one device.  The reference computes
both modes with jnp, einsums and ``jax.lax.ragged_dot``, outside any
Pallas kernel; here they are torch ops and matmuls.

``ep`` — GShard-style capacity-bucketed dispatch: each (token, expert)
pair takes the next slot of its expert's bucket of ``cap`` slots, in token
order, and pairs past ``cap`` are dropped.  The reference runs it inside
``shard_map`` with experts sharded over the "model" axis and two
``all_to_all``s; on one device there is one shard and both are the
identity.  A dense grouped matmul applies every expert to its whole
bucket, so a call reads all the experts' weights.

``tp`` — the dropless sorted dispatch: pairs sorted by expert (stably) go
through a grouped matmul, here one matmul per non-empty expert group (the
reference's ``ragged_dot``).  Reading the group sizes waits for the
device once a call.

Capacity depends on how many tokens a call carries
(``cap = max(8, round(cf·T·k/E))``, Python's round-half-even), so a
prefill, a decode step and a teacher-forced forward drop different pairs.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import _init


def init_moe(gen, cfg, dtype):
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {"router": _init(gen, (d, e), scale=0.02, dtype=torch.float32),
            "wi": _init(gen, (e, d, f), dtype=dtype),
            "wg": _init(gen, (e, d, f), dtype=dtype),
            "wo": _init(gen, (e, f, d), dtype=dtype)}


def _route(x2d, router, k):
    """x2d (T, d) -> (weights (T, k), experts (T, k), aux_loss).  The
    router runs in float32; top-k values come in descending order."""
    logits = x2d.float() @ router
    probs = torch.softmax(logits, dim=-1)
    w, idx = torch.topk(probs, k, dim=-1)
    w = w / w.sum(dim=-1, keepdim=True)
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
def _ep_ffn_local(x2d, router, wi, wg, wo, *, k, cf, drops=None):
    """Capacity-bucketed dispatch on one shard: x2d (T, d); wi/wg/wo all
    E experts.  ``drops``, if a list, gets this call's dropped-pair count
    appended as a 0-dim device tensor (no host read)."""
    T, d = x2d.shape
    E = wi.shape[0]
    w, idx, aux = _route(x2d, router, k)
    cap = capacity(T, k, E, cf)
    flat_e = idx.reshape(-1)                                     # (T*k,)
    flat_t = torch.arange(T, device=x2d.device).repeat_interleave(k)
    pos, keep = _bucket_slots(flat_e, E, cap)
    if drops is not None:
        drops.append((~keep).sum())
    slot = torch.where(keep, pos, 0)
    send = torch.zeros((E, cap, d), dtype=x2d.dtype, device=x2d.device)
    send.index_put_((flat_e, slot),
                    torch.where(keep[:, None], x2d[flat_t], 0),
                    accumulate=True)
    h = F.silu(torch.bmm(send, wi)) * torch.bmm(send, wg)
    ret = torch.bmm(h, wo)                                       # (E, cap, d)
    gathered = torch.where(keep[:, None], ret[flat_e, slot], 0)
    contrib = gathered * w.reshape(-1)[:, None].to(gathered.dtype)
    y = torch.zeros_like(x2d).index_add_(0, flat_t, contrib)
    return y, aux


def moe_ffn(x, p, cfg, drops=None):
    """x (B, S, d) -> (y, aux_loss).  ``drops`` as in
    :func:`_ep_ffn_local` (the "tp" mode drops nothing)."""
    if cfg.moe_mode == "tp":
        return _moe_ffn_tp(x, p, cfg)
    B, S, d = x.shape
    y, aux = _ep_ffn_local(x.reshape(B * S, d), p["router"], p["wi"],
                           p["wg"], p["wo"], k=cfg.experts_per_token,
                           cf=cfg.capacity_factor, drops=drops)
    return y.reshape(B, S, d), aux


def _moe_ffn_tp(x, p, cfg):
    """Dropless sorted dispatch: a grouped matmul over the experts'
    contiguous slices of the sorted pairs."""
    B, S, d = x.shape
    T = B * S
    x2d = x.reshape(T, d)
    k = cfg.experts_per_token
    w, idx, aux = _route(x2d, p["router"], k)
    flat_e = idx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    inv = torch.argsort(order, stable=True)
    xs = x2d.repeat_interleave(k, dim=0)[order]                 # (T*k, d)
    sizes = torch.bincount(flat_e, minlength=cfg.n_experts).tolist()
    ys = torch.empty_like(xs)
    start = 0
    for g, n in enumerate(sizes):
        if n:
            rows = xs[start:start + n]
            h = F.silu(rows @ p["wi"][g]) * (rows @ p["wg"][g])
            ys[start:start + n] = h @ p["wo"][g]
        start += n
    y = ys[inv] * w.reshape(-1)[:, None].to(ys.dtype)
    return y.reshape(T, k, d).sum(dim=1).reshape(B, S, d), aux
