"""RWKV-6 "Finch" time-mix block (arXiv:2404.05892) — attention-free with
data-dependent per-channel decay.

Port of ``repro/models/rwkv6.py``.  Recurrence per head (state
S ∈ R^{dk×dv}):
    S_t = diag(w_t) S_{t-1} + k_t v_tᵀ
    o_t = r_tᵀ (diag(u ⊙ k_t) v_tᵀ + S_{t-1})
with w_t = exp(-exp(wlog_t)) ∈ (0,1) data-dependent (LoRA on the shifted
input), r/k/v projections with token-shift mixing, and bonus u for the
current token.

Prefill uses the chunkwise-parallel form in float32 (intra-chunk matmuls,
then a loop over the chunks' states where the reference runs
``lax.scan``); decode is the O(1) recurrence.  The reference computes it
with jnp einsums, outside any Pallas kernel.  On a mesh (``ma``, see
:mod:`.layers`) the projections run through DTensor and both
recurrences, per head, under :func:`.layers.shard_map` with the batch
over the data axes and the heads over "model" (the reference's specs of
``u`` and of the decode state).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import (_init, batch_axes, data_dims, mesh_placements, on_mesh,
                     pin, rmsnorm, shard_map)

CHUNK = 64
LORA = 64
CLAMP = 60.0


def init_rwkv(gen, cfg, dtype, fsdp: bool):
    d, h, dh = cfg.d_model, cfg.n_heads, cfg.head_dim
    dev = gen.device
    row = "data" if fsdp else None
    p = {
        "wr": _init(gen, (d, d), dtype=dtype),
        "wk": _init(gen, (d, d), dtype=dtype),
        "wv": _init(gen, (d, d), dtype=dtype),
        "wg": _init(gen, (d, d), dtype=dtype),
        "wo": _init(gen, (d, d), dtype=dtype),
        # data-dependent decay: w = exp(-exp(base + lora))
        "w_base": torch.full((d,), -0.5, dtype=torch.float32, device=dev),
        "w_lora_a": _init(gen, (d, LORA), dtype=dtype),
        "w_lora_b": _init(gen, (LORA, d), scale=0.01, dtype=dtype),
        "u": _init(gen, (h, dh), scale=0.5, dtype=torch.float32),
        # token-shift mix coefficients per projection
        "mu": _init(gen, (5, d), scale=0.2, dtype=torch.float32),
        "ln_x": torch.ones((d,), dtype=dtype, device=dev),
    }
    s = {
        "wr": (row, "model"), "wk": (row, "model"), "wv": (row, "model"),
        "wg": (row, "model"), "wo": ("model", row),
        "w_base": (None,), "w_lora_a": (row, None), "w_lora_b": (None, row),
        "u": ("model", None), "mu": (None, None), "ln_x": (None,),
    }
    return p, s


def head_spec(ma, B: int):
    """(B, ..., H, ...) per-head tensors: batch over the data axes, heads
    over "model"; as (batch, heads) entries of a spec."""
    return batch_axes(ma, B), "model"


def _projections(x, x_prev, p, cfg):
    """Token-shift mixing + r/k/v/g/decay projections.

    x: (B, S, d); x_prev: (B, S, d) = x shifted right by one (carry-in at
    t=0).  Returns r,k,v,g (B,S,H,dh) and log-decay (B,S,H,dh) (negative).
    """
    B, S, d = x.shape
    h, dh = cfg.n_heads, cfg.head_dim
    mu = p["mu"].to(x.dtype)
    xs = [x + mu[i] * (x_prev - x) for i in range(5)]
    r = (xs[0] @ p["wr"]).reshape(B, S, h, dh)
    k = (xs[1] @ p["wk"]).reshape(B, S, h, dh)
    v = (xs[2] @ p["wv"]).reshape(B, S, h, dh)
    g = F.silu(xs[3] @ p["wg"]).reshape(B, S, h, dh)
    wl = (xs[4] @ p["w_lora_a"]) @ p["w_lora_b"]
    wlog = p["w_base"].float() + torch.tanh(wl.float())
    logw = -torch.exp(wlog)                     # log decay ∈ (-inf, 0)
    return r, k, v, g, logw.reshape(B, S, h, dh)


def wkv_chunked(r, k, v, logw, u, state0):
    """Chunkwise-parallel WKV.  r/k/v/logw: (B, S, H, dh); u: (H, dh);
    state0: (B, H, dh, dh).  Returns (o (B,S,H,dh), state (B,H,dh,dh)),
    float32.  S must be a multiple of min(CHUNK, S), as the reference
    asserts."""
    B, S, H, dh = r.shape
    C = min(CHUNK, S)
    if S % C:
        raise ValueError(f"sequence length {S} is not a multiple of the "
                         f"chunk {C}")
    n = S // C
    rs, ks, vs, lw = (a.reshape(B, n, C, H, dh).float()
                      for a in (r, k, v, logw))
    cum = torch.cumsum(lw, dim=2)                # logD_t inclusive
    total = cum[:, :, -1]                        # (B, n, H, dh)
    # q̃_t = r_t ⊙ exp(logD_{t-1}) (exclusive);
    # k̃_τ = k_τ ⊙ exp(-logD_τ), clamped at e^60 so fp32 stays finite
    q_t = rs * torch.exp(cum - lw)
    k_t = ks * torch.exp(torch.clamp(-cum, -CLAMP, CLAMP))
    # intra-chunk: strict lower-triangular (τ < t)
    att = torch.einsum("bnthd,bnshd->bnhts", q_t, k_t)
    tri = torch.tril(torch.ones((C, C), device=r.device), diagonal=-1)
    att = att * tri
    o = torch.einsum("bnhts,bnshd->bnthd", att, vs)
    # bonus (current token): r·(u ⊙ k) v
    bonus = torch.einsum("bnthd,bnthd->bnth", rs, u * ks)
    o = o + bonus[..., None] * vs
    # inter-chunk: carry the state through the chunks in order
    kv = torch.einsum("bnshd,bnshe->bnhde",
                      ks * torch.exp(total[:, :, None] - cum), vs)
    decay = torch.exp(total)[..., None]          # (B, n, H, dh, 1)
    state = state0.float()
    carry = []
    for c in range(n):
        carry.append(torch.einsum("bthd,bhde->bthe", q_t[:, c], state))
        state = state * decay[:, c] + kv[:, c]
    o = o + torch.stack(carry, dim=1)
    return o.reshape(B, S, H, dh), state


def wkv_step(r, k, v, logw, u, state):
    """O(1) decode step.  r/k/v/logw: (B, H, dh); state: (B, H, dh, dh)."""
    rf, kf, vf = r.float(), k.float(), v.float()
    w = torch.exp(logw.float())
    kv = kf[..., :, None] * vf[..., None, :]            # (B,H,dk,dv)
    o = torch.einsum("bhd,bhde->bhe", rf, u[None, ..., None] * kv + state)
    return o, state * w[..., None] + kv


def rwkv_block(x, p, cfg, shift_in, state0, ma=None):
    """Full time-mix block over a sequence.

    x: (B, S, d); shift_in: (B, d) carry (last token of previous segment);
    state0: (B, H, dh, dh).  Returns (out, shift_out, state)."""
    B, S, d = x.shape
    x_prev = torch.cat([shift_in[:, None], x[:, :-1]], dim=1)
    r, k, v, g, logw = _projections(x, x_prev, p, cfg)
    da, hm = head_spec(ma, B)
    seq, st = (da, None, hm, None), (da, hm, None, None)
    grads = None
    if on_mesh(ma):   # u, used on each data shard's rows
        grads = (seq,) * 4 + (mesh_placements(ma, (hm, None),
                                              data_dims(ma)), st)
    o, state = shard_map(wkv_chunked, ma, (seq,) * 4 + ((hm, None), st),
                         (seq, st), grads)(
        r, k, v, logw, p["u"].float(), state0)
    # whole over "model" before the norm over d (and its gradient too)
    o = pin((o.to(x.dtype) * g).reshape(B, S, d), (da,), ma)
    o = rmsnorm(o, p["ln_x"], cfg.norm_eps)
    return o @ p["wo"], x[:, -1], state


def init_rwkv_ffn(gen, cfg, dtype, fsdp: bool):
    """RWKV channel-mix: token-shifted squared-ReLU MLP with sigmoid gate."""
    d, f = cfg.d_model, cfg.d_ff
    row = "data" if fsdp else None
    return ({"wk": _init(gen, (d, f), dtype=dtype),
             "wv": _init(gen, (f, d), dtype=dtype),
             "wr": _init(gen, (d, d), dtype=dtype),
             "mu": _init(gen, (2, d), scale=0.2, dtype=torch.float32)},
            {"wk": (row, "model"), "wv": ("model", row), "wr": (row, None),
             "mu": (None, None)})


def rwkv_ffn(x, p, shift_in):
    """x (B,S,d); shift_in (B,d).  Returns (out, shift_out)."""
    x_prev = torch.cat([shift_in[:, None], x[:, :-1]], dim=1)
    mu = p["mu"].to(x.dtype)
    xk = x + mu[0] * (x_prev - x)
    xr = x + mu[1] * (x_prev - x)
    k = torch.square(torch.relu(xk @ p["wk"]))
    return torch.sigmoid(xr @ p["wr"]) * (k @ p["wv"]), x[:, -1]


def rwkv_decode(x, p, cfg, shift_in, state, ma=None):
    """One-token step.  x: (B, 1, d)."""
    B, _, d = x.shape
    r, k, v, g, logw = _projections(x, shift_in[:, None], p, cfg)
    da, hm = head_spec(ma, B)
    one = (da, hm, None)
    o, state = shard_map(wkv_step, ma, (one,) * 4 + ((hm, None),
                         (da, hm, None, None)), (one, (da, hm, None, None)))(
        r[:, 0], k[:, 0], v[:, 0], logw[:, 0], p["u"].float(), state)
    o = pin((o[:, None].to(x.dtype) * g).reshape(B, 1, d), (da,), ma)
    o = rmsnorm(o, p["ln_x"], cfg.norm_eps)
    return o @ p["wo"], x[:, 0], state
