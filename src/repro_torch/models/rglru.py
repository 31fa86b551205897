"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427).

Port of ``repro/models/rglru.py``:

    r_t = σ(x_t W_r),  i_t = σ(x_t W_i)
    a_t = exp(-c · softplus(Λ) · r_t)
    h_t = a_t ⊙ h_{t-1} + sqrt(1 − a_t²) ⊙ (i_t ⊙ x̃_t)

The block is a conv1d (width 4) front, the RG-LRU core and a gated
output.  The linear recurrence is diagonal; prefill runs it as a
Hillis–Steele scan over the (a, b) pairs in float32, log2(S + 1) steps of
whole-sequence ops, where the reference calls ``jax.lax.associative_scan``
(the same combine in another tree, so the two agree to float rounding).
Decode carries the (h, conv window) state.  On a mesh (``ma``, see
:mod:`.layers`) the projections, the conv and the gates run through
DTensor, and the scan under :func:`.layers.shard_map` with the batch over
the data axes and the channels over "model", as the reference shards
``lam`` and the decode state.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import _init, batch_axes, shard_map

C_CONST = 8.0
CONV_W = 4


def init_rglru(gen, cfg, dtype, fsdp: bool):
    d = cfg.d_model
    dr = cfg.d_rnn or d
    row = "data" if fsdp else None
    p = {"w_in": _init(gen, (d, dr), dtype=dtype),
         "w_gate": _init(gen, (d, dr), dtype=dtype),
         "conv": _init(gen, (CONV_W, dr), scale=0.5, dtype=dtype),
         "w_r": _init(gen, (dr, dr), dtype=dtype),
         "w_i": _init(gen, (dr, dr), dtype=dtype),
         "lam": torch.full((dr,), 0.7, dtype=torch.float32,
                           device=gen.device),
         "w_out": _init(gen, (dr, d), dtype=dtype)}
    s = {"w_in": (row, "model"), "w_gate": (row, "model"),
         "conv": (None, "model"), "w_r": (None, "model"),
         "w_i": (None, "model"), "lam": ("model",),
         "w_out": ("model", row)}
    return p, s


def _conv1d(x, w, carry):
    """Causal depthwise conv, width CONV_W.  x: (B,S,dr); carry: (B,W-1,dr)."""
    full = torch.cat([carry, x], dim=1)
    S = x.shape[1]
    out = 0
    for i in range(CONV_W):
        out = out + full[:, i:i + S] * w[i]
    return out, full[:, -(CONV_W - 1):]


def _gates(xc, p):
    r = torch.sigmoid(xc @ p["w_r"])
    i = torch.sigmoid(xc @ p["w_i"])
    lam = p["lam"].float()
    log_a = -C_CONST * torch.logaddexp(lam, torch.zeros_like(lam)) * r.float()
    a = torch.exp(log_a)
    gated = (torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
             * (i * xc).float())
    return a, gated


def linear_scan(a, b):
    """h_t = a_t h_{t-1} + b_t along dim 1, with h_{-1} = 0 (the first
    pair carries the initial state): inclusive Hillis–Steele scan of the
    combine (a1, b1), (a2, b2) -> (a1 a2, a2 b1 + b2)."""
    S = a.shape[1]
    d = 1
    while d < S:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


def rglru_block(x, p, cfg, conv_carry, h0, ma=None):
    """x: (B,S,d).  Returns (out, conv_carry, h_last)."""
    gate = F.gelu(x @ p["w_gate"], approximate="tanh")
    xin = x @ p["w_in"]
    xc, conv_carry = _conv1d(xin, p["conv"], conv_carry)
    a, gated = _gates(xc, p)
    a_seq = torch.cat([torch.ones_like(h0[:, None], dtype=a.dtype), a], dim=1)
    b_seq = torch.cat([h0[:, None].float(), gated], dim=1)
    seq = (batch_axes(ma, x.shape[0]), None, "model")
    h = shard_map(linear_scan, ma, (seq, seq), (seq,))(a_seq, b_seq)[:, 1:]
    out = (h.to(x.dtype) * gate) @ p["w_out"]
    return out, conv_carry, h[:, -1]


def rglru_decode(x, p, cfg, conv_carry, h):
    """One-token step.  x: (B,1,d); h: (B,dr)."""
    gate = F.gelu(x @ p["w_gate"], approximate="tanh")
    xin = x @ p["w_in"]
    xc, conv_carry = _conv1d(xin, p["conv"], conv_carry)
    a, gated = _gates(xc, p)
    h = a[:, 0] * h + gated[:, 0]
    out = (h[:, None].to(x.dtype) * gate) @ p["w_out"]
    return out, conv_carry, h
