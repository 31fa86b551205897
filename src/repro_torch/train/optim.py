"""Optimizers: AdamW and Adafactor (factored second moment), with
configurable state dtype.

Port of ``repro/train/optim.py`` on one device, with the reference's
formulas and state layout: ``{"step": 0-dim int32, "opt": per leaf
{"m", "v"} | {"vr", "vc"[, "m"]} | {"v"[, "m"]}}``.  The update is
written in place under ``torch.no_grad()``, so a step holds the
parameters, gradients and state once, plus one leaf's float32
transients; a leaf above ``_CHUNK_ELEMS`` elements with ``ndim >= 3``
takes its float32 math one slice of its leading (stacked-layers) axis at
a time, where the reference uses ``lax.map``.  The learning rate and the
gradient norm stay 0-dim tensors on the parameters' device: a step reads
nothing back to the host.

On a device mesh the parameters and gradients are DTensors, and so is
the state: :func:`state_specs` mirrors the parameters' specs onto it (the
factored ``vr``/``vc`` drop the last and the second-to-last axes), and
:func:`init_state` places each state leaf by it.  The update runs
through DTensor, each rank on its own blocks; the gradient norm and
Adafactor's means over sharded axes are sums over the ranks.
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch.utils._pytree import tree_flatten, tree_map

from repro_torch.launch.mesh import is_spec, placements


@dataclasses.dataclass(frozen=True)
class OptConfig:
    kind: str = "adamw"            # adamw | adafactor
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    state_dtype: str = "float32"
    momentum: bool = True        # adafactor: disable to halve state bytes
    accum_dtype: str = "float32"
    warmup: int = 100
    total_steps: int = 10_000


def schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up, then a cosine decay to a tenth of ``cfg.lr``;
    ``step`` an integer tensor, the result a float32 tensor beside it."""
    warm = torch.clamp(step / max(cfg.warmup, 1), max=1.0)
    frac = torch.clamp((step - cfg.warmup) /
                       max(cfg.total_steps - cfg.warmup, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * frac))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def _factored_dims(shape):
    """Last two dims if both > 1 (Adafactor row/col factoring)."""
    if len(shape) >= 2 and shape[-1] > 1 and shape[-2] > 1:
        return len(shape) - 2, len(shape) - 1
    return None


def _leaf_specs(cfg: OptConfig, sp) -> dict:
    """The state specs of one parameter whose spec is ``sp``."""
    if cfg.kind == "adamw":
        return {"m": sp, "v": sp}
    # factored dims drop the last / second-to-last axes
    if len(sp) >= 2:
        st = {"vr": sp[:-2] + (sp[-2],), "vc": sp[:-2] + (sp[-1],)}
    else:
        st = {"v": sp}
    if cfg.momentum:
        st["m"] = sp
    return st


def state_specs(cfg: OptConfig, param_specs):
    """Specs of the optimizer state, mirroring the params'."""
    return {"step": (),
            "opt": tree_map(lambda sp: _leaf_specs(cfg, sp), param_specs,
                            is_leaf=is_spec)}


def spec_of(t) -> tuple:
    """The spec a DTensor is placed by (the inverse of
    :func:`repro_torch.launch.mesh.placements`)."""
    entries = [()] * t.dim()
    for name, pl in zip(t.device_mesh.mesh_dim_names, t.placements):
        if pl.is_shard():
            entries[pl.dim] += (name,)
    return tuple(None if not e else e[0] if len(e) == 1 else e
                 for e in entries)


def _zeros(p, shape, dtype, spec):
    """Zeros of ``shape`` beside parameter ``p``: on its device, and on a
    mesh a DTensor placed by ``spec`` (each rank allocating its block)."""
    from torch.distributed.tensor import DTensor
    if not isinstance(p, DTensor):
        return torch.zeros(shape, dtype=dtype, device=p.device)
    from torch.distributed.tensor import zeros
    return zeros(shape, dtype=dtype, device_mesh=p.device_mesh,
                 placements=placements(spec, p.device_mesh))


def init_state(cfg: OptConfig, params):
    """Zero optimizer state for ``params``, on their device (on their
    mesh, placed by :func:`state_specs`)."""
    dt = getattr(torch, cfg.state_dtype)

    def per_leaf(p):
        from torch.distributed.tensor import DTensor
        psp = spec_of(p) if isinstance(p, DTensor) else (None,) * p.dim()
        sp = _leaf_specs(cfg, psp)
        if cfg.kind == "adamw":
            return {"m": _zeros(p, p.shape, dt, psp),
                    "v": _zeros(p, p.shape, dt, psp)}
        fd = _factored_dims(p.shape)
        if fd is None:
            st = {"v": _zeros(p, p.shape, torch.float32, psp)}
        else:
            r, c = fd
            st = {"vr": _zeros(p, p.shape[:c] + p.shape[c + 1:],
                               torch.float32, sp["vr"]),
                  "vc": _zeros(p, p.shape[:r] + p.shape[r + 1:],
                               torch.float32, sp["vc"])}
        if cfg.momentum:
            st["m"] = _zeros(p, p.shape, dt, psp)
        return st

    leaf = tree_flatten(params)[0][0]
    step = torch.zeros((), dtype=torch.int32, device=leaf.device)
    from torch.distributed.tensor import DTensor
    if isinstance(leaf, DTensor):
        step = _zeros(leaf, (), torch.int32, ())
    return {"step": step, "opt": tree_map(per_leaf, params)}


# Leaves above this many elements get their fp32 optimizer math chunked
# over the leading (stacked-layers) axis: the transient fp32 copies of a
# 61-layer MoE weight stack would otherwise cost ~5 GB each.
_CHUNK_ELEMS = 1 << 26


def _sharded_dim0(t) -> bool:
    """Whether a DTensor's leading dim is sharded (split by its block
    then, not in slices of the whole)."""
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor) and any(
        p.is_shard(0) for p in t.placements)


def _global_norm(grads) -> torch.Tensor:
    def leaf_sq(g):
        if g.numel() > _CHUNK_ELEMS and g.dim() >= 2 and \
                not _sharded_dim0(g):
            # the sum of each slice of the leading axis, as the reference's
            # lax.map, a block of slices at a time (float32 copies of at
            # most _CHUNK_ELEMS elements)
            rows = max(1, _CHUNK_ELEMS // g[0].numel())
            dims = tuple(range(1, g.dim()))
            return torch.cat([b.float().square().sum(dims)
                              for b in g.split(rows)]).sum()
        return g.float().square().sum()

    return torch.sqrt(sum(leaf_sq(g) for g in tree_flatten(grads)[0]))


def _update(cfg, p, g, st, gscale, lr, bc1, bc2) -> None:
    """One leaf (or one slice of a chunked leaf): ``p`` and the state
    tensors of ``st`` written in place."""
    g = g.float() * gscale
    if "m" in st:
        m = st["m"].float() * cfg.b1 + g * (1 - cfg.b1)
        mh = m / bc1
    else:
        m = mh = g  # momentum-free adafactor
    if "v" in st:
        v = st["v"].float() * cfg.b2 + g.square() * (1 - cfg.b2)
        upd = mh / (torch.sqrt(v / bc2) + cfg.eps)
        st["v"].copy_(v)
    else:
        # p shape (..., R, C): vr = mean over C -> (..., R); vc = mean
        # over R -> (..., C); V ≈ vr ⊗ vc / mean(vr).
        g2 = g.square() + 1e-30
        vr = st["vr"] * cfg.b2 + g2.mean(dim=-1) * (1 - cfg.b2)
        vc = st["vc"] * cfg.b2 + g2.mean(dim=-2) * (1 - cfg.b2)
        vrb, vcb = vr / bc2, vc / bc2
        denom = (vrb[..., :, None] * vcb[..., None, :] /
                 torch.clamp(vrb.mean(dim=-1)[..., None, None], min=1e-30))
        upd = mh * torch.rsqrt(denom + 1e-30)
        st["vr"].copy_(vr)
        st["vc"].copy_(vc)
    if "m" in st:
        st["m"].copy_(m)
    upd = upd + cfg.weight_decay * p.float()
    p.copy_(p.float() - lr * upd)


@torch.no_grad()
def apply_updates(cfg: OptConfig, params, grads, state):
    """One optimizer step, in place: ``params`` and ``state["opt"]``'s
    tensors are overwritten.  Returns (params, the state with its step
    advanced and any other key kept, {"lr", "grad_norm"} as 0-dim
    tensors)."""
    step = state["step"] + 1
    lr = schedule(cfg, step)
    gnorm = _global_norm(grads)
    gscale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    bc1 = 1.0 - cfg.b1 ** step.float()
    bc2 = 1.0 - cfg.b2 ** step.float()
    flat_p, spec = tree_flatten(params)
    flat_g = tree_flatten(grads)[0]
    for p, g, st in zip(flat_p, flat_g, spec.flatten_up_to(state["opt"])):
        if p.numel() > _CHUNK_ELEMS and p.dim() >= 3:
            # vr/vc drop trailing dims, so the leading axis lines up
            for i in range(p.shape[0]):
                _update(cfg, p[i], g[i], {k: v[i] for k, v in st.items()},
                        gscale, lr, bc1, bc2)
        else:
            _update(cfg, p, g, st, gscale, lr, bc1, bc2)
    return params, dict(state, step=step), {"lr": lr, "grad_norm": gnorm}

