"""Shared layers: norms, embeddings, RoPE, gated MLP.

Port of ``repro/models/layers.py``.  Functional style: params are nested
dicts of tensors.  Each ``init_*`` draws from an explicit
``torch.Generator`` and returns ``(params, specs)``: specs mirror params
with the reference's PartitionSpecs as tuples (:mod:`repro_torch.launch.mesh`).
Norms and the unembedding compute in float32, as in the reference.

On a device mesh the parameters are DTensors and the dense ops below run
through DTensor's sharding propagation.  The mesh side is a dict of mesh
axes (``models.model.mesh_axes_of``, the reference's ``mesh_axes``; None
for one device): :func:`constrain` is the reference's
``with_sharding_constraint`` and :func:`shard_map` its ``shard_map``, a
``local_map`` whose inputs are redistributed to their specs.  Without a
mesh both give back what they were given, so one code path serves one
device and every mesh.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


# ----------------------------------------------------------------- mesh --
def on_mesh(ma) -> bool:
    return ma is not None and ma["mesh"] is not None


def batch_axes(ma, B: int):
    """The data axes a batch of B rows shards over: None (replicated) when
    B does not divide over them, as the reference's ``input_specs``."""
    if not on_mesh(ma) or B % ma["data_size"]:
        return None
    return ma["data"]


def mesh_placements(ma, spec, partial=()):
    """DTensor placements of ``spec`` on ``ma``'s mesh, with ``Partial()``
    (a sum) on the mesh axes named in ``partial``."""
    from torch.distributed.tensor import Partial
    from repro_torch.launch.mesh import placements
    mesh = ma["mesh"]
    out = placements(spec, mesh)
    for a in partial:
        out[mesh.mesh_dim_names.index(a)] = Partial()
    return out


def constrain(x, spec, ma):
    """``x`` redistributed to ``spec`` on the mesh; ``x`` without one."""
    if not on_mesh(ma):
        return x
    return x.redistribute(ma["mesh"], mesh_placements(ma, spec))


def shard_map(fn, ma, in_specs, out_specs, in_grads=None):
    """``fn`` run on each rank's blocks: its tensor inputs redistributed to
    ``in_specs``, its outputs read as ``out_specs`` (a spec, or a list of
    placements from :func:`mesh_placements`; None for a non-tensor
    argument).  ``in_grads`` places the inputs' gradients (default: as
    the inputs): a weight replicated over the data axes, used on each
    data shard's rows, gets a partial sum there.  ``fn`` itself without a
    mesh."""
    if not on_mesh(ma):
        return fn
    from torch.distributed.tensor.experimental import local_map

    def conv(s):
        return s if s is None or isinstance(s, list) else \
            mesh_placements(ma, s)

    outs = tuple(conv(s) for s in out_specs)
    return local_map(fn, out_placements=outs if len(outs) > 1 else outs[0],
                     in_placements=tuple(conv(s) for s in in_specs),
                     in_grad_placements=None if in_grads is None else
                     tuple(conv(s) for s in in_grads),
                     device_mesh=ma["mesh"], redistribute_inputs=True)


def data_dims(ma) -> tuple:
    """The mesh's batch-parallel axes, by name."""
    return tuple(a for a in ma["mesh"].mesh_dim_names if a != "model")


class _GradScaled(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale: float):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad * ctx.scale, None


def grad_scaled(x, scale: float):
    """``x``, its gradient times ``scale`` (``x`` itself at 1): where
    every model rank computes the same output from the same tokens, each
    copy carries its share of the gradient back through the collectives
    that mix the copies."""
    return x if scale == 1 else _GradScaled.apply(x, scale)


class _Pinned(torch.autograd.Function):
    """Redistribute to ``placements`` forward, and the gradient to the
    same placements backward.  DTensor's own backward hands a gradient
    back in whatever placement the op that consumed the tensor left it:
    a partial sum over "model" (the residual stream's, under the
    vocab-parallel unembedding and the column-parallel matmuls), which
    the row-parallel matmul that made the tensor would then multiply by
    gathering its weight; or a shard that a reshape cannot take."""

    @staticmethod
    def forward(ctx, x, mesh, placements):
        ctx.mesh, ctx.placements = mesh, placements
        return x.redistribute(mesh, placements)

    @staticmethod
    def backward(ctx, grad):
        return grad.redistribute(ctx.mesh, ctx.placements), None, None


def pin(x, spec, ma):
    """``x`` placed by ``spec``, and its gradient too; ``x`` without a
    mesh."""
    if not on_mesh(ma):
        return x
    return _Pinned.apply(x, ma["mesh"], mesh_placements(ma, spec))


def residual(x, o, ma):
    """``x + o``, ``o`` first placed with the batch over the data axes and
    replicated over "model": a row-parallel output is a partial sum over
    the model ranks, and summing it before the add (Megatron's all-reduce
    after the block) keeps every matmul's input, and its gradient, whole
    over "model"."""
    return x + pin(o, (batch_axes(ma, o.shape[0]),), ma)


def gathered(tree, ma):
    """Weights with their data-sharded dims gathered (FSDP: weights are
    all-gathered over the data axes where they are used, and autograd
    reduce-scatters their gradients back); "model" placements are kept,
    so each matmul has a placement with no communication.  The gather is
    explicit, one all-gather a data axis: DTensor's own redistribute may
    route it through the model axis.  ``tree`` as it is without a mesh."""
    if not on_mesh(ma):
        return tree
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import DTensor, Replicate
    from torch.utils._pytree import tree_map
    mesh = ma["mesh"]
    names = mesh.mesh_dim_names

    def one(w):
        if not isinstance(w, DTensor):
            return w
        pl, local = list(w.placements), w.to_local()
        for i in reversed(range(len(names))):
            if names[i] != "model" and pl[i].is_shard():
                local = funcol.all_gather_tensor_autograd(
                    local, gather_dim=pl[i].dim, group=mesh.get_group(i))
                pl[i] = Replicate()
        if pl == list(w.placements):
            return w
        return DTensor.from_local(local, mesh, pl, run_check=False)

    return tree_map(one, tree)


def like(t: torch.Tensor, ref):
    """A plain tensor ``t`` (the same on every rank) as a replicated
    DTensor on ``ref``'s mesh when ``ref`` is a DTensor; else ``t``."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(ref, DTensor) or isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, ref.device_mesh,
                              [Replicate()] * ref.device_mesh.ndim,
                              run_check=False)


def group_of(ma, axis: str = "model"):
    """The process group of one mesh axis; None without a mesh."""
    return ma["mesh"].get_group(axis) if on_mesh(ma) else None


def psum(x, group):
    """Sum over the ranks of ``group`` (a functional all-reduce); ``x``
    itself without a group."""
    if group is None:
        return x
    import torch.distributed._functional_collectives as funcol
    return funcol.all_reduce(x, "sum", group)


def _init(gen: torch.Generator, shape, scale=None, dtype=torch.float32):
    """Normal draws times ``scale`` (default 1/sqrt(shape[0])), on the
    generator's device, cast to ``dtype``."""
    scale = scale if scale is not None else 1.0 / np.sqrt(shape[0])
    x = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (x * scale).to(dtype)


# ---------------------------------------------------------------- norms --
def init_rmsnorm(d, dtype, device):
    return torch.ones((d,), dtype=dtype, device=device), (None,)


def rmsnorm(x, w, eps=1e-6):
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.float()).to(x.dtype)


def init_layernorm(d, dtype, device):
    return ({"w": torch.ones((d,), dtype=dtype, device=device),
             "b": torch.zeros((d,), dtype=dtype, device=device)},
            {"w": (None,), "b": (None,)})


def layernorm(x, p, eps=1e-6):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * p["w"].float() + p["b"].float()).to(x.dtype)


# ----------------------------------------------------------- embeddings --
def init_embed(gen, vocab, d, dtype, fsdp: bool):
    return (_init(gen, (vocab, d), scale=0.02, dtype=dtype),
            ("model", "data" if fsdp else None))


def embed_lookup(emb, tokens):
    return F.embedding(tokens, emb)


def unembed(x, emb):
    """(B, S, D) x (V, D)^T -> fp32 logits."""
    return x.float() @ emb.float().T


# ----------------------------------------------------------------- RoPE --
def rope_frequencies(d_head, theta):
    return 1.0 / (theta ** (np.arange(0, d_head, 2) / d_head))


def _rope_freqs(d_head, theta, device) -> torch.Tensor:
    """float32 frequencies on ``device``, copied there once (each time
    under a fake tensor mode, whose tensors must not outlive it)."""
    from torch._guards import detect_fake_mode
    if detect_fake_mode() is not None:
        return _freqs_tensor.__wrapped__(d_head, theta, device)
    return _freqs_tensor(d_head, theta, device)


@functools.lru_cache(maxsize=None)
def _freqs_tensor(d_head, theta, device) -> torch.Tensor:
    return torch.as_tensor(rope_frequencies(d_head, theta),
                           dtype=torch.float32, device=device)


def apply_rope(x, positions, theta):
    """x: (..., S, H, Dh), positions: (..., S) (or (S,) for every row).
    The reference's half-split layout: the first and second halves of the
    head dim form the pairs."""
    freqs = like(_rope_freqs(x.shape[-1], theta, x.device), positions)
    ang = positions[..., :, None].float() * freqs        # (..., S, Dh/2)
    cos = like(torch.cos(ang)[..., :, None, :], x)
    sin = like(torch.sin(ang)[..., :, None, :], x)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------------ gated MLP --
def init_mlp(gen, d, d_ff, dtype, fsdp: bool):
    row = "data" if fsdp else None
    return ({"wi": _init(gen, (d, d_ff), dtype=dtype),
             "wg": _init(gen, (d, d_ff), dtype=dtype),
             "wo": _init(gen, (d_ff, d), dtype=dtype)},
            {"wi": (row, "model"), "wg": (row, "model"),
             "wo": ("model", row)})


def mlp(x, p):
    h = F.silu(x @ p["wi"]) * (x @ p["wg"])
    return h @ p["wo"]
