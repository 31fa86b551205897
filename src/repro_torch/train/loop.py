"""Train step: loss + grad + optimizer update, with optional gradient
accumulation and int8 error-feedback gradient compression
(:mod:`.compression`).

Port of ``repro/train/loop.py``.  Gradients come from autograd over the
parameter leaves (``torch.autograd.grad``) where the reference takes
``jax.value_and_grad``; microbatches run one after another where it
scans them.  The update is written in place (:func:`.optim.apply_updates`),
and a step reads nothing back to the host.

On a device mesh (a model built with ``build_model(cfg, mesh)``) the
parameters and state are DTensors and the step is the same code: each
gradient comes back from autograd as DTensor leaves it (partial sums over
the data axes where the batch was split) and is reduced by placement,
redistributed to its parameter's placements (an all-reduce, or a
reduce-scatter for a weight sharded over "data"); a microbatch is a
contiguous slice of the global batch, as in the reference, placed as the
batch was (:func:`_rows`).
"""
from __future__ import annotations

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from .optim import OptConfig, apply_updates, init_state


def make_opt_config(cfg, total_steps: int = 10_000) -> OptConfig:
    return OptConfig(kind=cfg.optimizer, state_dtype=cfg.opt_state_dtype,
                     momentum=getattr(cfg, "adafactor_momentum", True),
                     accum_dtype=getattr(cfg, "grad_accum_dtype", "float32"),
                     total_steps=total_steps)


def loss_and_grads(model, params, batch):
    """(loss, metrics, grads) of ``model.loss`` at ``params``: the loss and
    metrics detached, the gradients in the parameters' tree (zeros for a
    leaf the loss does not reach, as ``jax.grad`` gives).  Marks every
    parameter leaf ``requires_grad``."""
    from torch.distributed.tensor import DTensor
    leaves, spec = tree_flatten(params)
    for p in leaves:
        p.requires_grad_()
    loss, metrics = model.loss(params, batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    grads = [g.redistribute(p.device_mesh, p.placements)
             if isinstance(g, DTensor) else g for g, p in zip(grads, leaves)]
    metrics = {k: v.detach() if torch.is_tensor(v) else v
               for k, v in metrics.items()}
    return loss.detach(), metrics, tree_unflatten(grads, spec)


def _rows(v, lo: int, hi: int):
    """Rows lo:hi of a batch leaf.  A DTensor's rows are gathered over the
    axes that split them (the batch's tokens, not a weight), sliced, and
    split again where the slice divides over those axes (else left
    whole), as :func:`repro_torch.models.batch_specs` places a batch.
    DTensor's own slice of a split dim leaves the rows whole on every
    rank, which its vocab-parallel embedding then cannot re-split."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(v, DTensor):
        return v[lo:hi]
    mesh, placements = v.device_mesh, v.placements
    out = v.redistribute(mesh, [Replicate()] * mesh.ndim)[lo:hi]
    ways = 1
    for i, pl in enumerate(placements):
        if pl.is_shard(0):
            ways *= mesh.size(i)
    return out.redistribute(mesh, placements) if (hi - lo) % ways == 0 \
        else out


def _mean(values):
    """Mean of per-microbatch metrics: 0-dim tensors, or Python numbers
    (an MoE-free model's aux loss)."""
    if not any(torch.is_tensor(v) for v in values):
        return sum(values) / len(values)
    dev = next(v.device for v in values if torch.is_tensor(v))
    return torch.stack([v if torch.is_tensor(v) else
                        torch.full((), v, device=dev) for v in values]).mean()


def _plain(v):
    """A metric as a plain tensor (a replicated DTensor's local value)."""
    from torch.distributed.tensor import DTensor
    return v.full_tensor() if isinstance(v, DTensor) else v


def make_train_step(model, opt_cfg: OptConfig, microbatches: int = 1,
                    compression=None):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics); params and the optimizer state are updated in place.  With
    microbatches > 1 the batch is split on its leading axis and each
    gradient leaf is accumulated as ``(g.to(adt) / microbatches).to(adt)``
    in ``opt_cfg.accum_dtype``; losses and metrics are averaged."""

    def accumulated(params, batch):
        adt = getattr(torch, opt_cfg.accum_dtype)
        b = next(iter(batch.values())).shape[0]
        if b % microbatches:
            raise ValueError(f"batch {b} does not split into "
                             f"{microbatches} microbatches")
        n = b // microbatches
        acc, losses, metricses = None, [], []
        for i in range(microbatches):
            mb = {k: _rows(v, i * n, (i + 1) * n) for k, v in batch.items()}
            loss, metrics, grads = loss_and_grads(model, params, mb)
            parts = [(g.to(adt) / microbatches).to(adt)
                     for g in tree_flatten(grads)[0]]
            del grads
            if acc is None:
                acc = parts
            else:
                for a, g in zip(acc, parts):
                    a.add_(g)
            losses.append(loss)
            metricses.append(metrics)
        metrics = {k: _mean([m[k] for m in metricses]) for k in metricses[0]}
        return (_mean(losses), metrics,
                tree_unflatten(acc, tree_flatten(params)[1]))

    def train_step(params, opt_state, batch):
        if microbatches > 1:
            loss, metrics, grads = accumulated(params, batch)
        else:
            loss, metrics, grads = loss_and_grads(model, params, batch)
        if compression is not None:
            grads, opt_state = compression.apply(grads, opt_state)
        params, opt_state, opt_metrics = apply_updates(
            opt_cfg, params, grads, opt_state)
        metrics = dict(metrics)
        metrics.update(opt_metrics, loss=loss)
        return params, opt_state, {k: _plain(v) for k, v in metrics.items()}

    return train_step


def init_train_state(model, opt_cfg: OptConfig, gen: torch.Generator):
    """(params, opt_state, specs): ``model.init(gen)`` with every leaf
    marked ``requires_grad`` (on the model's mesh, DTensors placed by the
    specs), zero optimizer state beside it, and the parameters' specs."""
    params, specs = model.init(gen)
    mesh = model.mesh_axes["mesh"]
    if mesh is not None:
        from repro_torch.launch.mesh import distribute
        params = distribute(params, specs, mesh)
    for p in tree_flatten(params)[0]:
        p.requires_grad_()
    return params, init_state(opt_cfg, params), specs
