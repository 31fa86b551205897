"""Facade: build a model and the abstract inputs of any (arch, shape).

Port of ``repro/models/model.py``.  Without a mesh the model lives on one
device (the card unless the caller asks for the CPU).  On a
``DeviceMesh`` (:mod:`repro_torch.launch.mesh`) its parameters, inputs
and caches are DTensors placed by the reference's specs: batches over
the data axes (("pod", "data") on the multi-pod mesh), weights over
"model" (and rows over "data" under FSDP).  Input specs are meta tensors
(shapes and dtypes, token ids and positions int32 as the reference's)
with their specs.
"""
from __future__ import annotations

import torch

from repro_torch.core.decoder import resolve_device

from .encdec import EncDecModel
from .transformer import Model


def mesh_axes_of(mesh):
    """Mesh metadata dict used across model code (the reference's).

    data axes = all batch-parallel axes (("pod","data") on the multi-pod
    mesh); "model" is the tensor axis.  ``mesh`` is a ``DeviceMesh``, or
    anything with its ``mesh_dim_names`` and ``shape``; None (one device)
    gives a mesh of one rank on each axis and no ``"mesh"``."""
    if mesh is None:
        return {"mesh": None, "data": "data", "model": "model",
                "model_size": 1, "data_size": 1}
    names = tuple(mesh.mesh_dim_names)
    sizes = dict(zip(names, tuple(mesh.shape)))
    data = tuple(n for n in names if n != "model")
    data_size = 1
    for n in data:
        data_size *= sizes[n]
    data = data[0] if len(data) == 1 else data
    return {"mesh": mesh, "data": data, "model": "model",
            "model_size": sizes["model"], "data_size": data_size}


def build_model(cfg, mesh=None, device="cuda"):
    axes = mesh_axes_of(mesh)
    if cfg.family == "encdec":
        return EncDecModel(cfg, axes, resolve_device(device))
    return Model(cfg, axes, resolve_device(device))


def batch_specs(batch: dict, mesh=None) -> dict:
    """Specs of a batch's tensors: rows over the data axes when the batch
    divides over them (else replicated), every other dim replicated."""
    axes = mesh_axes_of(mesh)
    out = {}
    for k, t in batch.items():
        da = axes["data"] if t.shape[0] % axes["data_size"] == 0 else None
        out[k] = (da,) + (None,) * (t.dim() - 1)
    return out


def input_specs(cfg, shape, mesh=None):
    """(meta tensors, specs) of every model input of a cell.

    train  -> {tokens, labels} (+frames/patches)
    prefill-> {tokens} (+frames/patches)
    decode -> {tokens (B,1), pos (B,), caches}
    """
    B, S = shape.global_batch, shape.seq_len

    def meta(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")

    if shape.kind in ("train", "prefill"):
        S_text, specs = S, {}
        if cfg.frontend == "vision_stub":
            S_text = S - cfg.n_patches
            specs["patches"] = meta((B, cfg.n_patches, cfg.d_model),
                                    torch.bfloat16)
        if cfg.frontend == "audio_stub":
            specs["frames"] = meta((B, cfg.encoder_frames, cfg.d_model),
                                   torch.bfloat16)
        specs["tokens"] = meta((B, S_text), torch.int32)
        if shape.kind == "train":
            specs["labels"] = meta((B, S_text), torch.int32)
        return specs, batch_specs(specs, mesh)
    caches, cache_specs = build_model(cfg, mesh, "meta").cache_spec(B, S)
    specs = {"tokens": meta((B, 1), torch.int32),
             "pos": meta((B,), torch.int32)}
    pspecs = batch_specs(specs, mesh)
    specs["caches"], pspecs["caches"] = caches, cache_specs
    return specs, pspecs
