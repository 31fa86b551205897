"""Facade: build a model and the abstract inputs of any (arch, shape).

Port of ``repro/models/model.py`` without the mesh: the model lives on
one device (the card unless the caller asks for the CPU), and input
specs are meta tensors (shapes and dtypes) with no PartitionSpecs.  The
device mesh comes with ``launch/mesh.py`` (ROADMAP queue 1, item 3.8).
"""
from __future__ import annotations

import torch

from repro_torch.core.decoder import resolve_device

from .encdec import EncDecModel
from .transformer import Model


def build_model(cfg, device="cuda"):
    if cfg.family == "encdec":
        return EncDecModel(cfg, resolve_device(device))
    return Model(cfg, resolve_device(device))


def input_specs(cfg, shape, device="cuda"):
    """Meta tensors of every model input of a cell.

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
        specs["tokens"] = meta((B, S_text), torch.int64)
        if shape.kind == "train":
            specs["labels"] = meta((B, S_text), torch.int64)
        return specs
    return {"tokens": meta((B, 1), torch.int64),
            "pos": meta((B,), torch.int64),
            "caches": build_model(cfg, device).cache_spec(B, S)}
